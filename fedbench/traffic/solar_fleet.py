"""The solar traffic: a synthetic central-European PV fleet and its windows.

A frozen copy of the port's generator (``repro_torch.data.solar``,
``repro_torch.data.windows``), kept beside the benchmark so that a change
to the program cannot change what the benchmark feeds it.  One departure:
a site's noise stream is seeded by ``zlib.crc32`` of its id where the
original uses Python's ``hash``, which moves with ``PYTHONHASHSEED``; so
the fleet here depends on the seed alone.

Every seed gives the same layout: ``n_regions`` weather regions, three
panel azimuths, the same number of days a site.  The seed moves the sites
within their region and azimuth, the weather and the noise.
"""

from __future__ import annotations

import zlib

import numpy as np

FEATURES = ("solar_rad", "ghi", "snow_depth", "precip", "clouds",
            "minute_of_day_sin", "minute_of_day_cos", "day_of_year_sin",
            "day_of_year_cos")
STEPS_PER_DAY = 96
HISTORY_STEPS = 7 * STEPS_PER_DAY
HORIZON_STEPS = STEPS_PER_DAY

RANGES = {"solar_rad": 956.2, "ghi": 956.21, "snow_depth": 1178.6,
          "precip": 14.78, "clouds": 100.0}
CENTERS = [(48.21, 16.37), (48.14, 11.58), (47.38, 8.54), (50.08, 14.44),
           (47.07, 15.44)]
AZIMUTHS = [180.0, 110.0, 250.0]


def _solar_geometry(day_of_year, minute_of_day, lat_deg):
    decl = np.radians(23.45) * np.sin(2 * np.pi * (284 + day_of_year) / 365.0)
    hour_angle = np.radians((minute_of_day / 4.0) - 180.0)
    lat = np.radians(lat_deg)
    sin_el = (np.sin(lat) * np.sin(decl)
              + np.cos(lat) * np.cos(decl) * np.cos(hour_angle))
    el = np.arcsin(np.clip(sin_el, -1, 1))
    cos_az = ((np.sin(decl) - np.sin(el) * np.sin(lat))
              / np.maximum(np.cos(el) * np.cos(lat), 1e-6))
    az = np.arccos(np.clip(cos_az, -1, 1))
    az = np.where(hour_angle > 0, 2 * np.pi - az, az)
    return el, az


def _clear_sky_ghi(elevation):
    sin_el = np.maximum(np.sin(elevation), 0.0)
    am = 1.0 / np.maximum(sin_el, 0.05)
    return 1100.0 * sin_el * (0.7 ** (am ** 0.678))


def _panel_factor(elevation, sun_az, panel_az_deg, tilt_deg):
    tilt = np.radians(tilt_deg)
    paz = np.radians(panel_az_deg)
    cos_inc = (np.sin(elevation) * np.cos(tilt)
               + np.cos(elevation) * np.sin(tilt) * np.cos(sun_az - paz))
    return np.maximum(cos_inc, 0.0)


def _weather(seed: int, region: int, n_days: int, start_day: int) -> dict:
    rng = np.random.default_rng(seed * 7919 + region)
    T = n_days * STEPS_PER_DAY
    day = (start_day + np.arange(T) / STEPS_PER_DAY) % 365.0
    seasonal = 0.55 - 0.25 * np.cos(2 * np.pi * (day - 15) / 365.0)
    daily = np.zeros(n_days)
    daily[0] = rng.uniform(0, 1)
    for i in range(1, n_days):
        daily[i] = np.clip(0.7 * daily[i - 1] + 0.3 * rng.uniform(0, 1)
                           + rng.normal(0, 0.1), 0, 1)
    clouds = np.clip(
        seasonal * np.repeat(daily, STEPS_PER_DAY)
        + 0.15 * rng.normal(0, 1, T).cumsum() / np.sqrt(np.arange(1, T + 1)),
        0, 1) * 100.0
    precip = np.where((clouds > 70) & (rng.random(T) < 0.3),
                      rng.gamma(1.5, 1.2, T), 0.0)
    precip = np.clip(precip, 0, RANGES["precip"])
    winter = np.maximum(np.cos(2 * np.pi * day / 365.0), 0.0)
    snow = np.zeros(T)
    s = 0.0
    for i in range(T):
        s += 4.0 * precip[i] * winter[i]
        s *= (1.0 - 0.002 * (1.05 - winter[i]))
        snow[i] = s
    snow = np.clip(snow, 0, RANGES["snow_depth"])
    return {"clouds": clouds, "precip": precip, "snow": snow, "day": day}


def _site_series(seed: int, site: dict, w: dict, n_days: int) -> dict:
    rng = np.random.default_rng(seed * 104729
                                + zlib.crc32(site["id"].encode()) % 2**31)
    T = n_days * STEPS_PER_DAY
    day = w["day"]
    minute = (np.arange(T) % STEPS_PER_DAY) * (1440 // STEPS_PER_DAY)
    el, az = _solar_geometry(day, minute, site["lat"])
    ghi_clear = _clear_sky_ghi(el)
    cloud_att = 1.0 - 0.75 * (w["clouds"] / 100.0) ** 2
    solar_rad = ghi_clear * cloud_att
    panel = _panel_factor(el, az, site["azimuth"], site["tilt"])
    snow_block = np.exp(-w["snow"] / 80.0)
    rain_loss = 1.0 - 0.05 * (w["precip"] > 0.5)
    prod = panel * cloud_att * snow_block * rain_loss * (ghi_clear / 1000.0)
    prod = np.clip(prod * (1 + rng.normal(0, site["noise"], T)), 0, 1.2)

    def hourly(x, err):
        xh = x.reshape(-1, 4).mean(1)
        xh = xh * (1 + rng.normal(0, err, len(xh)))
        return np.repeat(xh, 4)

    feats = {
        "solar_rad": np.clip(hourly(solar_rad, 0.08), 0, RANGES["solar_rad"]),
        "ghi": np.clip(hourly(ghi_clear, 0.02), 0, RANGES["ghi"]),
        "snow_depth": np.clip(hourly(w["snow"], 0.05), 0,
                              RANGES["snow_depth"]),
        "precip": np.clip(hourly(w["precip"], 0.2), 0, RANGES["precip"]),
        "clouds": np.clip(hourly(w["clouds"], 0.12), 0, RANGES["clouds"]),
    }
    cols = []
    for name in FEATURES:
        if name == "minute_of_day_sin":
            cols.append(np.sin(2 * np.pi * minute / 1440.0))
        elif name == "minute_of_day_cos":
            cols.append(np.cos(2 * np.pi * minute / 1440.0))
        elif name == "day_of_year_sin":
            cols.append(np.sin(2 * np.pi * day / 365.0))
        elif name == "day_of_year_cos":
            cols.append(np.cos(2 * np.pi * day / 365.0))
        else:
            cols.append(feats[name] / RANGES[name])
    return {"features": np.stack(cols, axis=1).astype(np.float32),
            "production": prod.astype(np.float32), "minute": minute}


def make_windows(series: dict, history_steps: int = HISTORY_STEPS) -> dict:
    """7-day history (features + past production) and next-day forecast ->
    the 96 quarter-hour targets, one window a day."""
    X, y, minute = series["features"], series["production"], series["minute"]
    starts = np.arange(0, len(y) - history_steps - HORIZON_STEPS + 1,
                       STEPS_PER_DAY)
    hist, fore, targ, mins = [], [], [], []
    for s in starts:
        h_end = s + history_steps
        f_end = h_end + HORIZON_STEPS
        hist.append(np.concatenate([X[s:h_end], y[s:h_end, None]], axis=1))
        fore.append(X[h_end:f_end])
        targ.append(y[h_end:f_end])
        mins.append(minute[h_end:f_end])
    return {"history": np.stack(hist).astype(np.float32),
            "forecast": np.stack(fore).astype(np.float32),
            "target": np.stack(targ).astype(np.float32),
            "minute": np.stack(mins).astype(np.int32)}


def generate_fleet(seed: int, n_sites: int, n_days: int, n_regions: int = 3,
                   start_day: int = 90, train_frac: float = 0.8,
                   history_days: int = 7) -> list:
    """``n_sites`` sites, site ``i`` in region ``i % n_regions`` with
    azimuth ``AZIMUTHS[(i // n_regions) % 3]`` (plus jitter).  Returns
    ``[{"id", "lat", "lon", "azimuth", ..., "train": windows}]``, the
    first ``train_frac`` of each site's windows (chronological), each with
    ``history_days`` days of history (7 in every cell; tests shorten it)."""
    rng = np.random.default_rng(seed)
    weather = {}
    fleet = []
    for i in range(n_sites):
        region = i % n_regions
        lat0, lon0 = CENTERS[region]
        site = {"id": f"site{i:03d}",
                "lat": lat0 + rng.normal(0, 0.25),
                "lon": lon0 + rng.normal(0, 0.35),
                "azimuth": (AZIMUTHS[(i // n_regions) % 3]
                            + rng.normal(0, 8.0)) % 360,
                "tilt": rng.uniform(20, 40),
                "kwp": float(rng.choice([5.0, 8.0, 10.0, 15.0, 30.0, 100.0])),
                "region": region,
                "noise": rng.uniform(0.01, 0.04)}
        if region not in weather:
            weather[region] = _weather(seed, region, n_days, start_day)
        windows = make_windows(_site_series(seed, site, weather[region],
                                            n_days),
                               history_days * STEPS_PER_DAY)
        cut = int(len(windows["target"]) * train_frac)
        site["train"] = {k: v[:cut] for k, v in windows.items()}
        fleet.append(site)
    return fleet
