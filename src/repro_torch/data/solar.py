"""Synthetic PV fleet generator — stands in for the proprietary neoom AG

dataset (repro gate, see DESIGN.md §1).  Physics-grounded so the paper's
*structure* is reproduced:

  * solar geometry: declination + hour angle -> sun elevation/azimuth per
    site latitude; clear-sky irradiance via a simple air-mass model;
  * panel orientation: incidence-angle factor from panel azimuth/tilt —
    sites with different orientations have genuinely different daily shapes
    (the basis of orientation clustering);
  * regional weather: cloud/snow/precip fields shared within a region with
    site-level noise — sites in the same region correlate (the basis of
    location clustering);
  * 15-minute production resolution + hourly forecasts duplicated across
    quarter-hours, exactly as in §III.A;
  * features and ranges follow Table I; production normalized by kWp.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.solar_lstm import FEATURES, STEPS_PER_DAY

# Table I normalization ranges (regional maxima, central Europe)
RANGES = {
    "solar_rad": 956.2,
    "ghi": 956.21,
    "snow_depth": 1178.6,
    "precip": 14.78,
    "clouds": 100.0,
}


@dataclass(frozen=True)
class SiteSpec:
    site_id: str
    lat: float
    lon: float
    azimuth: float          # panel azimuth, deg (180 = due south)
    tilt: float             # deg from horizontal
    kwp: float              # rated capacity
    region: int             # weather-region index (drives correlated clouds)
    noise: float = 0.02

    @property
    def static_features(self) -> dict:
        return {"loc": np.array([self.lat, self.lon]),
                "ori": np.array([self.azimuth])}


def _solar_geometry(day_of_year, minute_of_day, lat_deg):
    """Sun elevation (rad) and azimuth (rad from north) — NOAA approx."""
    decl = np.radians(23.45) * np.sin(2 * np.pi * (284 + day_of_year) / 365.0)
    hour_angle = np.radians((minute_of_day / 4.0) - 180.0)  # deg->rad, solar noon=0
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
    """W/m^2 at ground under clear sky (simple air-mass attenuation)."""
    sin_el = np.maximum(np.sin(elevation), 0.0)
    am = 1.0 / np.maximum(sin_el, 0.05)
    return 1100.0 * sin_el * (0.7 ** (am ** 0.678))


def _panel_factor(elevation, sun_az, panel_az_deg, tilt_deg):
    """Cosine of incidence angle onto the tilted panel, clipped at 0."""
    tilt = np.radians(tilt_deg)
    paz = np.radians(panel_az_deg)
    cos_inc = (np.sin(elevation) * np.cos(tilt)
               + np.cos(elevation) * np.sin(tilt) * np.cos(sun_az - paz))
    return np.maximum(cos_inc, 0.0)


class SolarDataGenerator:
    """Generates (features, production) for a fleet of sites over N days."""

    def __init__(self, n_days: int = 450, seed: int = 0, start_day: int = 0):
        self.n_days = n_days
        self.seed = seed
        self.start_day = start_day
        self._region_weather: dict[int, dict] = {}

    # --------------------------------------------------------- weather field
    def _weather(self, region: int) -> dict:
        """Regional weather time series at 15-min resolution, cached."""
        if region in self._region_weather:
            return self._region_weather[region]
        rng = np.random.default_rng(self.seed * 7919 + region)
        T = self.n_days * STEPS_PER_DAY
        day = (self.start_day + np.arange(T) / STEPS_PER_DAY) % 365.0

        # cloud cover: seasonal base + AR(1) daily states + intra-day noise
        seasonal = 0.55 - 0.25 * np.cos(2 * np.pi * (day - 15) / 365.0)
        daily = np.zeros(self.n_days)
        daily[0] = rng.uniform(0, 1)
        for i in range(1, self.n_days):
            daily[i] = np.clip(0.7 * daily[i - 1] + 0.3 * rng.uniform(0, 1)
                               + rng.normal(0, 0.1), 0, 1)
        clouds = np.clip(
            seasonal * np.repeat(daily, STEPS_PER_DAY)
            + 0.15 * rng.normal(0, 1, T).cumsum() / np.sqrt(np.arange(1, T + 1)),
            0, 1) * 100.0

        # precipitation: active when cloudy
        precip = np.where(
            (clouds > 70) & (rng.random(T) < 0.3),
            rng.gamma(1.5, 1.2, T), 0.0)
        precip = np.clip(precip, 0, RANGES["precip"])

        # snow depth: winter accumulation/melt (mm)
        winter = np.maximum(np.cos(2 * np.pi * day / 365.0), 0.0)
        snow = np.zeros(T)
        s = 0.0
        for i in range(T):
            s += 4.0 * precip[i] * winter[i]          # accumulate
            s *= (1.0 - 0.002 * (1.05 - winter[i]))   # melt
            snow[i] = s
        snow = np.clip(snow, 0, RANGES["snow_depth"])

        w = {"clouds": clouds, "precip": precip, "snow": snow, "day": day}
        self._region_weather[region] = w
        return w

    # ---------------------------------------------------------------- a site
    def generate_site(self, site: SiteSpec) -> dict:
        """Returns raw (un-normalized) series dict + normalized feature matrix."""
        rng = np.random.default_rng(self.seed * 104729 + hash(site.site_id) % 2**31)
        T = self.n_days * STEPS_PER_DAY
        w = self._weather(site.region)
        day = w["day"]
        minute = (np.arange(T) % STEPS_PER_DAY) * (1440 // STEPS_PER_DAY)

        el, az = _solar_geometry(day, minute, site.lat)
        ghi_clear = _clear_sky_ghi(el)
        cloud_att = 1.0 - 0.75 * (w["clouds"] / 100.0) ** 2
        solar_rad = ghi_clear * cloud_att
        ghi = ghi_clear  # extra-atmospheric-ish reference (Table I)

        panel = _panel_factor(el, az, site.azimuth, site.tilt)
        snow_block = np.exp(-w["snow"] / 80.0)        # deep snow kills output
        rain_loss = 1.0 - 0.05 * (w["precip"] > 0.5)
        prod_norm = (panel * cloud_att * snow_block * rain_loss
                     * (ghi_clear / 1000.0))
        prod_norm = np.clip(prod_norm * (1 + rng.normal(0, site.noise, T)), 0, 1.2)
        production_kw = prod_norm * site.kwp

        # hourly forecasts duplicated across 15-min intervals (§III.A), with
        # forecast error
        def hourly_forecast(x, err):
            xh = x.reshape(-1, 4).mean(1)
            xh = xh * (1 + rng.normal(0, err, len(xh)))
            return np.repeat(xh, 4)

        feats = {
            "solar_rad": np.clip(hourly_forecast(solar_rad, 0.08), 0, RANGES["solar_rad"]),
            "ghi": np.clip(hourly_forecast(ghi, 0.02), 0, RANGES["ghi"]),
            "snow_depth": np.clip(hourly_forecast(w["snow"], 0.05), 0, RANGES["snow_depth"]),
            "precip": np.clip(hourly_forecast(w["precip"], 0.2), 0, RANGES["precip"]),
            "clouds": np.clip(hourly_forecast(w["clouds"], 0.12), 0, RANGES["clouds"]),
        }

        # normalized feature matrix in FEATURES order (cyclic time encoding)
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
        X = np.stack(cols, axis=1).astype(np.float32)          # (T, F)
        y = (production_kw / site.kwp).astype(np.float32)      # (T,) in [0, 1.2]

        return {"features": X, "production_norm": y,
                "production_kw": production_kw.astype(np.float32),
                "kwp": site.kwp, "minute": minute, "day": day}


def generate_fleet(n_sites: int = 12, n_days: int = 120, seed: int = 0,
                   n_regions: int = 3, start_day: int = 90
                   ) -> list[tuple[SiteSpec, dict]]:
    """A central-European fleet: sites cluster geographically into regions
    (Vienna / Munich / Zurich-ish) and by panel azimuth (S / E / W).
    start_day=90: spring onward, when production signal is strongest."""
    rng = np.random.default_rng(seed)
    centers = [(48.21, 16.37), (48.14, 11.58), (47.38, 8.54),
               (50.08, 14.44), (47.07, 15.44)][:n_regions]
    azimuths = [180.0, 110.0, 250.0]
    gen = SolarDataGenerator(n_days=n_days, seed=seed, start_day=start_day)
    fleet = []
    for i in range(n_sites):
        region = i % n_regions
        lat0, lon0 = centers[region]
        site = SiteSpec(
            site_id=f"site{i:03d}",
            lat=lat0 + rng.normal(0, 0.25),
            lon=lon0 + rng.normal(0, 0.35),
            azimuth=(azimuths[(i // n_regions) % 3] + rng.normal(0, 8.0)) % 360,
            tilt=rng.uniform(20, 40),
            kwp=float(rng.choice([5.0, 8.0, 10.0, 15.0, 30.0, 100.0])),
            region=region,
            noise=rng.uniform(0.01, 0.04))
        fleet.append((site, gen.generate_site(site)))
    return fleet
