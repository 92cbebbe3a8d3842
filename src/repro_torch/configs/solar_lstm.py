"""Case-study forecaster config (paper §III): LSTM over 7 days of 15-min

history + 24 h weather forecast -> 96 quarter-hour power predictions.
"""

from dataclasses import dataclass
from collections.abc import Sequence

FEATURES: Sequence[str] = (
    "solar_rad", "ghi", "snow_depth", "precip", "clouds",
    "minute_of_day_sin", "minute_of_day_cos", "day_of_year_sin", "day_of_year_cos",
)
# production (normalized to kWp) is appended to the history channel only.
HISTORY_CHANNELS = len(FEATURES) + 1
FORECAST_CHANNELS = len(FEATURES)

STEPS_PER_DAY = 96                    # 15-minute intervals
HISTORY_DAYS = 7
HISTORY_STEPS = STEPS_PER_DAY * HISTORY_DAYS   # 672
HORIZON_STEPS = STEPS_PER_DAY                  # 96 predictions (24 h)


@dataclass(frozen=True)
class SolarLSTMConfig:
    name: str = "solar-lstm"
    hidden_size: int = 128
    n_layers: int = 1
    history_steps: int = HISTORY_STEPS
    horizon_steps: int = HORIZON_STEPS
    history_channels: int = HISTORY_CHANNELS
    forecast_channels: int = FORECAST_CHANNELS
    dropout: float = 0.0
    dtype: str = "float32"


CONFIG = SolarLSTMConfig()
