"""Run the solar experiment in the JAX package and in the PyTorch port on
the CPU, from the same seed and the same JAX-initialised parameters, and
print how far the two reports are apart.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_parity.py

The port runs its kernels' plain PyTorch versions on the CPU; the JAX
package runs its default (jnp) route.  Clusters and the asynchronous
schedule's stats depend only on numpy draws and should be equal; the
printed ``max_gap_pp`` is the largest difference over every Table II and
§IV.E entry, in percentage points.
"""

from __future__ import annotations

import json

import jax
import numpy as np

from repro.configs.solar_lstm import SolarLSTMConfig
from repro.models.lstm import SolarForecaster
from repro.training.fed_solar import run_fedccl_solar as jax_run
from repro_torch.training.fed_solar import run_fedccl_solar as torch_run

SMALL = dict(n_sites=4, n_days=20, rounds=1, hidden=16, epochs=2,
             n_independent=1, seed=0)


def solar_parity(**cfg):
    """(reference report, port report, max Table II / §IV.E gap in pp)."""
    ref = jax_run(**cfg)
    # the JAX run initialises with jax.random.key(seed); hand the port the
    # same parameters through the weights bridge
    init = jax.tree.map(np.asarray, SolarForecaster(SolarLSTMConfig(
        hidden_size=cfg["hidden"])).init(jax.random.key(cfg["seed"])))
    got = torch_run(**cfg, device="cpu", init_params=init)
    gap = max(abs(got[tab][col][k] - v)
              for tab in ("table2", "independent")
              for col in ref[tab] for k, v in ref[tab][col].items())
    return ref, got, gap


def main():
    ref, got, gap = solar_parity(**SMALL)
    print(json.dumps({
        "config": SMALL,
        "clusters_equal": got["clusters"] == ref["clusters"],
        "async_stats_equal": got["async_stats"] == ref["async_stats"],
        "max_gap_pp": gap,
    }))


if __name__ == "__main__":
    main()
