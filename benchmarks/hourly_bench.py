"""Hourly benchmark (BASELINE.json configs[4]).

Multi-year HOURLY storage (17,520 decision steps at 2 years) x 250k
ANTITHETIC paths, 3-factor seasonal, ratchets, full deltas + triggers.  The
full [n, F, S] factor array would be ~52 GB, past the device's path budget,
so the engine streams factor paths from checkpointed OU states.  Fails when
JAX finds no GPU.

Prints one JSON line naming the device.

Run:  python benchmarks/hourly_bench.py [num_sims] [years]
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import pandas as pd


def build_case(years: int):
    from storage_tpu import CmdtyStorage, RatchetInterp

    end = f"{2021 + years}-01-01"
    storage = CmdtyStorage(
        freq="h",
        storage_start="2021-01-01",
        storage_end=end,
        injection_cost=0.01,
        withdrawal_cost=0.025,
        ratchets=[
            (
                "2021-01-01",
                [
                    (0.0, -150.0 / 24, 250.0 / 24),
                    (2000.0, -200.0 / 24, 175.0 / 24),
                    (5000.0, -260.0 / 24, 155.0 / 24),
                    (7000.0, -275.0 / 24, 132.0 / 24),
                ],
            ),
        ],
        ratchet_interp=RatchetInterp.LINEAR,
    )
    idx = pd.period_range("2021-01-01", end, freq="h")
    i = np.arange(len(idx))
    fwd = pd.Series(
        16.0
        + 2.0 * np.sin(2 * np.pi * i / 8760.0)  # seasonal shape
        + 0.8 * np.sin(2 * np.pi * i / 24.0),  # intraday shape
        index=idx,
    )
    return storage, fwd, idx


def main() -> None:
    num_sims = int(sys.argv[1]) if len(sys.argv) > 1 else 250_000
    years = int(sys.argv[2]) if len(sys.argv) > 2 else 2

    from bench import device_record, require_gpu

    from storage_tpu import three_factor_seasonal_value
    from storage_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache(os.path.join(os.path.dirname(__file__), "..", ".jax_cache"))
    import jax

    require_gpu()
    storage, fwd, idx = build_case(years)
    n_steps = len(idx) - 1

    def once(seed):
        return three_factor_seasonal_value(
            cmdty_storage=storage,
            val_date="2021-01-01",
            inventory=1500.0,
            fwd_curve=fwd,
            interest_rates=0.01,
            settlement_rule=None,
            num_sims=num_sims,
            seed=seed,
            antithetic=True,
            spot_mean_reversion=91.0,
            spot_vol=0.85,
            long_term_vol=0.30,
            seasonal_vol=0.19,
            basis_funcs="1 + x_st + x_sw + x_lt + s + x_st**2 + s**2",
            discount_deltas=True,
            return_sim_panels=False,
        )

    t0 = time.perf_counter()
    once(seed=12)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = once(seed=13)
    wall = time.perf_counter() - t0
    assert np.isfinite(res.npv) and np.isfinite(res.deltas).all()
    print(json.dumps({
        "metric": (
            f"hourly LSMC (BASELINE configs[4]): {years}-yr hourly "
            f"({n_steps:,} steps) x {num_sims:,} antithetic paths, full "
            "deltas+triggers, one warm valuation"
        ),
        "value": wall,
        "unit": "s",
        "setup_s": setup,
        "npv": float(res.npv),
        "device": device_record(jax.devices()[:1]),
    }))


if __name__ == "__main__":
    main()
