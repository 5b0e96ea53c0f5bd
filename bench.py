"""Headline benchmark: 3-factor seasonal LSMC on the README's 1-year daily
ratcheted facility, 1,000,000 paths x 341 daily decision steps, 100 inventory
grid points, full deltas and trigger prices, through the public
``three_factor_seasonal_value``.

One in-process run on one GPU: the first call (compilation included) is
reported as set-up, then one warm valuation is timed.  It fails when JAX finds
no GPU.  Prints one JSON line that names the device and the card.

Run:  python bench.py
"""
from __future__ import annotations

import json
import os
import subprocess
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HEADLINE_SIMS = 1_000_000
SEED = 12
VAL_DATE = "2021-04-25"
INVENTORY = 1500.0
BASIS = "1 + x_st + x_sw + x_lt + s + x_st**2 + x_sw**2 + x_lt**2 + s**2 + s * x_st"
RATCHETS = [
    (
        "2021-04-01",
        [
            (0.0, -150.0, 250.0),
            (2000.0, -200.0, 175.0),
            (5000.0, -260.0, 155.0),
            (7000.0, -275.0, 132.0),
        ],
    ),
    (
        "2022-10-01",
        [
            (0.0, -130.0, 260.0),
            (2000.0, -190.0, 190.0),
            (5000.0, -230.0, 165.0),
            (7000.0, -245.0, 148.0),
        ],
    ),
]
#: Largest injection or withdrawal rate of the facility (volume per day).
MAX_RATE = max(abs(r) for _, table in RATCHETS for _, lo, hi in table for r in (lo, hi))


def build_case():
    import pandas as pd

    from storage_tpu import CmdtyStorage, RatchetInterp

    storage = CmdtyStorage(
        freq="D",
        storage_start="2021-04-01",
        storage_end="2022-04-01",
        injection_cost=0.01,
        withdrawal_cost=0.025,
        ratchets=RATCHETS,
        ratchet_interp=RatchetInterp.LINEAR,
    )
    monthly_index = pd.period_range(start="2021-04-25", periods=25, freq="M")
    monthly_fwd = [
        16.61, 15.68, 15.42, 15.31, 15.27, 15.13, 15.96, 17.22, 17.32, 17.66,
        17.59, 16.81, 15.36, 14.49, 14.28, 14.25, 14.32, 14.33, 15.30, 16.58,
        16.64, 16.79, 16.64, 15.90, 14.63,
    ]
    fwd_curve = pd.Series(monthly_fwd, index=monthly_index).resample("D").ffill()
    rates = pd.Series(
        [0.005, 0.006, 0.0072, 0.0087, 0.0101, 0.0115, 0.0126],
        index=pd.PeriodIndex(
            freq="D",
            data=[
                "2021-04-25", "2021-06-01", "2021-08-01", "2021-12-01",
                "2022-04-01", "2022-12-01", "2023-12-01",
            ],
        ),
    )
    ir_curve = rates.resample("D").asfreq().interpolate(method="linear")

    def settlement_rule(d):
        return d.asfreq("M").asfreq("D", "end") + 20

    return storage, fwd_curve, ir_curve, settlement_rule


def value(num_sims: int, seed: int = SEED, mesh=None, profile_sink=None):
    """The headline valuation (per-sim panels stay on the device)."""
    from storage_tpu import three_factor_seasonal_value

    storage, fwd_curve, ir_curve, settlement_rule = build_case()
    return three_factor_seasonal_value(
        cmdty_storage=storage,
        val_date=VAL_DATE,
        inventory=INVENTORY,
        fwd_curve=fwd_curve,
        interest_rates=ir_curve,
        settlement_rule=settlement_rule,
        num_sims=num_sims,
        seed=seed,
        spot_mean_reversion=91.0,
        spot_vol=0.85,
        long_term_vol=0.30,
        seasonal_vol=0.19,
        basis_funcs=BASIS,
        discount_deltas=True,
        return_sim_panels=False,
        mesh=mesh,
        profile_sink=profile_sink,
    )


def require_gpu():
    """The first JAX device, or SystemExit when it is not a GPU."""
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {device.platform} "
            f"({device.device_kind}); refusing to measure on it"
        )
    return device


def card_lines() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def device_record(devices) -> dict:
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def main() -> None:
    from storage_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache(os.path.join(ROOT, ".jax_cache"))
    import jax

    require_gpu()
    card = card_lines()
    t0 = time.perf_counter()
    value(HEADLINE_SIMS)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = value(HEADLINE_SIMS, seed=SEED + 1)
    wall = time.perf_counter() - t0
    print(json.dumps({
        "metric": (
            f"3-factor seasonal LSMC, {HEADLINE_SIMS:,} paths x 341 daily steps, "
            "G=100, full deltas+triggers, one warm valuation"
        ),
        "value": wall,
        "unit": "s",
        "setup_s": setup,
        "npv": res.npv,
        "device": device_record(jax.devices()[:1]),
        "card": card,
    }))


if __name__ == "__main__":
    main()
