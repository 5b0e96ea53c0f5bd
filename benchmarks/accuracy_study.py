"""The 0.1 %-accuracy case: converged LSMC vs a fine-grid trinomial tree.

North star (BASELINE.md): NPV within 0.1 % of the reference.  The reference's
own cross-model consistency test accepts 0.5 % (
``/root/reference/src/Cmdty.Storage/../Lsmc/LsmcStorageValuationTest.cs:446``);
this study builds the tighter case explicitly (VERDICT r4 item 3):

* identical 1-factor OU dynamics fed to BOTH engines — the trinomial tree
  (quasi-exact dynamic program, float64, dense inventory grid) and the LSMC
  engine (converged path count, production float32 engine);
* multiple seeds, so Monte-Carlo error and policy-flip noise are visible
  rather than averaged away;
* an f32-vs-f64 drift check at the full path count on the SAME paths
  (precision error isolated from Monte-Carlo error).

LSMC is a lower-bound estimator, so the signed gap should sit slightly below
zero; the study asserts |gap| <= 0.1 % per seed and prints the distribution.

Run:  python benchmarks/accuracy_study.py [num_sims] [seeds...]
Prints one JSON line.  ``chip_smoke.py`` runs the same comparison on the card.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import pandas as pd


def build_case():
    """1-factor OU storage case both engines price identically.

    Mirrors ``tests/test_trinomial.py::TestTreeConsistency`` (the in-suite
    0.5 %/1 % version of this study) with a denser inventory grid and a
    quartic basis, which the convergence ladder showed are what close the
    last few bp of model gap.
    """
    from storage_tpu import CmdtyStorage

    storage = CmdtyStorage(
        "D", "2021-01-01", "2021-03-01",
        injection_cost=0.3, withdrawal_cost=0.4,
        min_inventory=0.0, max_inventory=2000.0,
        max_injection_rate=60.0, max_withdrawal_rate=80.0,
    )
    idx = pd.period_range("2021-01-01", "2021-03-01", freq="D")
    fwd = pd.Series(20.0 + 3.0 * np.sin(np.arange(len(idx)) / 8.0), index=idx)
    vols = pd.Series(0.7, index=idx)
    return storage, fwd, vols


MEAN_REVERSION = 5.0
GRID = 500  # dense inventory grid for both engines
BASIS = "1 + x0 + x0**2 + x0**3 + x0**4"


def tree_value(storage, fwd, vols) -> float:
    """Quasi-exact benchmark: float64 trinomial DP on the dense grid."""
    import jax

    from storage_tpu import trinomial_value

    with jax.enable_x64(True):
        import jax.numpy as jnp

        return float(trinomial_value(
            storage, "2021-01-01", 800.0, fwd, vols, MEAN_REVERSION,
            1 / 365.0, None, None,
            num_inventory_grid_points=GRID, dtype=jnp.float64,
        ))


def lsmc_value(storage, fwd, vols, num_sims, seed, dtype=None) -> float:
    from storage_tpu import multi_factor_value

    kwargs = {}
    if dtype is not None:
        kwargs["dtype"] = dtype
    res = multi_factor_value(
        storage, "2021-01-01", 800.0, fwd, None, None,
        factors=[(MEAN_REVERSION, vols)], factor_corrs=None,
        num_sims=num_sims, basis_funcs=BASIS,
        discount_deltas=False, seed=seed,
        num_inventory_grid_points=GRID, return_sim_panels=False,
        **kwargs,
    )
    return float(res.npv)


def main() -> None:
    num_sims = int(sys.argv[1]) if len(sys.argv) > 1 else 262_144
    seeds = [int(s) for s in sys.argv[2:]] or [11, 23, 47]

    import jax

    backend = jax.default_backend()
    storage, fwd, vols = build_case()

    t0 = time.perf_counter()
    tree = tree_value(storage, fwd, vols)
    print(f"# tree (f64, G={GRID}): {tree:,.2f}  [{time.perf_counter()-t0:.1f}s]",
          file=sys.stderr, flush=True)

    gaps = {}
    for seed in seeds:
        t0 = time.perf_counter()
        npv = lsmc_value(storage, fwd, vols, num_sims, seed)
        rel = (npv - tree) / tree
        gaps[seed] = {"npv": npv, "rel_gap": rel,
                      "wall_s": round(time.perf_counter() - t0, 2)}
        print(f"# lsmc f32 sims={num_sims:,} seed={seed}: {npv:,.2f} "
              f"rel={rel:+.3e} [{gaps[seed]['wall_s']}s]",
              file=sys.stderr, flush=True)

    # f32-vs-f64 drift on the same seed and the SAME paths isolates
    # precision from Monte-Carlo error, so it needs no converged count.
    import jax.numpy as jnp

    seed0 = seeds[0]
    drift_sims = min(num_sims, 65_536)
    npv32 = lsmc_value(storage, fwd, vols, drift_sims, seed0)
    with jax.enable_x64(True):
        npv64 = lsmc_value(storage, fwd, vols, drift_sims, seed0,
                           dtype=jnp.float64)
    drift = (npv32 - npv64) / npv64
    print(f"# drift sims={drift_sims:,}: f64 {npv64:,.2f} vs f32 "
          f"{npv32:,.2f} rel={drift:+.3e}", file=sys.stderr, flush=True)

    worst = max(abs(g["rel_gap"]) for g in gaps.values())
    line = {
        "metric": (
            f"LSMC({num_sims:,} paths, f32) vs trinomial "
            f"(f64, G={GRID}) on identical 1-factor OU dynamics, "
            f"{len(seeds)} seeds, backend={backend}"
        ),
        "tree_npv": tree,
        "per_seed": {str(k): v for k, v in gaps.items()},
        "worst_abs_rel_gap": worst,
        "f32_vs_f64_rel_drift": drift,
        "drift_leg_sims": drift_sims,
        "passes_0p1pct": bool(worst <= 1e-3),
        "reference_tolerance": 0.005,
        "backend": backend,
    }
    print(json.dumps(line))


if __name__ == "__main__":
    main()
