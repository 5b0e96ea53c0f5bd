"""Chip smoke test: the LSMC valuation on a GPU through the public API.

Drives the system's main path once at the size users run: the README's
1-year daily ratcheted facility valued by ``three_factor_seasonal_value`` at
1,000,000 paths x 341 daily decision steps, G=100, full deltas and trigger
prices (``bench.py``).  Every phase compares its result, on the card, with a
plain reference:

- headline: finite outputs, NPV >= intrinsic NPV, and the same engine on the
  process's CPU device at 16,384 paths (same seed, full horizon) within 5e-5
  relative NPV;
- cross-model: LSMC f32 at 262,144 paths, G=500, within 1e-3 of the float64
  trinomial tree at G=500 for each seed (``benchmarks/accuracy_study.py``),
  plus the f32-vs-f64 drift on the same 65,536 paths;
- intrinsic: ``intrinsic_value`` within 1e-3 of, and at most 1e-4 above, the
  float64 brute-force DP (``benchmarks/brute_force_intrinsic.py``).

``--four-cards`` runs only the headline at 1,000,000 paths on a 4-card paths
mesh against the same seed on one card of the same process: NPV within 5e-5
relative, each period's delta within 5% of the largest ratchet rate.

One process drives the card(s).  It exits non-zero, without the ok line, when
JAX finds no GPU or any check fails.  The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Run:  python chip_smoke.py [--four-cards]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "benchmarks")]

import bench  # noqa: E402

REF_SIMS = 16_384
CPU_REL_BOUND = 5e-5  # changed f32 reduction order (tests/test_parallel.py)
CROSS_SIMS = 262_144
DRIFT_SIMS = 65_536
CROSS_SEEDS = (11, 23, 47)
CROSS_REL_BOUND = 1e-3  # the accuracy study's own gate
INTRINSIC_ABOVE_BOUND = 1e-4  # tests/test_brute_force.py
INTRINSIC_REL_BOUND = 1e-3
MESH_REL_BOUND = 5e-5  # tests/test_parallel.py, 4,096-path convergence
MESH_DELTA_SHARE = 0.05  # of the largest ratchet rate, tests/test_parallel.py


class Checks:
    """Named pass/fail comparisons of one run, printed as they are made."""

    def __init__(self, out=print):
        self.out = out
        self.results = {}  # name -> (value, bound, ok)

    def __call__(self, name: str, value: float, bound: float, ok: bool) -> None:
        self.out(f"check {name}: {value!r} (bound {bound!r}) "
                 f"{'PASS' if ok else 'FAIL'}")
        self.results[name] = (value, bound, bool(ok))

    @property
    def failed(self):
        return [name for name, (_, _, ok) in self.results.items() if not ok]


def _timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def headline_phase(check, out, num_sims=bench.HEADLINE_SIMS, ref_sims=REF_SIMS):
    """The headline valuation: set-up, two warm runs, phase split, peak
    memory, and the CPU-device reference."""
    import jax
    import numpy as np

    from storage_tpu.native import native_available

    device = jax.devices()[0]
    res, setup = _timed(bench.value, num_sims)
    out(f"headline {num_sims:,} paths: first call (compile + run, set-up) {setup!r} s")
    for i in range(2):
        res, wall = _timed(bench.value, num_sims)
        out(f"headline {num_sims:,} paths: warm run {i + 1} {wall!r} s")
    phases = {}

    def sink(sw):
        phases.update({p: sw.elapsed(p) for p in sw.PHASES + ("All",)})
        phases["Other"] = phases["All"] - sum(phases[p] for p in sw.PHASES)

    bench.value(num_sims, profile_sink=sink)
    out(f"headline phase split (s): {json.dumps(phases)}")
    stats = device.memory_stats() or {}
    out(f"headline peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'not reported')}")
    out(f"inventory space: {'C++' if native_available() else 'NumPy'}")
    out(f"headline npv {res.npv!r} intrinsic {res.intrinsic_npv!r}")

    finite = bool(np.isfinite(res.npv) and np.isfinite(res.deltas.to_numpy()).all())
    check("headline finite", float(finite), 1.0, finite)
    check("headline npv >= intrinsic", res.npv - res.intrinsic_npv, 0.0,
          res.npv >= res.intrinsic_npv)

    acc = bench.value(ref_sims).npv
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = bench.value(ref_sims).npv
    rel = abs(acc - cpu) / abs(cpu)
    out(f"reference {ref_sims:,} paths: {device.platform} {acc!r} cpu {cpu!r}")
    check(f"{device.platform} vs cpu npv rel", rel, CPU_REL_BOUND, rel <= CPU_REL_BOUND)


def cross_model_phase(check, out, num_sims=CROSS_SIMS, drift_sims=DRIFT_SIMS,
                      seeds=CROSS_SEEDS):
    """LSMC f32 vs the float64 trinomial tree on identical 1-factor dynamics."""
    import jax
    import jax.numpy as jnp

    import accuracy_study as study

    storage, fwd, vols = study.build_case()
    tree, secs = _timed(study.tree_value, storage, fwd, vols)
    out(f"tree f64 G={study.GRID}: {tree!r} ({secs!r} s)")
    for seed in seeds:
        npv, secs = _timed(study.lsmc_value, storage, fwd, vols, num_sims, seed)
        gap = (npv - tree) / tree
        out(f"lsmc f32 {num_sims:,} paths seed {seed}: {npv!r} ({secs!r} s)")
        check(f"lsmc vs tree gap seed {seed}", gap, CROSS_REL_BOUND,
              abs(gap) <= CROSS_REL_BOUND)
    npv32 = study.lsmc_value(storage, fwd, vols, drift_sims, seeds[0])
    with jax.enable_x64(True):
        npv64 = study.lsmc_value(storage, fwd, vols, drift_sims, seeds[0],
                                 dtype=jnp.float64)
    out(f"f32 vs f64 drift {drift_sims:,} paths seed {seeds[0]}: f32 {npv32!r} "
        f"f64 {npv64!r} rel {(npv32 - npv64) / npv64!r}")


def intrinsic_phase(check, out, num_grid=3000, num_decisions=121):
    """The engine's intrinsic value vs the float64 brute-force DP optimum."""
    from brute_force_intrinsic import brute_force_intrinsic_npv

    from storage_tpu import intrinsic_value
    from storage_tpu.compile import build_valuation_context

    storage, fwd_curve, ir_curve, rule = bench.build_case()
    engine = intrinsic_value(
        storage, bench.VAL_DATE, bench.INVENTORY, fwd_curve, ir_curve, rule
    ).npv
    ctx = build_valuation_context(
        storage, bench.VAL_DATE, bench.INVENTORY, fwd_curve, ir_curve, rule, 100, 1e-12
    )
    optimum = brute_force_intrinsic_npv(ctx, num_grid, num_decisions)
    out(f"intrinsic engine {engine!r} brute-force optimum {optimum!r}")
    above = engine / optimum - 1.0
    check("intrinsic above optimum", above, INTRINSIC_ABOVE_BOUND,
          above <= INTRINSIC_ABOVE_BOUND)
    rel = abs(engine - optimum) / abs(optimum)
    check("intrinsic vs optimum rel", rel, INTRINSIC_REL_BOUND, rel <= INTRINSIC_REL_BOUND)


def four_card_phase(check, out, devices, num_sims=bench.HEADLINE_SIMS):
    """The headline on a paths mesh over ``devices`` vs one device."""
    from storage_tpu.parallel.mesh import paths_mesh

    mesh = paths_mesh(devices)
    single, secs = _timed(bench.value, num_sims)
    out(f"one card {num_sims:,} paths: first call {secs!r} s")
    single, secs = _timed(bench.value, num_sims)
    out(f"one card {num_sims:,} paths: warm run {secs!r} s")
    multi, secs = _timed(bench.value, num_sims, mesh=mesh)
    out(f"{len(devices)} cards {num_sims:,} paths: first call {secs!r} s")
    multi, secs = _timed(bench.value, num_sims, mesh=mesh)
    out(f"{len(devices)} cards {num_sims:,} paths: warm run {secs!r} s")
    out(f"npv one card {single.npv!r} {len(devices)} cards {multi.npv!r}")
    rel = abs(multi.npv - single.npv) / abs(single.npv)
    check("mesh vs one card npv rel", rel, MESH_REL_BOUND, rel <= MESH_REL_BOUND)
    bound = MESH_DELTA_SHARE * bench.MAX_RATE
    diff = float((multi.deltas - single.deltas).abs().max())
    check("mesh vs one card max delta diff", diff, bound, diff <= bound)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card paths mesh against one card")
    args = parser.parse_args(argv)

    from storage_tpu.utils.compile_cache import use_compile_cache

    cache = use_compile_cache(os.path.join(ROOT, ".jax_cache"))
    import jax

    bench.require_gpu()
    devices = jax.devices()
    cards = bench.card_lines()
    print(f"compile cache: {cache}")
    print(f"jax {jax.__version__}; devices: {devices}")
    print(f"cards: {cards}")

    def out(msg):  # every number goes out beside the card it was taken on
        print(f"{msg}  [{cards.splitlines()[0]}]", flush=True)

    check = Checks(out)
    if args.four_cards:
        if len(devices) < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, found {len(devices)}")
        devices = devices[:4]
        four_card_phase(check, out, devices)
    else:
        devices = devices[:1]
        headline_phase(check, out)
        cross_model_phase(check, out)
        intrinsic_phase(check, out)
    if check.failed:
        print(f"FAILED: {', '.join(check.failed)}")
        return 1
    print(cards)
    print(json.dumps({"ok": True, "device": bench.device_record(devices)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
