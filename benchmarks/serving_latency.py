"""Warm-cache serving latency: first call vs later calls in one process.

``docs/operations.md`` describes the serving pattern (persistent XLA
compilation cache + long-lived process); this study measures it.  It runs the
walkthrough / README configuration (1-year daily ratcheted storage, 3-factor seasonal model,
reference ``samples/python/readme_example.py``) at a serving-scale path count
and records:

* ``first_call_s``  — cold-process latency: trace + compile (or persistent-
  cache load) + execute.  Run the script twice to see both flavours: the
  first invocation populates the compile cache (``$JAX_COMPILATION_CACHE_DIR``
  when set, else ``.jax_cache/`` in the checkout), the second invocation's
  ``first_call_s`` is the restart-with-warm-disk-cache number that a serving
  deployment actually pays.
* ``warm_call_s``   — steady-state latency: the SAME process re-pricing with
  a different seed (so nothing short-circuits) — the per-request cost of a
  long-lived valuation service.

Run:  python benchmarks/serving_latency.py [num_sims]
Prints one JSON line.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bench  # the headline case, valued with per-sim panels left on device


def main() -> None:
    import logging

    # INFO so each call's Stopwatches phase report (storage_tpu.valuation)
    # lands in the captured stderr — a slow "warm" call must be attributable.
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    num_sims = int(sys.argv[1]) if len(sys.argv) > 1 else 250_000
    from storage_tpu.utils.compile_cache import use_compile_cache

    # The documented serving pattern (docs/operations.md "Serving"): persist
    # compiled executables across process restarts.
    cache_dir = use_compile_cache(
        os.path.join(os.path.dirname(__file__), "..", ".jax_cache")
    )
    cache_was_populated = os.path.isdir(cache_dir) and bool(os.listdir(cache_dir))

    import jax

    backend = jax.default_backend()

    t0 = time.perf_counter()
    npv1 = bench.value(num_sims, seed=12).npv
    first_call = time.perf_counter() - t0
    print(f"# first call (cold process, disk cache "
          f"{'WARM' if cache_was_populated else 'COLD'}): {first_call:.2f}s "
          f"npv={npv1:,.0f}", file=sys.stderr, flush=True)

    warm_calls = []
    for i, seed in enumerate((13, 14, 15)):
        t0 = time.perf_counter()
        npv = bench.value(num_sims, seed=seed).npv
        warm_calls.append(time.perf_counter() - t0)
        print(f"# warm call #{i + 1} (seed {seed}): {warm_calls[-1]:.2f}s "
              f"npv={npv:,.0f}", file=sys.stderr, flush=True)

    line = {
        "metric": (
            f"serving latency, walkthrough config (1y daily ratcheted, "
            f"3-factor seasonal, full deltas+triggers), {num_sims:,} paths, "
            f"backend={backend}"
        ),
        "num_sims": num_sims,
        "first_call_s": round(first_call, 3),
        "disk_cache_warm_at_start": cache_was_populated,
        "warm_calls_s": [round(w, 3) for w in warm_calls],
        "warm_call_best_s": round(min(warm_calls), 3),
        "backend": backend,
        "cache_dir": cache_dir,
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S+00:00", time.gmtime()),
    }
    print(json.dumps(line))


if __name__ == "__main__":
    main()
