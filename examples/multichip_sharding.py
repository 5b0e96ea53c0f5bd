"""Path-sharded valuation over a device mesh.

On real hardware the mesh spans the GPUs of a host; for a workstation demo
force virtual CPU devices first:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip_sharding.py
"""
import os, sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import pandas as pd

from storage_tpu import CmdtyStorage, multi_factor_value
from storage_tpu.parallel.mesh import paths_mesh

storage = CmdtyStorage(
    "D", "2022-01-01", "2022-04-01",
    injection_cost=0.1, withdrawal_cost=0.2,
    min_inventory=0.0, max_inventory=5_000.0,
    max_injection_rate=200.0, max_withdrawal_rate=250.0,
)
idx = pd.period_range("2022-01-01", "2022-04-01", freq="D")
fwd_curve = pd.Series(30.0 + 5.0 * np.sin(np.arange(len(idx)) / 12.0), index=idx)
vol_curve = pd.Series(0.9, index=idx)

mesh = paths_mesh()  # 1-D mesh over all attached devices, axis 'paths'
print(f"mesh: {mesh}")

results = multi_factor_value(
    storage, "2022-01-01", 1_000.0, fwd_curve, None, None,
    factors=[(8.0, vol_curve)], factor_corrs=None,
    num_sims=131_072, basis_funcs="1 + x0 + x0**2 + x0**3",
    discount_deltas=False, seed=7,
    mesh=mesh,  # sims shard over 'paths'; regressions psum across chips
    return_sim_panels=False,
)
print(f"NPV: {results.npv:,.0f}")
