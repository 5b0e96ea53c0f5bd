"""Inventory-grid interpolation kernels.

The engines hold value functions on per-period inventory grids and linearly
interpolate them at post-decision inventories.  The reference does this with a
per-query binary search (``StorageHelper.BisectInventorySpace``,
``StorageHelper.cs:280-314``) plus linear weights
(``LsmcStorageValuation.cs:722-741``).  This design uses **uniform
(linspace) per-period grids**, so the bracketing index is O(1) arithmetic —
``(x - lo) / step`` — with no search, no data-dependent control flow, and
perfect vectorisation over sims × grid points × decisions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def uniform_grid(lo, hi, num_points: int) -> np.ndarray:
    """Host: linspace grid over one period's inventory space.

    Degenerate ranges (lo == hi) produce a constant grid, mirroring the
    reference's single-point grid for the first active period
    (``LsmcStorageValuation.cs:209-217``).
    """
    return np.linspace(float(lo), float(hi), num_points)


def uniform_grids(lo: np.ndarray, hi: np.ndarray, num_points: int) -> np.ndarray:
    """Host: ``[n, G]`` linspace grids for per-period inventory spaces."""
    frac = np.linspace(0.0, 1.0, num_points)
    return lo[:, None] + (hi - lo)[:, None] * frac[None, :]


def fractional_index(x, lo, hi, num_points: int):
    """Continuous index of ``x`` on the uniform grid ``linspace(lo, hi, G)``.

    Returns ``(j, w)`` with integer lower index ``j`` in ``[0, G-2]`` and
    weight ``w`` on the upper neighbour; constant grids return ``(0, 0)``.
    Inputs broadcast.
    """
    span = hi - lo
    step = span / (num_points - 1)
    t = jnp.where(span > 0.0, (x - lo) / jnp.where(span > 0.0, step, 1.0), 0.0)
    j = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, num_points - 2)
    w = jnp.clip(t - j, 0.0, 1.0)
    return j, w


def interp_columns(values, j, w):
    """Linear interpolation of ``values[..., G]`` at fractional indices.

    ``j``/``w`` must broadcast against ``values[..., 0]``'s shape with
    trailing query dims appended — both are gathered along the last axis.
    """
    v_lo = jnp.take_along_axis(values, j, axis=-1)
    v_hi = jnp.take_along_axis(values, j + 1, axis=-1)
    return v_lo + (v_hi - v_lo) * w


def cubic_spline_moments(values, step):
    """Second-derivative 'moments' of a natural cubic spline on a uniform grid.

    Equivalent of the reference's ``NaturalCubicSplineInterpolatorFactory``
    (``InterpolatorFactories/``; flagged there as performing poorly for
    value-function interpolation — provided for parity, linear remains the
    default).  Solves the standard tridiagonal system
    ``M[i-1] + 4 M[i] + M[i+1] = 6 (V[i-1] - 2 V[i] + V[i+1]) / h^2`` with
    natural boundary conditions; degenerate grids (step == 0) yield zero
    moments, i.e. linear behaviour.

    Args:
      values: ``[..., G]``.
      step: scalar grid spacing (may be a traced value).

    Returns moments ``[..., G]``.
    """
    num_points = values.shape[-1]
    safe_h = jnp.where(step > 0.0, step, 1.0)
    rhs = jnp.zeros_like(values)
    interior = 6.0 * (values[..., :-2] - 2.0 * values[..., 1:-1] + values[..., 2:]) / safe_h**2
    rhs = rhs.at[..., 1:-1].set(interior)

    diag = jnp.concatenate(
        [jnp.ones((1,), values.dtype),
         jnp.full((num_points - 2,), 4.0, values.dtype),
         jnp.ones((1,), values.dtype)]
    )
    off_lower = jnp.concatenate(
        [jnp.zeros((1,), values.dtype),
         jnp.ones((num_points - 2,), values.dtype),
         jnp.zeros((1,), values.dtype)]
    )
    off_upper = jnp.concatenate(
        [jnp.zeros((1,), values.dtype),
         jnp.ones((num_points - 2,), values.dtype),
         jnp.zeros((1,), values.dtype)]
    )
    batch = rhs.reshape((-1, num_points)).T  # [G, batch]
    moments = jax.lax.linalg.tridiagonal_solve(off_lower, diag, off_upper, batch)
    moments = moments.T.reshape(values.shape)
    return jnp.where(step > 0.0, moments, jnp.zeros_like(moments))


def interp_columns_cubic(values, moments, j, w, step):
    """Natural-cubic-spline interpolation of ``values[..., G]`` at fractional
    indices (same gather contract as :func:`interp_columns`)."""
    v_lo = jnp.take_along_axis(values, j, axis=-1)
    v_hi = jnp.take_along_axis(values, j + 1, axis=-1)
    m_lo = jnp.take_along_axis(moments, j, axis=-1)
    m_hi = jnp.take_along_axis(moments, j + 1, axis=-1)
    u = 1.0 - w
    h2_over_6 = step**2 / 6.0
    return (
        v_lo * u + v_hi * w
        + h2_over_6 * ((u**3 - u) * m_lo + (w**3 - w) * m_hi)
    )
