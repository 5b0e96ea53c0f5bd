"""Inject/withdraw ratchet-rate lookup kernels.

The reference dispatches on constraint class per period
(``ConstantInjectWithdrawConstraint`` / ``PiecewiseLinearInjectWithdrawConstraint`` /
``StepInjectWithdrawConstraint``; ``InjectWithdrawConstraints/*.cs``).  Here the
representation is a single dense pillar tensor ``[num_steps, P, 3]`` of
``(inventory, min_rate, max_rate)`` rows, padded by repeating the final pillar,
plus one interpolation mode for the whole storage.  Rate lookup is then a
branch-free gather/interp that ``vmap``s over steps, grid points and
simulations — per-sim ratchet lookup inside the forward pass costs one small
vectorised searchsorted instead of the reference's per-sim virtual dispatch
(``LsmcStorageValuation.cs:431``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

INTERP_LINEAR = 0  # piecewise-linear in inventory (reference PiecewiseLinear)
INTERP_STEP = 1  # piecewise-constant, floor lookup (reference Step)
INTERP_POLY = 2  # exact-fit polynomial (reference PolynomialInjectWithdrawConstraint)


def interp_rates(pillars, inventory, interp_kind: int):
    """Min/max inject-withdraw rates at ``inventory``.

    Args:
      pillars: ``[P, 3]`` array of (inventory, min_rate, max_rate) rows,
        sorted ascending by inventory and padded by repeating the last row.
        Batched pillar tensors go through ``vmap``/``scan``, which strip the
        leading step axis before this kernel runs.
      inventory: array of any shape.
      interp_kind: INTERP_LINEAR or INTERP_STEP (static).

    Returns:
      ``(min_rate, max_rate)`` with the shape of ``inventory``.

    Linear mode mirrors MathNet's ``LinearSpline`` over the pillar points
    (reference ``PiecewiseLinearInjectWithdrawConstraint.cs:67-72``); step mode
    mirrors the floor binary search (``StepInjectWithdrawConstraint.cs:72-79``).
    Out-of-range inventories clamp to the boundary pillar (the engines only
    query inventories inside the reduced inventory space).
    """
    pillar_inv = pillars[:, 0]
    pillar_min = pillars[:, 1]
    pillar_max = pillars[:, 2]
    num_pillars = pillar_inv.shape[0]

    if interp_kind == INTERP_POLY:
        # Columns 3/4 carry the exact-fit polynomial coefficients (highest
        # power first, zero-padded): Horner evaluation, fully vectorised.
        min_rate = jnp.zeros_like(inventory)
        max_rate = jnp.zeros_like(inventory)
        for p_idx in range(num_pillars):
            min_rate = min_rate * inventory + pillars[p_idx, 3]
            max_rate = max_rate * inventory + pillars[p_idx, 4]
        return min_rate, max_rate

    # Index of the segment whose lower pillar is <= inventory.  P is small, so
    # a comparison-sum beats a searchsorted gather on the VPU.
    idx = jnp.sum(pillar_inv <= inventory[..., None], axis=-1) - 1
    if interp_kind == INTERP_STEP:
        idx = jnp.clip(idx, 0, num_pillars - 1)
        return jnp.take(pillar_min, idx), jnp.take(pillar_max, idx)

    lo = jnp.clip(idx, 0, num_pillars - 2)
    hi = lo + 1
    inv_lo = jnp.take(pillar_inv, lo)
    inv_hi = jnp.take(pillar_inv, hi)
    seg = inv_hi - inv_lo
    w = jnp.where(seg > 0.0, (inventory - inv_lo) / jnp.where(seg > 0.0, seg, 1.0), 0.0)
    w = jnp.clip(w, 0.0, 1.0)

    def lerp(vals):
        v_lo = jnp.take(vals, lo)
        v_hi = jnp.take(vals, hi)
        return v_lo + (v_hi - v_lo) * w

    return lerp(pillar_min), lerp(pillar_max)


def interp_rates_host(pillars: np.ndarray, inventory: float, interp_kind: int):
    """Host (NumPy, float64) single-point version of :func:`interp_rates`.

    Used by the inventory-space reduction, which runs once per valuation on the
    host (reference call site ``LsmcStorageValuation.cs:88``).
    """
    inv = pillars[:, 0]
    if interp_kind == INTERP_POLY:
        cmin = pillars[:, 3]
        cmax = pillars[:, 4]
        return float(np.polyval(cmin, inventory)), float(np.polyval(cmax, inventory))
    if interp_kind == INTERP_STEP:
        idx = int(np.searchsorted(inv, inventory, side="right")) - 1
        idx = min(max(idx, 0), len(inv) - 1)
        return float(pillars[idx, 1]), float(pillars[idx, 2])
    min_rate = float(np.interp(inventory, inv, pillars[:, 1]))
    max_rate = float(np.interp(inventory, inv, pillars[:, 2]))
    return min_rate, max_rate


def pad_pillars(tables, num_pillars: int | None = None) -> np.ndarray:
    """Stack per-step pillar tables ``[(P_k, C)]`` into ``[n, P, C]``.

    Columns are (inventory, min_rate, max_rate[, min_poly_coef, max_poly_coef]).
    Shorter tables pad the first three columns by repeating the last row (a
    no-op for rate lookup and bound solving) and any polynomial-coefficient
    columns with zeros (a no-op for Horner evaluation, which is degree-ordered
    highest first over the full padded height).
    """
    arrays = [np.asarray(t, dtype=np.float64) for t in tables]
    ncols = arrays[0].shape[1]
    max_p = num_pillars or max(a.shape[0] for a in arrays)
    out = np.zeros((len(arrays), max_p, ncols), dtype=np.float64)
    for k, a in enumerate(arrays):
        if a.shape[0] > max_p:
            raise ValueError("num_pillars smaller than a provided pillar table.")
        pad = max_p - a.shape[0]
        if ncols > 3 and pad:
            # Keep Horner order: the real table goes at the BOTTOM (so the
            # zero-padded COEFFICIENT rows above it are the highest powers)
            # and the padding's geometry columns repeat the FIRST geometry
            # row at the top — the inverse of the non-poly branch below.
            out[k, pad:, :] = a
            out[k, :pad, :3] = a[0, :3]
        else:
            out[k, : a.shape[0]] = a
            if pad:
                out[k, a.shape[0]:] = a[-1]
    return out
