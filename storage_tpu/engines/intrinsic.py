"""Intrinsic storage valuation.

Deterministic dynamic program on the forward curve only — no stochasticity.
Reference: ``IntrinsicStorageValuation<T>.Calculate``
(``IntrinsicValuation/IntrinsicStorageValuation.cs:120-322``) and the Python
wrapper ``intrinsic_value`` (``cmdty_storage/intrinsic.py:42-111``).

Array formulation: backward induction is a ``lax.scan`` over time with the
inventory-grid dimension vectorised (``vmap``-free broadcasting), bang-bang
decision sets in fixed width, and O(1) uniform-grid interpolation of the
continuation value.  The forward sweep (one scalar inventory path through the
saved value functions) runs on the host in float64.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from ..compile import SettlementRule, ValuationContext, build_valuation_context
from ..exceptions import InventoryConstraintsCannotBeFulfilledError
from ..ops.decisions import bang_bang_decision_set, max_value_and_index
from ..ops.interp import cubic_spline_moments, fractional_index
from ..ops.ratchets import interp_rates_host
from ..storage import CmdtyStorage
from ..utils.discount import DiscountFn
from ..utils.frequencies import PeriodLike, normalize_freq, to_period
from .common import step_economics

PROFILE_COLUMNS = [
    "inventory",
    "inject_withdraw_volume",
    "cmdty_consumed",
    "inventory_loss",
    "net_volume",
    "period_pv",
]


class IntrinsicValuationResults(NamedTuple):
    """NPV + storage profile (reference ``intrinsic.py:37-39``)."""

    npv: float
    profile: pd.DataFrame


def _empty_profile(freq: str) -> pd.DataFrame:
    return pd.DataFrame(
        {c: [] for c in PROFILE_COLUMNS}, index=pd.PeriodIndex([], freq=freq)
    )


# Long horizons run as uniform sub-scans: every full chunk reuses ONE
# compiled program, so compile time does not grow with the horizon, and the
# carry crosses chunk seams exactly, so results are bit-identical to the
# single-scan form.
_INTRINSIC_CHUNK = 1024


@partial(jax.jit, static_argnames=("interp_kind", "num_grid_points", "extra_decisions", "cubic"))
def _backward_values_chunk(
    grids,  # [c, G] decision-period grids for this chunk
    space_min,  # [c] NEXT-period inventory-space bounds
    space_max,  # [c]
    pillars,  # [c, P, 3]
    loss,  # [c]
    inject_cost,
    withdraw_cost,
    cons_inject,
    cons_withdraw,
    inv_cost_rate,
    df_settle,
    df_start,
    fwd,  # [c]
    v_end,  # [G] value entering the period AFTER this chunk
    interp_kind: int,
    num_grid_points: int,
    extra_decisions: int = 0,
    cubic: bool = False,
):
    """One reverse-scanned chunk of the intrinsic backward induction
    (reference backward loop ``IntrinsicStorageValuation.cs:191-216``).

    Returns ``(v_first [G], values [c, G])``.  ``cubic=True`` interpolates
    the continuation with a natural cubic spline (reference
    ``WithCubicSplineInventorySpaceInterpolation``); linear is the default
    and recommended, matching the reference's own warning.
    """

    def step(v_next, inputs):
        (grid_k, next_lo, next_hi, pillars_k, loss_k, ic, wc, ci, cw, icr, dfs, df0, fwd_k) = inputs
        econ = step_economics(
            grid_k, pillars_k, interp_kind, loss_k, next_lo, next_hi,
            ic, wc, ci, cw, icr, dfs, df0, extra_decisions,
        )
        j, w = fractional_index(econ.inventory_after, next_lo, next_hi, num_grid_points)
        if cubic:
            from ..ops.interp import interp_columns_cubic

            h = (next_hi - next_lo) / (num_grid_points - 1)
            moments = cubic_spline_moments(v_next, h)
            cont = interp_columns_cubic(
                jnp.broadcast_to(v_next, (j.shape[0], v_next.shape[0])),
                jnp.broadcast_to(moments, (j.shape[0], moments.shape[0])),
                j, w, h,
            )
        else:
            cont = jnp.take(v_next, j) * (1.0 - w) + jnp.take(v_next, j + 1) * w
        total = econ.immediate_npv(fwd_k) + cont  # [G, D]
        v_k = jnp.max(total, axis=-1)
        return v_k, v_k

    xs = (
        grids,
        space_min,
        space_max,
        pillars,
        loss,
        inject_cost,
        withdraw_cost,
        cons_inject,
        cons_withdraw,
        inv_cost_rate,
        df_settle,
        df_start,
        fwd,
    )
    v_first, values = jax.lax.scan(step, v_end, xs, reverse=True)
    return v_first, values


def _backward_values(
    grids,  # [n+1, G]
    space_min,  # [n+1]
    space_max,  # [n+1]
    pillars,  # [n, P, 3]
    loss,  # [n]
    inject_cost,
    withdraw_cost,
    cons_inject,
    cons_withdraw,
    inv_cost_rate,
    df_settle,
    df_start,
    fwd,  # [n+1]
    terminal_values,  # [G]
    interp_kind: int,
    num_grid_points: int,
    extra_decisions: int = 0,
    cubic: bool = False,
):
    """Backward induction; returns the value function ``[n+1, G]`` on each
    period's grid, chunked into uniform reverse sub-scans (see the
    ``_INTRINSIC_CHUNK`` note) with the carry crossing seams exactly.

    Inputs are HOST (NumPy) arrays: chunk slicing happens host-side (a
    device-array slice at each new offset would compile a distinct tiny
    program) and each chunk transfers on call.
    """
    n = pillars.shape[0]
    statics = dict(
        interp_kind=interp_kind, num_grid_points=num_grid_points,
        extra_decisions=extra_decisions, cubic=cubic,
    )
    dtype = grids.dtype
    v = jnp.asarray(terminal_values, dtype)
    parts = [np.asarray(terminal_values, dtype)[None, :]]
    for b in range(n, 0, -_INTRINSIC_CHUNK):
        a = max(0, b - _INTRINSIC_CHUNK)
        v, values_c = _backward_values_chunk(
            jnp.asarray(grids[a:b]), jnp.asarray(space_min[a + 1 : b + 1]),
            jnp.asarray(space_max[a + 1 : b + 1]), jnp.asarray(pillars[a:b]),
            jnp.asarray(loss[a:b]), jnp.asarray(inject_cost[a:b]),
            jnp.asarray(withdraw_cost[a:b]), jnp.asarray(cons_inject[a:b]),
            jnp.asarray(cons_withdraw[a:b]), jnp.asarray(inv_cost_rate[a:b]),
            jnp.asarray(df_settle[a:b]), jnp.asarray(df_start[a:b]),
            jnp.asarray(fwd[a:b]), v,
            **statics,
        )
        parts.insert(0, np.asarray(values_c))
    return np.concatenate(parts, axis=0)


def _host_cubic_moments(y: np.ndarray, h: float) -> np.ndarray:
    """Float64 host mirror of ``ops.interp.cubic_spline_moments`` (natural
    boundary conditions, uniform grid)."""
    G = len(y)
    rhs = np.zeros(G)
    rhs[1:-1] = 6.0 * (y[:-2] - 2.0 * y[1:-1] + y[2:]) / h**2
    A = np.zeros((G, G))
    A[0, 0] = A[-1, -1] = 1.0
    idx = np.arange(1, G - 1)
    A[idx, idx - 1] = 1.0
    A[idx, idx] = 4.0
    A[idx, idx + 1] = 1.0
    return np.linalg.solve(A, rhs)


def _host_cubic_eval(x0: float, h: float, y: np.ndarray, m: np.ndarray, xq: float) -> float:
    t = (xq - x0) / h
    j = int(np.clip(np.floor(t), 0, len(y) - 2))
    w = float(np.clip(t - j, 0.0, 1.0))
    u = 1.0 - w
    return float(
        y[j] * u + y[j + 1] * w
        + h * h / 6.0 * ((u**3 - u) * m[j] + (w**3 - w) * m[j + 1])
    )


def _forward_sweep(
    ctx: ValuationContext,
    values: np.ndarray,
    extra_decisions: int = 0,
    interpolation: str = "linear",
):
    """Forward pass choosing optimal decisions from the starting inventory.

    Host float64 re-derivation of the optimal policy against the device value
    functions (reference ``IntrinsicStorageValuation.cs:218-259``).  The
    continuation is evaluated with the SAME interpolator the backward DP used
    (the reference applies its configured interpolator factory in both
    passes); with ``interpolation='cubic'`` that is the natural cubic spline.
    """
    n = ctx.n_steps
    rows = np.zeros((n + 1, len(PROFILE_COLUMNS)), dtype=np.float64)
    inv = ctx.inventory
    for k in range(n):
        min_rate, max_rate = interp_rates_host(
            ctx.storage.pillar_tables[
                (ctx.periods[0] - ctx.storage.start).n + k
            ],
            inv,
            ctx.interp_kind,
        )
        loss = float(ctx.inventory_loss[k]) * inv
        decisions = bang_bang_decision_set(
            min_rate, max_rate, inv, loss,
            float(ctx.inv_space.min_inventory[k + 1]),
            float(ctx.inv_space.max_inventory[k + 1]),
            ctx.numerical_tolerance,
            extra_decisions,
        )
        grid_next = ctx.grids[k + 1]
        v_next = values[k + 1]
        h_next = (grid_next[-1] - grid_next[0]) / max(len(grid_next) - 1, 1)
        use_cubic = interpolation == "cubic" and len(v_next) >= 3 and h_next > 0.0
        if use_cubic:
            moments_next = _host_cubic_moments(v_next, h_next)
        price = float(ctx.fwd[k])
        d_arr = np.asarray(decisions, dtype=np.float64)
        inv_after = inv + d_arr - loss
        if use_cubic:
            cont = np.array(
                [
                    _host_cubic_eval(
                        float(grid_next[0]), h_next, v_next, moments_next, q
                    )
                    for q in inv_after
                ]
            )
        else:
            # One vectorised interp for the whole decision set (the scalar
            # per-decision np.interp calls dominated this host sweep).
            cont = np.interp(inv_after, grid_next, v_next)
        abs_d = np.abs(d_arr)
        inject = d_arr > 0.0
        consumed_arr = np.where(
            inject, float(ctx.cons_inject[k]) * abs_d, float(ctx.cons_withdraw[k]) * abs_d
        )
        iw_cost = np.where(
            inject, float(ctx.inject_cost[k]) * abs_d, float(ctx.withdraw_cost[k]) * abs_d
        )
        inv_cost = float(ctx.inventory_cost_rate[k]) * inv
        period_pvs = (
            -(d_arr + consumed_arr) * price * float(ctx.df_settle[k])
            - (iw_cost + inv_cost) * float(ctx.df_cost[k])
        )
        totals = period_pvs + cont
        _, best = max_value_and_index(totals)
        d_opt = float(decisions[best])
        inv = inv + d_opt - loss
        net_volume = -d_opt - consumed_arr[best]
        rows[k] = (inv, d_opt, consumed_arr[best], loss, net_volume, period_pvs[best])

    # End-period row: no decision; terminal PV if the storage can hold inventory
    # (IntrinsicStorageValuation.cs:230-234).
    end_pv = 0.0
    if not ctx.storage.must_be_empty_at_end:
        end_pv = ctx.storage.terminal_storage_npv(float(ctx.fwd[n]), inv)
    rows[n] = (inv, 0.0, 0.0, 0.0, 0.0, end_pv)
    return rows


def intrinsic_value(
    cmdty_storage: CmdtyStorage,
    val_date: PeriodLike,
    inventory: Union[float, int],
    forward_curve: pd.Series,
    interest_rates: Union[None, float, pd.Series, DiscountFn],
    settlement_rule: Optional[SettlementRule],
    num_inventory_grid_points: int = 100,
    numerical_tolerance: float = 1e-12,
    extra_decisions: int = 0,
    dtype=jnp.float32,
    interpolation: str = "linear",
) -> IntrinsicValuationResults:
    """Intrinsic value of commodity storage (reference ``intrinsic.py:42-66``).

    ``interpolation``: 'linear' (default, reference
    ``WithLinearInventorySpaceInterpolation``) or 'cubic' (natural cubic
    spline, reference ``WithCubicSplineInventorySpaceInterpolation`` — which
    the reference itself warns performs poorly).

    Args:
      settlement_rule: maps each delivery ``pd.Period`` to its settlement date;
        ``None`` settles on the period start day (undiscounted within period).
    """
    freq = normalize_freq(cmdty_storage.freq)
    val_period = to_period(val_date, freq)
    if val_period > cmdty_storage.end:
        return IntrinsicValuationResults(0.0, _empty_profile(freq))
    if val_period == cmdty_storage.end:
        if cmdty_storage.must_be_empty_at_end:
            if inventory > 0:
                raise InventoryConstraintsCannotBeFulfilledError(
                    "Storage must be empty at end, but inventory is greater than zero."
                )
            return IntrinsicValuationResults(0.0, _empty_profile(freq))
        if inventory < cmdty_storage.min_inventory(val_period):
            raise InventoryConstraintsCannotBeFulfilledError(
                "Current inventory is lower than the minimum allowed in the end period."
            )
        if inventory > cmdty_storage.max_inventory(val_period):
            raise InventoryConstraintsCannotBeFulfilledError(
                "Current inventory is greater than the maximum allowed in the end period."
            )
        price = float(forward_curve[val_period])
        npv = cmdty_storage.terminal_storage_npv(price, float(inventory))
        return IntrinsicValuationResults(npv, _empty_profile(freq))

    ctx = build_valuation_context(
        cmdty_storage, val_date, float(inventory), forward_curve, interest_rates,
        settlement_rule, num_inventory_grid_points, numerical_tolerance,
    )
    return intrinsic_value_with_ctx(ctx, extra_decisions, dtype, interpolation)


def intrinsic_value_with_ctx(
    ctx, extra_decisions: int = 0, dtype=jnp.float32, interpolation: str = "linear"
) -> IntrinsicValuationResults:
    """Intrinsic valuation on an already-compiled context (lets the LSMC
    entry point share ONE context build between both engines — the pandas ->
    step-array compilation is host work worth ~90 ms at daily resolution)."""
    n = ctx.n_steps
    grid_end = ctx.grids[n]
    if ctx.storage.terminal_npv_fn is None:
        terminal = np.zeros_like(grid_end)
    else:
        terminal = np.asarray(ctx.storage.terminal_npv_fn(ctx.fwd[n], grid_end), dtype=np.float64)
        terminal = np.broadcast_to(terminal, grid_end.shape)

    np_dtype = np.dtype(jnp.dtype(dtype).name)
    values = _backward_values(
        np.asarray(ctx.grids, np_dtype),
        np.asarray(ctx.inv_space.min_inventory, np_dtype),
        np.asarray(ctx.inv_space.max_inventory, np_dtype),
        np.asarray(ctx.pillars, np_dtype),
        np.asarray(ctx.inventory_loss, np_dtype),
        np.asarray(ctx.inject_cost, np_dtype),
        np.asarray(ctx.withdraw_cost, np_dtype),
        np.asarray(ctx.cons_inject, np_dtype),
        np.asarray(ctx.cons_withdraw, np_dtype),
        np.asarray(ctx.inventory_cost_rate, np_dtype),
        np.asarray(ctx.df_settle, np_dtype),
        np.asarray(ctx.df_cost, np_dtype),
        np.asarray(ctx.fwd, np_dtype),
        np.asarray(terminal, np_dtype),
        interp_kind=ctx.interp_kind,
        num_grid_points=ctx.num_grid_points,
        extra_decisions=extra_decisions,
        cubic=(interpolation == "cubic"),
    )
    values_np = np.asarray(values, dtype=np.float64)
    rows = _forward_sweep(ctx, values_np, extra_decisions, interpolation)
    npv = float(rows[:, PROFILE_COLUMNS.index("period_pv")].sum())
    profile = pd.DataFrame(rows, columns=PROFILE_COLUMNS, index=ctx.periods)
    return IntrinsicValuationResults(npv, profile)
