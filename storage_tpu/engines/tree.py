"""Trinomial-tree storage valuation.

Reference: ``TreeStorageValuation<T>.Calculate``
(``TreeValuation/TreeStorageValuation.cs:143-342``) and the Python wrapper
``trinomial_value`` / ``trinomial_deltas`` (``cmdty_storage/trinomial.py``).

Array formulation: the generic DP over a recombining tree becomes a ``lax.scan``
over periods carrying the value function ``V [K, G]`` (price levels x
inventory grid).  Per period: the expected continuation per CURRENT node is a
probability-weighted gather over the three branch destinations (linear in V,
so interchangeable with the reference's interpolate-then-weight order,
``TreeStorageValuation.cs:322-330``), then the same fixed-width bang-bang
decision kernel as the other engines, vectorised over (node, grid).
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
from ..models.trinomial import TrinomialTree, build_intrinsic_tree, build_trinomial_tree
from ..ops.interp import cubic_spline_moments, fractional_index
from ..storage import CmdtyStorage
from ..utils.discount import DiscountFn
from ..utils.frequencies import PeriodLike, normalize_freq, to_period
from .common import step_economics


class TreeValuationResults(NamedTuple):
    """NPV + the dense tree + per-period value functions.

    Engine-level mirror of ``TreeStorageValuationResults<T>``
    (``TreeValuation/TreeStorageValuationResults.cs``): NPV, the tree itself,
    value-by-(level, inventory-grid) per period, and the inventory space.
    """

    npv: float
    tree: TrinomialTree
    values: np.ndarray  # [n+1, K, G] storage value per (period, level, grid pt)
    grids: np.ndarray  # [n+1, G]
    inv_space_min: np.ndarray  # [n+1]
    inv_space_max: np.ndarray  # [n+1]
    #: Optimal inject/withdraw volume per (period, level, grid point) — the
    #: reference's ``InjectWithdrawDecisions`` cube
    #: (``TreeStorageValuationResults.cs:41``).  [n, K, G]
    decisions: np.ndarray = None


@partial(jax.jit, static_argnames=(
    "interp_kind", "num_grid_points", "extra_decisions", "cubic"))
def _tree_backward(
    terminal_values,  # [K, G]
    node_prices,  # [n, K] (decision steps)
    branch_center,  # [n, K]
    branch_probs,  # [n, K, 3]
    grids,  # [n, G]
    next_lo,  # [n]
    next_hi,  # [n]
    pillars,
    loss,
    inject_cost,
    withdraw_cost,
    cons_inject,
    cons_withdraw,
    inv_cost_rate,
    df_settle,
    df_start,
    interp_kind: int,
    num_grid_points: int,
    extra_decisions: int,
    cubic: bool = False,
):
    """Backward DP; returns values ``[n+1, K, G]`` (period-major).

    ``cubic`` switches the inventory interpolation of the expected
    continuation to a natural cubic spline per tree level (reference
    ``WithInterpolatorFactory`` + ``NaturalCubicSplineInterpolatorFactory``;
    linear remains the default, matching the reference's guidance).
    """

    def step(v_next, xs):
        (prices_k, center_k, probs_k, grid_k, lo, hi, pil, lr, ic, wc, ci, cw, icr, dfs, df0) = xs
        # Expected continuation per current node across its three destinations.
        down = v_next[center_k - 1]  # [K, G] gather of rows
        mid = v_next[center_k]
        up = v_next[center_k + 1]
        expected = (
            probs_k[:, 0, None] * down + probs_k[:, 1, None] * mid + probs_k[:, 2, None] * up
        )  # [K, G]

        econ = step_economics(
            grid_k, pil, interp_kind, lr, lo, hi,
            ic, wc, ci, cw, icr, dfs, df0, extra_decisions,
        )  # decisions [G, D]
        j, w = fractional_index(econ.inventory_after, lo, hi, num_grid_points)  # [G, D]
        # Interpolate expected continuation at post-decision inventories:
        # expected [K, G'] gathered at [G, D] column indices -> [K, G, D].
        v_lo = jnp.take(expected, j, axis=1)
        v_hi = jnp.take(expected, j + 1, axis=1)
        u = (1.0 - w)[None]
        ww = w[None]
        cont = v_lo * u + v_hi * ww
        if cubic:
            h = (hi - lo) / (num_grid_points - 1)
            moments = cubic_spline_moments(expected, h)  # [K, G']
            cont = cont + h**2 / 6.0 * (
                (u**3 - u) * jnp.take(moments, j, axis=1)
                + (ww**3 - ww) * jnp.take(moments, j + 1, axis=1)
            )
        immediate = (
            econ.price_coeff[None, :, :] * prices_k[:, None, None]
            - econ.cost_npv[None, :, :]
        )  # [K, G, D]
        total = immediate + cont  # [K, G, D]
        best = jnp.argmax(total, axis=-1)  # [K, G]
        v_k = jnp.take_along_axis(total, best[..., None], axis=-1)[..., 0]
        # Optimal decision VOLUME at each (level, grid point): the reference's
        # InjectWithdrawDecisions cube entry for this period.
        dec_k = jnp.take_along_axis(
            jnp.broadcast_to(econ.decisions[None], total.shape),
            best[..., None], axis=-1,
        )[..., 0]
        return v_k, (v_k, dec_k)

    xs = (
        node_prices, branch_center, branch_probs, grids, next_lo, next_hi,
        pillars, loss, inject_cost, withdraw_cost, cons_inject, cons_withdraw,
        inv_cost_rate, df_settle, df_start,
    )
    _, (values, decisions) = jax.lax.scan(step, terminal_values, xs, reverse=True)
    return jnp.concatenate([values, terminal_values[None]], axis=0), decisions


def tree_value(
    ctx: ValuationContext,
    tree: TrinomialTree,
    extra_decisions: int = 0,
    dtype=jnp.float32,
    interpolation: str = "linear",
) -> TreeValuationResults:
    """Run the tree DP for a compiled valuation context."""
    n = ctx.n_steps
    G = ctx.num_grid_points
    K = tree.num_levels
    if tree.values.shape[0] != n + 1:
        raise ValueError("Tree length must equal the number of active periods.")

    grid_end = ctx.grids[n]
    if ctx.storage.terminal_npv_fn is None:
        terminal = np.zeros((K, G), dtype=np.float64)
    else:
        terminal = np.broadcast_to(
            np.asarray(
                ctx.storage.terminal_npv_fn(tree.values[n][:, None], grid_end[None, :]),
                dtype=np.float64,
            ),
            (K, G),
        )

    # Pad branch arrays: decision steps are 0..n-1 and branch arrays have n-1
    # rows (transitions between simulated periods); the tree's last decision
    # step n-1 transitions INTO the end period so uses branch row n-1... the
    # builder produces exactly n rows of transitions for n+1 periods.
    values, decisions = _tree_backward(
        jnp.asarray(terminal, dtype),
        jnp.asarray(tree.values[:n], dtype),
        jnp.asarray(tree.branch_center[:n]),
        jnp.asarray(tree.branch_probs[:n], dtype),
        jnp.asarray(ctx.grids[:n], dtype),
        jnp.asarray(ctx.inv_space.min_inventory[1:], dtype),
        jnp.asarray(ctx.inv_space.max_inventory[1:], dtype),
        jnp.asarray(ctx.pillars, dtype),
        jnp.asarray(ctx.inventory_loss, dtype),
        jnp.asarray(ctx.inject_cost, dtype),
        jnp.asarray(ctx.withdraw_cost, dtype),
        jnp.asarray(ctx.cons_inject, dtype),
        jnp.asarray(ctx.cons_withdraw, dtype),
        jnp.asarray(ctx.inventory_cost_rate, dtype),
        jnp.asarray(ctx.df_settle, dtype),
        jnp.asarray(ctx.df_cost, dtype),
        interp_kind=ctx.interp_kind,
        num_grid_points=G,
        extra_decisions=extra_decisions,
        cubic=(interpolation == "cubic"),
    )
    values_np = np.asarray(values, dtype=np.float64)

    # NPV: probability-weighted roll-up at the first active period over its
    # reachable nodes, at the starting inventory (grid[0] is degenerate at the
    # starting inventory, so any column works) — reference :272-280.
    npv = float(np.dot(tree.probs[0], values_np[0, :, 0]))
    return TreeValuationResults(
        npv=npv,
        tree=tree,
        values=values_np,
        grids=ctx.grids,
        inv_space_min=ctx.inv_space.min_inventory,
        inv_space_max=ctx.inv_space.max_inventory,
        decisions=np.asarray(decisions, dtype=np.float64),
    )


def trinomial_value(
    cmdty_storage: CmdtyStorage,
    val_date: PeriodLike,
    inventory: float,
    forward_curve: pd.Series,
    spot_volatility: pd.Series,
    mean_reversion: float,
    time_step: float,
    interest_rates: Union[None, float, pd.Series, DiscountFn],
    settlement_rule: Optional[SettlementRule],
    num_inventory_grid_points: int = 100,
    numerical_tolerance: float = 1e-12,
    extra_decisions: int = 0,
    dtype=jnp.float32,
    interpolation: str = "linear",
) -> float:
    """Storage value under a one-factor trinomial tree
    (reference ``trinomial.py:36-85``); ``interpolation`` may be 'linear'
    (default) or 'cubic' (natural spline, reference
    ``WithInterpolatorFactory``)."""
    freq = normalize_freq(cmdty_storage.freq)
    if freq != normalize_freq(forward_curve.index.freqstr):
        raise ValueError("cmdty_storage and forward_curve have different frequencies.")
    if freq != normalize_freq(spot_volatility.index.freqstr):
        raise ValueError("cmdty_storage and spot_volatility have different frequencies.")
    val_period = to_period(val_date, freq)
    if val_period > cmdty_storage.end:
        return 0.0
    if val_period == cmdty_storage.end:
        if cmdty_storage.must_be_empty_at_end:
            if inventory > 0:
                raise InventoryConstraintsCannotBeFulfilledError(
                    "Storage must be empty at end, but inventory is greater than zero."
                )
            return 0.0
        return cmdty_storage.terminal_storage_npv(
            float(forward_curve[val_period]), float(inventory)
        )

    ctx = build_valuation_context(
        cmdty_storage, val_date, float(inventory), forward_curve, interest_rates,
        settlement_rule, num_inventory_grid_points, numerical_tolerance,
    )
    vols = spot_volatility.reindex(ctx.periods)
    if vols.isna().any():
        raise ValueError("spot_volatility must cover all storage periods.")
    tree = build_trinomial_tree(
        ctx.fwd, vols.to_numpy(dtype=np.float64), mean_reversion, time_step
    )
    return tree_value(ctx, tree, extra_decisions, dtype, interpolation).npv


def intrinsic_tree_value(
    cmdty_storage: CmdtyStorage,
    val_date: PeriodLike,
    inventory: float,
    forward_curve: pd.Series,
    interest_rates,
    settlement_rule,
    num_inventory_grid_points: int = 100,
    numerical_tolerance: float = 1e-12,
) -> float:
    """Tree DP over the degenerate intrinsic (forward-path) tree —
    reference ``WithIntrinsicTree`` (``TreeStorageValuationExtensions.cs:104-124``)."""
    ctx = build_valuation_context(
        cmdty_storage, val_date, float(inventory), forward_curve, interest_rates,
        settlement_rule, num_inventory_grid_points, numerical_tolerance,
    )
    tree = build_intrinsic_tree(ctx.fwd)
    return tree_value(ctx, tree).npv


def trinomial_deltas(
    cmdty_storage: CmdtyStorage,
    val_date: PeriodLike,
    inventory: float,
    forward_curve: pd.Series,
    spot_volatility: pd.Series,
    mean_reversion: float,
    time_step: float,
    interest_rates,
    settlement_rule,
    fwd_contracts,
    num_inventory_grid_points: int = 100,
    numerical_tolerance: float = 1e-12,
    delta_shift: Optional[float] = None,
    dtype=None,
):
    """Bump-and-revalue deltas per forward contract
    (reference ``trinomial.py:88-118``).

    By default the bump-and-revalue DP runs in float64 under a local
    ``jax.enable_x64`` scope with the reference's 1e-5 bump
    (``trinomial.py:100``) — the tree DP is tiny, so the extra precision costs
    nothing, and bump-and-revalue accuracy is mantissa-bound.  Pass
    ``dtype=jnp.float32`` to force the single-precision mode,
    where ``delta_shift`` defaults to 0.01 instead (1e-5 sits below a float32
    NPV's resolution; bump-size studies show 0.01 recovers the f64 small-bump
    deltas to ~1e-3).
    """
    from ..utils.contracts import to_period_range

    if dtype is None:
        with jax.enable_x64(True):
            return trinomial_deltas(
                cmdty_storage, val_date, inventory, forward_curve, spot_volatility,
                mean_reversion, time_step, interest_rates, settlement_rule,
                fwd_contracts, num_inventory_grid_points, numerical_tolerance,
                delta_shift, dtype=jnp.float64,
            )
    if delta_shift is None:
        delta_shift = 1e-5 if jnp.dtype(dtype) == jnp.dtype("float64") else 0.01
    freq = normalize_freq(cmdty_storage.freq)
    curve = forward_curve.copy()
    deltas = []
    for fwd_contract in fwd_contracts:
        start, end = to_period_range(freq, fwd_contract)
        base = forward_curve[start:end].copy()
        curve[start:end] = base + delta_shift
        up = trinomial_value(
            cmdty_storage, val_date, inventory, curve, spot_volatility, mean_reversion,
            time_step, interest_rates, settlement_rule, num_inventory_grid_points,
            numerical_tolerance, dtype=dtype,
        )
        curve[start:end] = base - delta_shift
        down = trinomial_value(
            cmdty_storage, val_date, inventory, curve, spot_volatility, mean_reversion,
            time_step, interest_rates, settlement_rule, num_inventory_grid_points,
            numerical_tolerance, dtype=dtype,
        )
        deltas.append((up - down) / (2.0 * delta_shift))
        curve[start:end] = base
    return deltas


class TreeSimulationResults(NamedTuple):
    """Replay results (reference ``TreeSimulationResults.cs``)."""

    npv: float
    decision_profile: pd.Series
    cmdty_consumed: pd.Series


def simulate_decisions(
    ctx: ValuationContext,
    valuation: TreeValuationResults,
    transition_path,
    extra_decisions: int = 0,
) -> TreeSimulationResults:
    """Replay the optimal policy along a user-supplied path of transition
    indices (0=down, 1=mid, 2=up per step).

    Reference: ``TreeStorageValuation.SimulateDecisions`` /
    ``DecisionSimulator`` (``TreeStorageValuation.cs:344-433``): at each period
    the optimal decision is re-derived against the next period's value
    functions at the realised node, then the tree is advanced along the given
    transition index.
    """
    from ..ops.decisions import bang_bang_decision_set, max_value_and_index
    from ..ops.ratchets import interp_rates_host

    tree = valuation.tree
    n = ctx.n_steps
    transition_path = list(transition_path)
    if len(transition_path) < n:
        raise ValueError(f"transition_path must supply at least {n} transition indices.")

    level = int(np.argmax(tree.probs[0]))  # root: the only level with mass
    inventory = ctx.inventory
    start_offset = (ctx.periods[0] - ctx.storage.start).n
    npv = 0.0
    decisions_out = np.zeros(n)
    consumed_out = np.zeros(n)

    for k in range(n):
        price = float(tree.values[k, level])
        pillars = ctx.storage.pillar_tables[start_offset + k]
        min_rate, max_rate = interp_rates_host(pillars, inventory, ctx.interp_kind)
        loss = float(ctx.inventory_loss[k]) * inventory
        decision_set = bang_bang_decision_set(
            min_rate, max_rate, inventory, loss,
            float(ctx.inv_space.min_inventory[k + 1]),
            float(ctx.inv_space.max_inventory[k + 1]),
            ctx.numerical_tolerance, extra_decisions,
        )
        grid_next = valuation.grids[k + 1]
        center = int(tree.branch_center[k, level]) if tree.branch_center.shape[0] > k else 0
        probs = tree.branch_probs[k, level] if tree.branch_probs.shape[0] > k else np.array([0.0, 1.0, 0.0])
        totals = np.empty(len(decision_set))
        imm = np.empty(len(decision_set))
        consumed_arr = np.empty(len(decision_set))
        for d_idx, d in enumerate(decision_set):
            q_after = inventory + d - loss
            cont = 0.0
            for off, p_col in ((-1, 0), (0, 1), (1, 2)):
                dest = min(max(center + off, 0), valuation.values.shape[1] - 1)
                cont += float(probs[p_col]) * float(
                    np.interp(q_after, grid_next, valuation.values[k + 1, dest])
                )
            consumed = (
                float(ctx.cons_inject[k]) * abs(d) if d > 0 else float(ctx.cons_withdraw[k]) * abs(d)
            )
            cost = (
                float(ctx.inject_cost[k]) * abs(d) if d > 0 else float(ctx.withdraw_cost[k]) * abs(d)
            )
            inv_cost = float(ctx.inventory_cost_rate[k]) * inventory
            immediate = (
                -(d + consumed) * price * float(ctx.df_settle[k])
                - (cost + inv_cost) * float(ctx.df_cost[k])
            )
            totals[d_idx] = immediate + cont
            imm[d_idx] = immediate
            consumed_arr[d_idx] = consumed
        _, best = max_value_and_index(totals)
        d_opt = float(decision_set[best])
        npv += imm[best]
        decisions_out[k] = d_opt
        consumed_out[k] = consumed_arr[best]
        inventory = inventory + d_opt - loss
        # Advance the tree along the supplied transition.
        t_idx = int(transition_path[k])
        if t_idx not in (0, 1, 2):
            raise ValueError("Transition indices must be 0 (down), 1 (mid) or 2 (up).")
        if k < tree.branch_center.shape[0]:
            level = int(np.clip(tree.branch_center[k, level] + (t_idx - 1), 0,
                                tree.values.shape[1] - 1))

    if not ctx.storage.must_be_empty_at_end:
        npv += ctx.storage.terminal_storage_npv(float(tree.values[n, level]), inventory)

    index = ctx.periods[:-1]
    return TreeSimulationResults(
        npv=float(npv),
        decision_profile=pd.Series(decisions_out, index=index),
        cmdty_consumed=pd.Series(consumed_out, index=index),
    )
