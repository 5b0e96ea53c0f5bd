"""Least-Squares Monte Carlo storage valuation — the flagship engine.

Reference: ``LsmcStorageValuation.Calculate<T>``
(``LsmcValuation/LsmcStorageValuation.cs:55-617``).  The array formulation
(SURVEY.md §3.2, §7 stage 4):

- **Backward induction** is a ``lax.scan`` over periods carrying the
  value-by-(sim, grid) matrix ``V [S, G]``.  Per period: one design matrix
  ``[S, B]``, one standardized normal-equations solve for ALL grid columns at
  once (two matmuls + a [B,B] Cholesky — replacing the reference's
  float64 MKL QR, :186-191), fixed-width bang-bang decisions, O(1)
  uniform-grid continuation interpolation, and a static unrolled loop over the
  small decision axis so peak memory stays at a few ``[S, G]`` buffers.
- The **lower-bound estimator subtlety** is preserved exactly: the argmax is
  taken over *fitted* continuation values but the realised value uses the
  *actual* simulated continuation of the chosen decision (:321-329) — using
  fitted values for both silently biases the NPV high.
- **Forward pass** is a second scan carrying per-sim inventory, re-applying
  the saved regression coefficients (with their standardization constants) to
  the independent valuation path set (:374-562), accumulating per-sim panels,
  per-period deltas and trigger prices.
- **Distribution-ready**: sims are the batch axis everywhere; under a
  path-sharded mesh the Gram/cross products and all means become cross-shard
  ``psum`` reductions that XLA inserts automatically (see
  :mod:`storage_tpu.parallel`).

Deviations from the reference (documented design choices):

- Per-period grids are fixed-count linspace over the reduced inventory space
  rather than global-spacing ragged grids (see ``compile.py`` note).
- The end-period terminal PV uses the **valuation** path set's end-period spot
  prices; the reference reads the regression sims there
  (``LsmcStorageValuation.cs:567``) even though the forward inventory paths
  came from the valuation sims.
"""
from __future__ import annotations

import logging
import os
from functools import partial
from typing import Callable, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..compile import ValuationContext
from ..exceptions import StorageError
from ..ops.interp import fractional_index
from ..ops.regression import BasisSpec, design_matrix, fit_continuation, standardize_columns
from .common import step_economics

NUM_TRIGGER_VOLUMES = 10  # reference numTriggerPriceVolumes (LsmcStorageValuation.cs:367)
BACKWARD_PCNT_TIME = 0.66  # reference progress weighting (LsmcStorageValuation.cs:46)


class ValuationCancelledError(StorageError):
    """Raised when a cancellation callback requests a stop (reference:
    ``CancellationToken.ThrowIfCancellationRequested``, :339, :490)."""


PANEL_FIELDS = (
    "inventory",  # pre-decision inventory per period
    "inject_withdraw",
    "cmdty_consumed",
    "inventory_loss",
    "net_volume",
    "period_pv",
)


class LsmcArrays(NamedTuple):
    """Raw device outputs of one LSMC run (engine-level, pre-pandas)."""

    npv: jax.Array  # scalar — forward (lower-bound) estimate
    backward_npv: jax.Array  # scalar — backward estimate, diagnostic
    deltas: jax.Array  # [n+1] (last entry 0)
    profile_means: jax.Array  # [n+1, 6] per-period sim-means of PANEL_FIELDS
    panels: jax.Array  # [n+1, 6, S] per-sim panels ([n+1, 6, 0] when not collected)
    pv_by_sim: jax.Array  # [S]
    trigger_has_inject: jax.Array  # [n] bool
    trigger_has_withdraw: jax.Array  # [n] bool
    trigger_inject_volumes: jax.Array  # [n, 10]
    trigger_inject_prices: jax.Array  # [n, 10]
    trigger_withdraw_volumes: jax.Array  # [n, 10] (ordered |vol| increasing)
    trigger_withdraw_prices: jax.Array  # [n, 10]


class LsmcDeviceInputs(NamedTuple):
    """Static-shape device arrays compiled from a :class:`ValuationContext`.

    A NamedTuple (pytree) so the whole bundle can flow through a single jit.
    """

    grids: jax.Array  # [n+1, G]
    space_lo: jax.Array  # [n+1]
    space_hi: jax.Array  # [n+1]
    pillars: jax.Array  # [n, P, 3]
    loss: jax.Array  # [n]
    inject_cost: jax.Array
    withdraw_cost: jax.Array
    cons_inject: jax.Array
    cons_withdraw: jax.Array
    inv_cost_rate: jax.Array
    df_settle: jax.Array
    df_start: jax.Array
    fwd: jax.Array  # [n+1]
    inventory: jax.Array  # scalar


def device_inputs(ctx: ValuationContext, dtype) -> LsmcDeviceInputs:
    return LsmcDeviceInputs(
        grids=jnp.asarray(ctx.grids, dtype),
        space_lo=jnp.asarray(ctx.inv_space.min_inventory, dtype),
        space_hi=jnp.asarray(ctx.inv_space.max_inventory, dtype),
        pillars=jnp.asarray(ctx.pillars, dtype),
        loss=jnp.asarray(ctx.inventory_loss, dtype),
        inject_cost=jnp.asarray(ctx.inject_cost, dtype),
        withdraw_cost=jnp.asarray(ctx.withdraw_cost, dtype),
        cons_inject=jnp.asarray(ctx.cons_inject, dtype),
        cons_withdraw=jnp.asarray(ctx.cons_withdraw, dtype),
        inv_cost_rate=jnp.asarray(ctx.inventory_cost_rate, dtype),
        df_settle=jnp.asarray(ctx.df_settle, dtype),
        df_start=jnp.asarray(ctx.df_cost, dtype),
        fwd=jnp.asarray(ctx.fwd, dtype),
        inventory=jnp.asarray(ctx.inventory, dtype),
    )


# --------------------------------------------------------------------------- #
# Backward induction                                                          #
# --------------------------------------------------------------------------- #


def spot_from_factors(factors_k, vols_k, drift_k):
    """Spot prices from factor states: ``exp(drift + vols . Y)``.

    Inverse of storing simulated spot panels — the spot is a deterministic
    per-period transform of the Markov states (see
    :mod:`storage_tpu.models.simulation`), so engines recompute it in-body
    instead of carrying an extra ``[n, S]`` array.
    """
    log_spot = (
        jnp.einsum("f,fs->s", vols_k, factors_k, precision=jax.lax.Precision.HIGHEST)
        + drift_k
    )
    return jnp.exp(log_spot)


def _backward_step_core(
    v_next,  # [S, G]
    spot,  # [S]
    factors,  # [F, S]
    grid,  # [G]
    next_lo,
    next_hi,
    pillars,
    loss,
    inject_cost,
    withdraw_cost,
    cons_inject,
    cons_withdraw,
    inv_cost_rate,
    df_settle,
    df_start,
    *,
    spec: BasisSpec,
    interp_kind: int,
    num_grid_points: int,
    extra_decisions: int,
):
    """One backward-induction period (reference :166-340).

    Returns ``(v_this [S, G], coeffs [B, G], mean [B], scale [B], vbar [G])``.
    """
    X = design_matrix(spec, spot, factors)
    Xs, mu, sd = standardize_columns(X)
    # Centre the regression target: continuation values carry the cumulated
    # storage value (magnitudes >> their spread), and f32 accumulation of
    # X^T V over 10^5-10^6 paths loses enough mantissa to visibly degrade the
    # fitted policy.  Regressing (V - mean) and
    # adding the mean back bounds accumulation magnitudes by the spread.
    vbar = jnp.mean(v_next, axis=0)  # [G]
    coeffs = fit_continuation(Xs, v_next - vbar)  # [B, G]
    fitted = jnp.dot(
        Xs, coeffs, preferred_element_type=Xs.dtype,
        precision=jax.lax.Precision.HIGHEST,
    ) + vbar  # [S, G]

    econ = step_economics(
        grid, pillars, interp_kind, loss, next_lo, next_hi,
        inject_cost, withdraw_cost, cons_inject, cons_withdraw,
        inv_cost_rate, df_settle, df_start, extra_decisions,
    )
    # [G, D] indices/weights onto the next period's grid columns: exact
    # linear interpolation, like the reference.
    j, w = fractional_index(econ.inventory_after, next_lo, next_hi, num_grid_points)

    num_decisions = econ.decisions.shape[-1]
    best_fitted_total = None
    best_actual_total = None
    for d in range(num_decisions):  # static small D: keeps peak memory at O(S*G)
        j_d, w_d = j[:, d], w[:, d]
        # Interpolation as a matmul: the query points depend only on the
        # grid geometry (not on sims), so each decision's linear-interp is a
        # [G_next, G] two-nonzeros-per-column matrix shared by every path.
        interp_w = (
            jax.nn.one_hot(j_d, num_grid_points, dtype=v_next.dtype) * (1.0 - w_d)[:, None]
            + jax.nn.one_hot(j_d + 1, num_grid_points, dtype=v_next.dtype) * w_d[:, None]
        ).T  # [G_next, G]
        fitted_cont = jnp.dot(
            fitted, interp_w, preferred_element_type=v_next.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )  # [S, G]
        actual_cont = jnp.dot(
            v_next, interp_w, preferred_element_type=v_next.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
        immediate = econ.price_coeff[None, :, d] * spot[:, None] - econ.cost_npv[None, :, d]
        total_fitted = immediate + fitted_cont
        # Lower-bound estimator: realised value of the chosen decision uses the
        # ACTUAL simulated continuation (reference :321-329).  Decision 0 seeds
        # the running argmax unconditionally so a non-finite comparison can
        # never leave the carried values at a bogus initialiser.
        if best_fitted_total is None:
            best_fitted_total = total_fitted
            best_actual_total = immediate + actual_cont
        else:
            better = total_fitted > best_fitted_total
            best_fitted_total = jnp.where(better, total_fitted, best_fitted_total)
            best_actual_total = jnp.where(better, immediate + actual_cont, best_actual_total)
    return best_actual_total, coeffs, mu, sd, vbar


@partial(
    jax.jit,
    static_argnames=(
        "spec", "interp_kind", "num_grid_points", "extra_decisions",
    ),
)
def backward_scan(
    v_init,  # [S, G] value at the period AFTER the last one in this chunk
    factors,  # [m, F, S] Markov factor states
    sim_vols,  # [m, F] spot vol loadings sigma_i(t_k)
    sim_drift,  # [m] ln F(0,t_k) - V_k/2
    grids,  # [m, G] grid of each period in the chunk
    next_lo,  # [m]
    next_hi,  # [m]
    pillars,  # [m, P, 3]
    loss,
    inject_cost,
    withdraw_cost,
    cons_inject,
    cons_withdraw,
    inv_cost_rate,
    df_settle,
    df_start,
    spec: BasisSpec,
    interp_kind: int,
    num_grid_points: int,
    extra_decisions: int,
):
    """Reverse scan over a chunk of periods.  Inputs are time-ordered; the scan
    runs backwards.  Returns final carry + per-period regression data."""

    def step(v_next, xs):
        (f, vols, drift, grid, lo, hi, pil, lo_r, ic, wc, ci, cw, icr, dfs, df0) = xs
        # Spot prices are a deterministic transform of the factor states:
        # recomputing them in-body saves an [m, S] array and its memory traffic.
        spot = spot_from_factors(f, vols, drift)
        v_this, coeffs, mu, sd, vbar = _backward_step_core(
            v_next, spot, f, grid, lo, hi, pil, lo_r, ic, wc, ci, cw, icr, dfs, df0,
            spec=spec, interp_kind=interp_kind,
            num_grid_points=num_grid_points, extra_decisions=extra_decisions,
        )
        return v_this, (coeffs, mu, sd, vbar)

    xs = (
        factors, sim_vols, sim_drift, grids, next_lo, next_hi, pillars, loss,
        inject_cost, withdraw_cost, cons_inject, cons_withdraw, inv_cost_rate,
        df_settle, df_start,
    )
    v_final, (coeffs, mu, sd, vbar) = jax.lax.scan(step, v_init, xs, reverse=True)
    return v_final, coeffs, mu, sd, vbar


# --------------------------------------------------------------------------- #
# Forward simulation                                                          #
# --------------------------------------------------------------------------- #


def _trigger_calc(
    mean_cont,  # [G] sim-average fitted continuation on the next grid
    expected_inventory,
    pillars,
    interp_kind,
    loss_rate,
    next_lo,
    next_hi,
    inject_cost,
    withdraw_cost,
    cons_inject,
    cons_withdraw,
    inv_cost_rate,
    df_settle,
    df_start,
    num_grid_points,
    extra_decisions,
):
    """Trigger-price ladders at the expected inventory (reference :492-561).

    Trigger price p solves  ΔContinuation − ΔCost = p · df · (ΔVolume + ΔConsumed)
    between a candidate volume and the 'alternative' (usually zero) decision.
    """
    econ = step_economics(
        jnp.reshape(expected_inventory, (1,)), pillars, interp_kind, loss_rate,
        next_lo, next_hi, inject_cost, withdraw_cost, cons_inject, cons_withdraw,
        inv_cost_rate, df_settle, df_start, extra_decisions,
    )
    decisions = econ.decisions[0]  # [D]
    loss_amt = loss_rate * expected_inventory
    max_inject = jnp.max(decisions)
    max_withdraw = jnp.min(decisions)
    big = jnp.asarray(jnp.finfo(decisions.dtype).max, decisions.dtype)
    alt_inject = jnp.min(jnp.where(decisions >= 0.0, decisions, big))
    alt_withdraw = jnp.max(jnp.where(decisions <= 0.0, decisions, -big))

    def cont_at(volume):
        after = expected_inventory + volume - loss_amt
        j, w = fractional_index(after, next_lo, next_hi, num_grid_points)
        return jnp.take(mean_cont, j) * (1.0 - w) + jnp.take(mean_cont, j + 1) * w

    def cost_of(volume):
        return jnp.where(
            volume > 0.0, inject_cost * volume, withdraw_cost * (-volume)
        ) * df_start

    def consumed_of(volume):
        return jnp.where(volume > 0.0, cons_inject * volume, cons_withdraw * (-volume))

    def trigger_price(volumes, alt):
        d_cont = cont_at(volumes) - cont_at(alt)
        d_cost = cost_of(volumes) - cost_of(alt)
        d_consumed = consumed_of(volumes) - consumed_of(alt)
        denom = df_settle * (volumes - alt + d_consumed)
        # Zero headroom (volumes == alt) makes the denominator exactly 0; the
        # has_inject/has_withdraw masks hide those rows downstream, but the
        # raw arrays are engine outputs too — emit 0 instead of NaN/Inf so
        # consumers (and jax_debug_nans) never see a poisoned value.
        safe = jnp.where(denom != 0.0, denom, 1.0)
        return jnp.where(denom != 0.0, (d_cont - d_cost) / safe, 0.0)

    steps = jnp.arange(1, NUM_TRIGGER_VOLUMES + 1, dtype=decisions.dtype)
    inject_volumes = alt_inject + steps * (max_inject - alt_inject) / NUM_TRIGGER_VOLUMES
    inject_prices = trigger_price(inject_volumes, alt_inject)
    has_inject = (max_inject > 0.0) & (max_inject > alt_inject)

    withdraw_volumes = alt_withdraw + steps * (max_withdraw - alt_withdraw) / NUM_TRIGGER_VOLUMES
    withdraw_prices = trigger_price(withdraw_volumes, alt_withdraw)
    has_withdraw = (max_withdraw < 0.0) & (max_withdraw < alt_withdraw)
    return (
        has_inject, inject_volumes, inject_prices,
        has_withdraw, withdraw_volumes, withdraw_prices,
    )


def dense_continuation(cont):
    """Continuation accessors for a dense per-sim matrix ``[S, G]``."""

    def cont_at(j, w):  # j, w: [S, D]
        return jnp.take_along_axis(cont, j, axis=1) * (1.0 - w) + jnp.take_along_axis(
            cont, j + 1, axis=1
        ) * w

    def cont_mean():
        return jnp.mean(cont, axis=0)

    return cont_at, cont_mean


def regression_continuation(Xn1, table):
    """Continuation accessors from regression data without materialising the
    per-sim ``[S, G]`` matrix.

    ``Xn1 [S, B+1]`` is the standardized design matrix with a ones column;
    ``table [G, B+1]`` stacks the per-grid coefficient columns with the
    centring constant.  Evaluating only at the D per-sim query points replaces
    an [S, G] materialisation per step with small-table gathers and an
    einsum, and the trigger-price mean continuation comes from
    the design-matrix column means alone.
    """

    def cont_at(j, w):  # j, w: [S, D]
        lo = jnp.take(table, j, axis=0)  # [S, D, B+1]
        hi = jnp.take(table, j + 1, axis=0)
        eff = lo * (1.0 - w)[..., None] + hi * w[..., None]
        return jnp.einsum(
            "sb,sdb->sd", Xn1, eff, precision=jax.lax.Precision.HIGHEST
        )

    def cont_mean():
        return jnp.dot(
            table, jnp.mean(Xn1, axis=0), preferred_element_type=table.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )  # [G]

    return cont_at, cont_mean


def _forward_step_core(
    carry,
    spot,  # [S]
    cont,  # (cont_at, cont_mean) accessor pair — see dense/regression_continuation
    next_lo,
    next_hi,
    pillars,
    loss_rate,
    inject_cost,
    withdraw_cost,
    cons_inject,
    cons_withdraw,
    inv_cost_rate,
    df_settle,
    df_start,
    fwd_price,
    discount_for_deltas,
    *,
    interp_kind: int,
    num_grid_points: int,
    extra_decisions: int,
    collect_panels: bool = True,
):
    """One forward-simulation period (reference :374-490)."""
    cont_at, cont_mean_fn = cont
    inv, pv = carry
    econ = step_economics(
        inv, pillars, interp_kind, loss_rate, next_lo, next_hi,
        inject_cost, withdraw_cost, cons_inject, cons_withdraw,
        inv_cost_rate, df_settle, df_start, extra_decisions,
    )  # decision axis last: [S, D]
    j, w = fractional_index(econ.inventory_after, next_lo, next_hi, num_grid_points)
    cont_d = cont_at(j, w)  # [S, D]
    immediate = econ.immediate_npv(spot[:, None])  # [S, D]
    total = immediate + cont_d
    best = jnp.argmax(total, axis=1)  # [S] first-occurrence argmax like reference

    take = lambda arr: jnp.take_along_axis(arr, best[:, None], axis=1)[:, 0]
    volume = take(econ.decisions)
    consumed = take(econ.consumed)
    imm_pv = take(immediate)
    loss_amt = loss_rate * inv
    new_inv = inv + volume - loss_amt
    new_pv = pv + imm_pv

    net_volume = -volume - consumed
    delta = jnp.mean(net_volume * spot) / fwd_price * discount_for_deltas

    mean_cont = cont_mean_fn()  # [G] for trigger prices
    expected_inventory = jnp.mean(inv)
    triggers = _trigger_calc(
        mean_cont, expected_inventory, pillars, interp_kind, loss_rate,
        next_lo, next_hi, inject_cost, withdraw_cost, cons_inject, cons_withdraw,
        inv_cost_rate, df_settle, df_start, num_grid_points, extra_decisions,
    )
    fields = (inv, volume, consumed, loss_amt, net_volume, imm_pv)
    means = jnp.stack(
        [expected_inventory] + [jnp.mean(x) for x in fields[1:]]
    )  # [6], PANEL_FIELDS order
    if collect_panels:
        rows = jnp.stack(fields)  # [6, S]
    else:
        rows = jnp.zeros((6, 0), inv.dtype)
    outputs = (means, delta, rows) + triggers
    return (new_inv, new_pv), outputs


@partial(
    jax.jit,
    static_argnames=(
        "spec", "interp_kind", "num_grid_points", "extra_decisions", "collect_panels",
    ),
)
def forward_scan(
    carry,
    factors,  # [m, F, S]
    sim_vols,  # [m, F]
    sim_drift,  # [m]
    coeffs,  # [m, B, G]
    mus,  # [m, B]
    sds,  # [m, B]
    vbars,  # [m, G]
    next_lo,  # [m]
    next_hi,  # [m]
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
    discount_for_deltas,  # [m]
    spec: BasisSpec,
    interp_kind: int,
    num_grid_points: int,
    extra_decisions: int,
    collect_panels: bool = True,
):
    def step(carry, xs):
        (f, vols, drift, cf, mu, sd, vbar, lo, hi, pil, lr, ic, wc, ci, cw, icr, dfs, df0, fp, dd) = xs
        spot = spot_from_factors(f, vols, drift)
        X = design_matrix(spec, spot, f)
        Xn = (X - mu) / sd
        Xn1 = jnp.concatenate([Xn, jnp.ones((Xn.shape[0], 1), Xn.dtype)], axis=1)
        table = jnp.concatenate([cf.T, vbar[:, None]], axis=1)  # [G, B+1]
        cont = regression_continuation(Xn1, table)
        return _forward_step_core(
            carry, spot, cont, lo, hi, pil, lr, ic, wc, ci, cw, icr, dfs, df0, fp, dd,
            interp_kind=interp_kind, num_grid_points=num_grid_points,
            extra_decisions=extra_decisions, collect_panels=collect_panels,
        )

    xs = (
        factors, sim_vols, sim_drift, coeffs, mus, sds, vbars, next_lo, next_hi,
        pillars, loss, inject_cost, withdraw_cost, cons_inject, cons_withdraw,
        inv_cost_rate, df_settle, df_start, fwd, discount_for_deltas,
    )
    return jax.lax.scan(step, carry, xs)


# --------------------------------------------------------------------------- #
# Engine driver                                                               #
# --------------------------------------------------------------------------- #


def _chunk_bounds(n: int, num_chunks: int) -> List[Tuple[int, int]]:
    """Split range(n) into at most num_chunks contiguous spans (for progress
    reporting between jitted scan chunks)."""
    num_chunks = max(1, min(num_chunks, n))
    edges = np.linspace(0, n, num_chunks + 1).astype(int)
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:]) if b > a]


def _check_backward_health(coeffs, vbars, fwd=None) -> None:
    """Cheap post-run probe for a silently wrong value surface: non-finite
    values, or a surface that is zero in every period.  ``vbars`` (the
    per-period sim-means of the value surface) is the right signal for both
    probes — unlike the regression coefficients it is never NaN-sanitised
    upstream, so a numerical blow-up actually reaches it.  Three device-side
    reductions, one fetch — no material cost at any scale.

    The whole horizon runs as one scan.  On the H100 a single 341-step scan
    at 1M paths x 100 grid points gave value-surface means bit-equal to the
    same scan split into 10-step sub-scans (PERF.md); this probe stays as the
    guard should a backend ever zero a long scan's carry.

    A genuinely worthless facility (zero value at every grid point of every
    period) trips the same signature; when ``fwd`` (the forward curve the
    valuation ran against) is given and is itself identically zero, the zero
    surface is recognised as legitimate and only warned about.  For non-zero
    curves, set ``STORAGE_TPU_ALLOW_ZERO_SURFACE=1`` to downgrade the error
    to a warning (e.g. a facility whose costs exceed every spread).
    """
    fwd_zero = fwd is not None and not np.any(np.asarray(fwd))
    finite_c, finite_v, nonzero_v = np.asarray(
        jnp.stack([
            jnp.all(jnp.isfinite(coeffs)).astype(jnp.float32),
            jnp.all(jnp.isfinite(vbars)).astype(jnp.float32),
            jnp.any(vbars != 0.0).astype(jnp.float32) if vbars.size
            else jnp.asarray(1.0, jnp.float32),
        ])
    )
    if not (finite_c and finite_v):
        raise StorageError(
            "Backward induction produced non-finite values "
            f"(regression coefficients finite: {bool(finite_c)}, value-surface "
            f"means finite: {bool(finite_v)}); this indicates a numerical "
            "failure in the backward scan."
        )
    if vbars.size and not nonzero_v:
        msg = (
            "Backward induction value surface is identically zero for every "
            "period although the forward curve is not — the signature of a "
            "zeroed scan carry; a silently-wrong NPV must not be returned. "
            "Set STORAGE_TPU_ALLOW_ZERO_SURFACE=1 if this facility is "
            "genuinely worthless (zero value at every state)."
        )
        if fwd_zero or os.environ.get("STORAGE_TPU_ALLOW_ZERO_SURFACE"):
            logging.getLogger("storage_tpu.lsmc").warning(msg)
        else:
            raise StorageError(msg)


def _check_forward_health(pv, inv_final, backward_npv) -> None:
    """Forward-side twin of :func:`_check_backward_health`: a zeroed scan
    carry would bring the per-sim PV vector back all-zero, and a numerical
    failure non-finite.  Legitimately zero-PV runs are distinguished two
    ways: (a) when the backward pass itself valued the store at ~0, a zero
    forward PV is expected; (b) a facility whose value is entirely TERMINAL
    (do-nothing optimal at every step with a ``terminal_storage_npv``) has
    zero decision PV but a non-zero backward estimate — there the final
    inventory equals the (non-zero) starting inventory, whereas a zeroed
    carry zeroes inventory too.  Only the pv-zero AND inventory-zero AND
    backward-non-zero combination raises.  One stacked fetch, same cost
    posture as the backward probe.
    """
    finite_p, nonzero_p, inv_nonzero_p, back_zero = np.asarray(
        jnp.stack([
            jnp.all(jnp.isfinite(pv)).astype(jnp.float32),
            jnp.any(pv != 0.0).astype(jnp.float32),
            jnp.any(inv_final != 0.0).astype(jnp.float32),
            (jnp.abs(backward_npv) < 1e-9).astype(jnp.float32),
        ])
    )
    if not finite_p:
        raise StorageError(
            "Forward simulation produced non-finite per-simulation PVs; this "
            "indicates a numerical failure in the forward scan."
        )
    if pv.size and not nonzero_p and not inv_nonzero_p and not back_zero:
        msg = (
            "Forward simulation PV and inventory paths are identically zero "
            "while the backward estimate is not — the signature of a zeroed "
            "scan carry; a silently-wrong NPV must not be returned. Set "
            "STORAGE_TPU_ALLOW_ZERO_SURFACE=1 to downgrade to a warning."
        )
        if os.environ.get("STORAGE_TPU_ALLOW_ZERO_SURFACE"):
            logging.getLogger("storage_tpu.lsmc").warning(msg)
        else:
            raise StorageError(msg)


def _backward_scan_span(v, factors, sim_vols, sim_drift, dev, lo_k, hi_k, **static):
    """``backward_scan`` over decision steps ``[lo_k, hi_k)`` of the horizon;
    the path arrays are already sliced to that span."""
    return backward_scan(
        v, factors, sim_vols, sim_drift,
        dev.grids[lo_k:hi_k],
        dev.space_lo[lo_k + 1 : hi_k + 1],
        dev.space_hi[lo_k + 1 : hi_k + 1],
        dev.pillars[lo_k:hi_k],
        dev.loss[lo_k:hi_k],
        dev.inject_cost[lo_k:hi_k],
        dev.withdraw_cost[lo_k:hi_k],
        dev.cons_inject[lo_k:hi_k],
        dev.cons_withdraw[lo_k:hi_k],
        dev.inv_cost_rate[lo_k:hi_k],
        dev.df_settle[lo_k:hi_k],
        dev.df_start[lo_k:hi_k],
        **static,
    )


def _backward_program(
    reg_factors,  # [m, F, S] simulated periods only
    sim_vols,  # [m, F]
    sim_drift,  # [m]
    dev: LsmcDeviceInputs,
    spec: BasisSpec,
    interp_kind: int,
    num_grid_points: int,
    extra_decisions: int,
    val_first: bool,
    terminal_fn,
):
    """Backward induction as one XLA program: one reverse scan over the
    whole horizon.

    Returns ``(backward_npv, cont_mean0 [G], coeffs [m,B,G], mus, sds, vbars)``.
    ``cont_mean0`` is the current-period mean continuation when ``val_first``
    (reference :171-181), else zeros (unused).
    """
    G = num_grid_points
    num_sims = reg_factors.shape[-1]
    dtype = reg_factors.dtype
    n = reg_factors.shape[0] - 1 + (1 if val_first else 0)  # total decision steps
    first = 1 if val_first else 0

    # Terminal values on the end-period grid (reference :107-128), computed on
    # the regression path set like the backward induction itself.
    if terminal_fn is None:
        v_end = jnp.zeros((num_sims, G), dtype=dtype)
    else:
        end_spots = spot_from_factors(reg_factors[-1], sim_vols[-1], sim_drift[-1])
        v_end = jnp.asarray(
            terminal_fn(end_spots[:, None], dev.grids[n][None, :]), dtype
        )
        v_end = jnp.broadcast_to(v_end, (num_sims, G))

    m = reg_factors.shape[0] - 1  # simulated decision steps
    v, coeffs, mus, sds, vbars = _backward_scan_span(
        v_end, reg_factors[:m], sim_vols[:m], sim_drift[:m], dev, first, n,
        spec=spec, interp_kind=interp_kind,
        num_grid_points=G, extra_decisions=extra_decisions,
    )

    if val_first:
        v0, cont_mean0 = _current_period_step(
            v, dev, interp_kind, G, extra_decisions, dtype
        )
        backward_npv = jnp.mean(v0)
    else:
        cont_mean0 = jnp.zeros((G,), dtype)
        backward_npv = jnp.mean(v[:, 0])
    return backward_npv, cont_mean0, coeffs, mus, sds, vbars


def _forward_step0(carry, cont_mean0, dev, dfd0, *, interp_kind,
                   num_grid_points, extra_decisions, collect_panels):
    """Deterministic current-period forward step (reference :382-413): the
    price is the forward and the continuation the sim-average."""
    num_sims = carry[0].shape[0]
    cont0 = dense_continuation(
        jnp.broadcast_to(cont_mean0[None, :], (num_sims, num_grid_points))
    )
    spot0 = jnp.full((num_sims,), dev.fwd[0])
    carry, outputs0 = _forward_step_core(
        carry, spot0, cont0,
        dev.space_lo[1], dev.space_hi[1],
        dev.pillars[0], dev.loss[0],
        dev.inject_cost[0], dev.withdraw_cost[0],
        dev.cons_inject[0], dev.cons_withdraw[0],
        dev.inv_cost_rate[0], dev.df_settle[0], dev.df_start[0],
        dev.fwd[0], dfd0,
        interp_kind=interp_kind, num_grid_points=num_grid_points,
        extra_decisions=extra_decisions, collect_panels=collect_panels,
    )
    return carry, jax.tree.map(lambda x: x[None], outputs0)


def _forward_scan_span(carry, factors, sim_vols, sim_drift, coeffs, mus, sds,
                       vbars, dev, dfd, lo_k, hi_k, **static):
    """``forward_scan`` over decision steps ``[lo_k, hi_k)`` of the horizon;
    the path/regression arrays are already sliced to that span."""
    return forward_scan(
        carry, factors, sim_vols, sim_drift, coeffs, mus, sds, vbars,
        dev.space_lo[lo_k + 1 : hi_k + 1],
        dev.space_hi[lo_k + 1 : hi_k + 1],
        dev.pillars[lo_k:hi_k],
        dev.loss[lo_k:hi_k],
        dev.inject_cost[lo_k:hi_k],
        dev.withdraw_cost[lo_k:hi_k],
        dev.cons_inject[lo_k:hi_k],
        dev.cons_withdraw[lo_k:hi_k],
        dev.inv_cost_rate[lo_k:hi_k],
        dev.df_settle[lo_k:hi_k],
        dev.df_start[lo_k:hi_k],
        dev.fwd[lo_k:hi_k],
        dfd[lo_k:hi_k],
        **static,
    )


def _forward_program(
    val_factors,  # [m, F, S] simulated periods only
    sim_vols,  # [m, F]
    sim_drift,  # [m]
    cont_mean0,  # [G]
    coeffs,  # [m-?, B, G] per simulated decision step
    mus,
    sds,
    vbars,
    dev: LsmcDeviceInputs,
    backward_npv,
    spec: BasisSpec,
    interp_kind: int,
    num_grid_points: int,
    extra_decisions: int,
    val_first: bool,
    terminal_fn,
    discount_deltas: bool,
    collect_panels: bool,
) -> LsmcArrays:
    """Forward policy simulation + result assembly as one XLA program."""
    G = num_grid_points
    num_sims = val_factors.shape[-1]
    dtype = val_factors.dtype
    n = val_factors.shape[0] - 1 + (1 if val_first else 0)
    first = 1 if val_first else 0

    dfd = dev.df_settle if discount_deltas else jnp.ones_like(dev.df_settle)
    inv0 = jnp.full((num_sims,), dev.inventory, dtype)
    pv0 = jnp.zeros((num_sims,), dtype)
    carry = (inv0, pv0)
    out_parts = []

    if val_first:
        carry, outputs0 = _forward_step0(
            carry, cont_mean0, dev, dfd[0], interp_kind=interp_kind,
            num_grid_points=G, extra_decisions=extra_decisions,
            collect_panels=collect_panels,
        )
        out_parts.append(outputs0)

    m = val_factors.shape[0] - 1
    carry, outputs = _forward_scan_span(
        carry, val_factors[:m], sim_vols[:m], sim_drift[:m], coeffs[:m],
        mus[:m], sds[:m], vbars[:m], dev, dfd, first, n,
        spec=spec, interp_kind=interp_kind, num_grid_points=G,
        extra_decisions=extra_decisions, collect_panels=collect_panels,
    )
    out_parts.append(outputs)

    stacked = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *out_parts)
    end_spots = spot_from_factors(val_factors[-1], sim_vols[-1], sim_drift[-1])
    return _assemble_arrays(
        stacked, carry, end_spots, terminal_fn, backward_npv, dtype, collect_panels
    )


def _assemble_arrays(
    stacked, carry, end_spots, terminal_fn, backward_npv, dtype, collect_panels
) -> LsmcArrays:
    (
        means_rows,  # [n, 6] per-step means: inv, volume, consumed, loss, net, pv
        deltas_rows,
        rows,  # [n, 6, S] per-sim panels, or [n, 6, 0] when not collected
        has_inj, inj_vols, inj_prices, has_wdr, wdr_vols, wdr_prices,
    ) = stacked
    inv_final, pv_by_sim = carry
    num_sims = inv_final.shape[0]

    # ---- End-period terminal PV (reference :563-579; valuation sims here,
    # see module docstring) ---- #
    if terminal_fn is not None:
        terminal_pv = jnp.asarray(terminal_fn(end_spots, inv_final), dtype)
        terminal_pv = jnp.broadcast_to(terminal_pv, (num_sims,))
    else:
        terminal_pv = jnp.zeros((num_sims,), dtype)
    pv_by_sim = pv_by_sim + terminal_pv

    end_means = jnp.stack(
        [jnp.mean(inv_final), 0.0, 0.0, 0.0, 0.0, jnp.mean(terminal_pv)]
    ).astype(dtype)
    profile_means = jnp.concatenate([means_rows, end_means[None]], axis=0)

    if collect_panels:
        end_rows = jnp.stack(
            [
                inv_final,
                jnp.zeros_like(inv_final),
                jnp.zeros_like(inv_final),
                jnp.zeros_like(inv_final),
                jnp.zeros_like(inv_final),
                terminal_pv,
            ]
        )  # [6, S]
        panels = jnp.concatenate([rows, end_rows[None]], axis=0)  # [n+1, 6, S]
    else:
        panels = jnp.zeros((profile_means.shape[0], 6, 0), dtype)

    return LsmcArrays(
        npv=jnp.mean(pv_by_sim),
        backward_npv=backward_npv,
        deltas=jnp.concatenate([deltas_rows, jnp.zeros((1,), dtype)], axis=0),
        profile_means=profile_means,
        panels=panels,
        pv_by_sim=pv_by_sim,
        trigger_has_inject=has_inj,
        trigger_has_withdraw=has_wdr,
        trigger_inject_volumes=inj_vols,
        trigger_inject_prices=inj_prices,
        trigger_withdraw_volumes=wdr_vols,
        trigger_withdraw_prices=wdr_prices,
    )


# NOTE on donation: the factor-path argument is live across the entire scan
# and the programs' outputs are grid-sized (nothing of the paths' shape), so
# donate_argnums could never alias it — XLA warns "donated buffers were not
# usable" and keeps the buffer pinned regardless.
_backward_program_jit = jax.jit(
    _backward_program,
    static_argnames=(
        "spec", "interp_kind", "num_grid_points", "extra_decisions",
        "val_first", "terminal_fn",
    ),
)

_forward_program_jit = jax.jit(
    _forward_program,
    static_argnames=(
        "spec", "interp_kind", "num_grid_points", "extra_decisions",
        "val_first", "terminal_fn", "discount_deltas", "collect_panels",
    ),
)


def _materialise(factory):
    """A simulation factory's path set (or the array passed in its place)."""
    return factory() if callable(factory) else factory


def run_lsmc(
    ctx: ValuationContext,
    reg_sims,  # callable () -> factors [m, F, S], or the array itself
    val_sims,  # callable () -> factors [m, F, S], or the array itself
    sim_vols,  # [m, F] spot-vol loadings per simulated period
    sim_drift,  # [m] ln F(0,t_k) - V_k/2 per simulated period
    spec: BasisSpec,
    discount_deltas: bool,
    extra_decisions: int = 0,
    dtype=jnp.float32,
    on_progress_update: Optional[Callable[[float], None]] = None,
    cancelled: Optional[Callable[[], bool]] = None,
    num_progress_chunks: int = 20,
    mesh=None,
    collect_panels: bool = True,
    stopwatches=None,
) -> LsmcArrays:
    """Run backward induction + forward simulation.

    ``reg_sims``/``val_sims`` are factories so the regression path set can be
    freed before the valuation set is simulated — at production path counts
    each set is GBs of device memory (reference simulates lazily per phase
    too, :100 and :346).

    The common case compiles to exactly two XLA programs (backward/forward).
    With progress/cancellation hooks the scans split into chunks with host
    callbacks between them (reference :337-339, :488-490).
    """
    dev = device_inputs(ctx, dtype)
    statics = dict(
        spec=spec,
        interp_kind=ctx.interp_kind,
        num_grid_points=ctx.num_grid_points,
        extra_decisions=extra_decisions,
        val_first=ctx.val_date_is_first_step,
        terminal_fn=ctx.storage.terminal_npv_fn,
    )

    def shard(factors):
        if mesh is None:
            return factors
        from ..parallel.mesh import shard_sims

        return shard_sims(mesh, factors, 2)

    sim_vols = jnp.asarray(sim_vols, dtype)
    sim_drift = jnp.asarray(sim_drift, dtype)

    from ..models.simulation import StreamingFactorSource

    chunked = on_progress_update is not None or cancelled is not None
    reg = _materialise(reg_sims)
    if chunked or isinstance(reg, StreamingFactorSource):
        # Streaming sources always take the chunked driver: factor paths are
        # re-simulated span-by-span there instead of materialising [m, F, S].
        return _run_lsmc_chunked(
            ctx, reg, val_sims, sim_vols, sim_drift, dev, spec, discount_deltas,
            extra_decisions, dtype, on_progress_update, cancelled,
            num_progress_chunks, mesh, collect_panels, stopwatches,
        )

    reg_factors = shard(reg)
    del reg
    if stopwatches is not None:
        stopwatches.start("BackwardInduction")
    backward_npv, cont_mean0, coeffs, mus, sds, vbars = _backward_program_jit(
        reg_factors, sim_vols, sim_drift, dev, **statics
    )
    jax.block_until_ready(coeffs)
    _check_backward_health(coeffs, vbars, ctx.fwd)
    if stopwatches is not None:
        stopwatches.stop("BackwardInduction")
    del reg_factors

    val_factors = shard(_materialise(val_sims))
    if stopwatches is not None:
        stopwatches.start("ForwardSimulation")
    arrays = _forward_program_jit(
        val_factors, sim_vols, sim_drift, cont_mean0, coeffs, mus, sds, vbars, dev,
        backward_npv,
        discount_deltas=discount_deltas, collect_panels=collect_panels, **statics
    )
    if stopwatches is not None:
        jax.block_until_ready(arrays.npv)
        stopwatches.stop("ForwardSimulation")
    return arrays


def _factor_access(factors_or_source, shard):
    """Uniform chunk access over a materialised ``[m+1, F, S]`` array or a
    :class:`~storage_tpu.models.simulation.StreamingFactorSource`.

    Returns ``(get(a, b), last(), num_sims, source_spans_or_None)``.
    """
    from ..models.simulation import StreamingFactorSource

    if isinstance(factors_or_source, StreamingFactorSource):
        src = factors_or_source
        return src.factors, src.last, src.num_sims, src.spans()
    arr = shard(factors_or_source)
    return (
        lambda a, b: arr[a:b],
        lambda: arr[-1],
        arr.shape[-1],
        None,
    )


def _scan_spans(m: int, num_chunks: int, source_spans):
    """Chunk [0, m) into scan spans.

    Without a streaming source this is :func:`_chunk_bounds`.  With one, the
    source's aligned spans are the chunks (each ``factors(a, b)`` call must
    stay within one span), trimmed to the ``m`` decision steps.
    """
    if source_spans is None:
        return _chunk_bounds(m, num_chunks)
    return [(a, min(b, m)) for a, b in source_spans if a < m]


def _run_lsmc_chunked(
    ctx, reg_sims, val_sims, sim_vols, sim_drift, dev, spec, discount_deltas,
    extra_decisions, dtype, on_progress_update, cancelled, num_progress_chunks,
    mesh, collect_panels, stopwatches=None,
) -> LsmcArrays:
    """Chunked variant: host progress/cancellation hooks between scan chunks,
    and span-by-span factor re-simulation when given streaming sources."""
    n = ctx.n_steps
    G = ctx.num_grid_points
    interp_kind = ctx.interp_kind
    terminal_fn = ctx.storage.terminal_npv_fn
    val_first = ctx.val_date_is_first_step
    first = 1 if val_first else 0

    def shard(factors):
        if mesh is None:
            return factors
        from ..parallel.mesh import shard_sims

        return shard_sims(mesh, factors, 2)

    def check_cancel():
        if cancelled is not None and cancelled():
            raise ValuationCancelledError("Storage valuation was cancelled.")

    def report(frac):
        if on_progress_update is not None:
            on_progress_update(frac)

    if stopwatches is not None:
        stopwatches.start("BackwardInduction")
    reg = _materialise(reg_sims)
    reg_fac, reg_last, num_sims, reg_spans = _factor_access(reg, shard)

    if terminal_fn is None:
        v_end = jnp.zeros((num_sims, G), dtype=dtype)
    else:
        end_spots = spot_from_factors(reg_last(), sim_vols[-1], sim_drift[-1])
        v_end = jnp.asarray(
            terminal_fn(end_spots[:, None], dev.grids[n][None, :]), dtype
        )
        v_end = jnp.broadcast_to(v_end, (num_sims, G))

    static = dict(
        spec=spec, interp_kind=interp_kind,
        num_grid_points=G, extra_decisions=extra_decisions,
    )
    m = n - first  # simulated decision steps

    spans = _scan_spans(m, num_progress_chunks, reg_spans)
    v = v_end
    coeffs_parts: List[jax.Array] = []
    mu_parts: List[jax.Array] = []
    sd_parts: List[jax.Array] = []
    vbar_parts: List[jax.Array] = []
    total_back = max(1, len(spans))
    for i, (a, b) in enumerate(reversed(spans)):
        v, coeffs_c, mu_c, sd_c, vbar_c = _backward_scan_span(
            v, reg_fac(a, b), sim_vols[a:b], sim_drift[a:b], dev,
            first + a, first + b, **static,
        )
        coeffs_parts.insert(0, coeffs_c)
        mu_parts.insert(0, mu_c)
        sd_parts.insert(0, sd_c)
        vbar_parts.insert(0, vbar_c)
        check_cancel()
        report(BACKWARD_PCNT_TIME * (i + 1) / total_back)
    coeffs = jnp.concatenate(coeffs_parts, axis=0)
    mus = jnp.concatenate(mu_parts, axis=0)
    sds = jnp.concatenate(sd_parts, axis=0)
    vbars = jnp.concatenate(vbar_parts, axis=0)
    _check_backward_health(coeffs, vbars, ctx.fwd)

    if val_first:
        v0, cont_mean0 = _current_period_step(
            v, dev, interp_kind, G, extra_decisions, dtype
        )
        backward_npv = jnp.mean(v0)
    else:
        cont_mean0 = jnp.zeros((G,), dtype)
        backward_npv = jnp.mean(v[:, 0])
    del v, reg, reg_fac, reg_last
    if stopwatches is not None:
        jax.block_until_ready(coeffs)
        stopwatches.stop("BackwardInduction")
        stopwatches.start("ForwardSimulation")

    val = _materialise(val_sims)
    val_fac, val_last, _, val_spans = _factor_access(val, shard)

    dfd = dev.df_settle if discount_deltas else jnp.ones_like(dev.df_settle)
    fwd_spans = _scan_spans(m, num_progress_chunks, val_spans)
    total_fwd = max(1, len(fwd_spans))

    inv0 = jnp.full((num_sims,), dev.inventory, dtype)
    pv0 = jnp.zeros((num_sims,), dtype)
    carry = (inv0, pv0)
    out_parts = []

    if val_first:
        carry, outputs0 = _forward_step0(
            carry, cont_mean0, dev, dfd[0], interp_kind=interp_kind,
            num_grid_points=G, extra_decisions=extra_decisions,
            collect_panels=collect_panels,
        )
        out_parts.append(outputs0)

    for i, (a, b) in enumerate(fwd_spans):
        carry, outputs = _forward_scan_span(
            carry, val_fac(a, b), sim_vols[a:b], sim_drift[a:b], coeffs[a:b],
            mus[a:b], sds[a:b], vbars[a:b], dev, dfd, first + a, first + b,
            collect_panels=collect_panels, **static,
        )
        out_parts.append(outputs)
        check_cancel()
        report(BACKWARD_PCNT_TIME + (1.0 - BACKWARD_PCNT_TIME) * (i + 1) / total_fwd)

    stacked = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *out_parts)
    _check_forward_health(carry[1], carry[0], backward_npv)
    end_spots = spot_from_factors(val_last(), sim_vols[-1], sim_drift[-1])
    arrays = _assemble_arrays(
        stacked, carry, end_spots, terminal_fn, backward_npv, dtype, collect_panels
    )
    if stopwatches is not None:
        jax.block_until_ready(arrays.npv)
        stopwatches.stop("ForwardSimulation")
    report(1.0)
    return arrays


def _current_period_step(v_next, dev, interp_kind, num_grid_points, extra_decisions, dtype):
    """Backward value at the deterministic current period (reference :171-181,
    :226-330 with simulatedPrices = forward price)."""
    G = num_grid_points
    cont_mean = jnp.mean(v_next, axis=0)  # [G]
    econ = step_economics(
        jnp.reshape(dev.inventory, (1,)),
        dev.pillars[0], interp_kind, dev.loss[0],
        dev.space_lo[1], dev.space_hi[1],
        dev.inject_cost[0], dev.withdraw_cost[0],
        dev.cons_inject[0], dev.cons_withdraw[0],
        dev.inv_cost_rate[0], dev.df_settle[0], dev.df_start[0],
        extra_decisions,
    )
    j, w = fractional_index(econ.inventory_after, dev.space_lo[1], dev.space_hi[1], G)
    fitted = jnp.take(cont_mean, j) * (1.0 - w) + jnp.take(cont_mean, j + 1) * w  # [1, D]
    immediate = econ.immediate_npv(dev.fwd[0])  # [1, D]
    total = immediate + fitted
    best = jnp.argmax(total[0])
    # Per-sim actual continuation at the chosen decision.
    j_b, w_b = j[0, best], w[0, best]
    actual = jnp.take(v_next, j_b, axis=1) * (1.0 - w_b) + jnp.take(
        v_next, j_b + 1, axis=1
    ) * w_b  # [S]
    v0 = immediate[0, best] + actual
    return v0, cont_mean


# --------------------------------------------------------------------------- #
# Policy capture / repricing                                                  #
# --------------------------------------------------------------------------- #


class LsmcPolicy(NamedTuple):
    """A fitted exercise policy: everything the forward pass needs.

    The reference retains regression coefficients from the backward pass and
    reuses them in the forward pass within one calculation
    (``LsmcStorageValuation.cs:156, 206, 350, 394``); SURVEY.md §5 flags
    exposing this as the checkpoint/resume analogue.  A policy can be saved
    (``save``) and repriced against fresh path sets without re-running the
    backward induction — e.g. intraday re-pricing or standalone scenario runs.
    """

    coeffs: jax.Array  # [m, B, G]
    mus: jax.Array  # [m, B]
    sds: jax.Array  # [m, B]
    vbars: jax.Array  # [m, G]
    cont_mean0: jax.Array  # [G]
    backward_npv: jax.Array  # scalar

    def save(self, path: str) -> None:
        np.savez(
            path,
            **{f: np.asarray(getattr(self, f)) for f in self._fields},
        )

    @classmethod
    def load(cls, path: str, dtype=jnp.float32) -> "LsmcPolicy":
        data = np.load(path)
        return cls(**{f: jnp.asarray(data[f], dtype) for f in cls._fields})


def fit_policy(
    ctx: ValuationContext,
    reg_factors: jax.Array,  # [m, F, S]
    sim_vols,
    sim_drift,
    spec: BasisSpec,
    extra_decisions: int = 0,
    dtype=jnp.float32,
) -> LsmcPolicy:
    """Run only the backward induction and capture the fitted policy."""
    dev = device_inputs(ctx, dtype)
    backward_npv, cont_mean0, coeffs, mus, sds, vbars = _backward_program_jit(
        jnp.asarray(reg_factors, dtype),
        jnp.asarray(sim_vols, dtype),
        jnp.asarray(sim_drift, dtype),
        dev,
        spec=spec,
        interp_kind=ctx.interp_kind,
        num_grid_points=ctx.num_grid_points,
        extra_decisions=extra_decisions,
        val_first=ctx.val_date_is_first_step,
        terminal_fn=ctx.storage.terminal_npv_fn,
    )
    return LsmcPolicy(coeffs, mus, sds, vbars, cont_mean0, backward_npv)


def reprice(
    ctx: ValuationContext,
    policy: LsmcPolicy,
    val_factors: jax.Array,  # [m, F, S]
    sim_vols,
    sim_drift,
    spec: BasisSpec,
    discount_deltas: bool = False,
    extra_decisions: int = 0,
    dtype=jnp.float32,
    collect_panels: bool = False,
) -> LsmcArrays:
    """Forward-simulate a previously fitted policy on a fresh path set."""
    dev = device_inputs(ctx, dtype)
    return _forward_program_jit(
        jnp.asarray(val_factors, dtype),
        jnp.asarray(sim_vols, dtype),
        jnp.asarray(sim_drift, dtype),
        policy.cont_mean0,
        policy.coeffs,
        policy.mus,
        policy.sds,
        policy.vbars,
        dev,
        policy.backward_npv,
        spec=spec,
        interp_kind=ctx.interp_kind,
        num_grid_points=ctx.num_grid_points,
        extra_decisions=extra_decisions,
        val_first=ctx.val_date_is_first_step,
        terminal_fn=ctx.storage.terminal_npv_fn,
        discount_deltas=discount_deltas,
        collect_panels=collect_panels,
    )
