"""Multi-factor LSMC valuation — the flagship pandas-facing API.

Mirrors ``multi_factor_value`` / ``three_factor_seasonal_value`` and the
result assembly of ``_net_multi_factor_calc``
(reference ``cmdty_storage/multi_factor.py:302-496``): runs the intrinsic
calculation first, then the LSMC engine on simulated paths, and returns NPV,
per-period deltas, the expected storage profile, eight per-simulation panels,
trigger prices and trigger volume/price profiles.
"""
from __future__ import annotations

import logging
import os
from typing import Callable, Iterable, List, NamedTuple, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from .compile import SettlementRule, build_valuation_context
from .engines.intrinsic import PROFILE_COLUMNS, intrinsic_value
from .engines.lsmc import LsmcArrays, run_lsmc
from .exceptions import InventoryConstraintsCannotBeFulfilledError, StorageError
from .models.multi_factor import (
    CurveType,
    FactorCorrsType,
    FactorType,
    build_sim_coefficients,
    create_3_factor_season_params,
    validate_multi_factor_params,
)
from .models.simulation import simulate_factor_paths, spots_from_factor_paths
from .ops.regression import basis_spec
from .storage import CmdtyStorage
from .types import TriggerPricePoint, TriggerPriceProfile
from .utils.basis import THREE_FACTOR_SEASONAL_ALIASES, BasisFunctionsType, as_monomials
from .utils.frequencies import PeriodLike, normalize_freq, to_period
from .utils.profiling import Stopwatches

logger: logging.Logger = logging.getLogger("storage_tpu.multi_factor")

#: Share of a device's allocator limit (``memory_stats()["bytes_limit"]``)
#: that one materialised factor-path set may take.  The backward program
#: holds the regression path set, the transient copy of it that XLA makes
#: for the scan, and a few ``[S, G]`` value surfaces; a quarter leaves room
#: for all of them.
PATH_BYTES_FRACTION = 0.25
#: Path budget on a CPU device, which reports no allocator limit (host RAM).
CPU_PATH_BYTES = 6e9


def _budget_device(mesh=None) -> jax.Device:
    """The device whose memory holds (one shard of) the factor paths."""
    if mesh is not None:
        return mesh.devices.flat[0]
    device = jax.config.jax_default_device
    if isinstance(device, str):
        device = jax.devices(device)[0]
    return device if device is not None else jax.devices()[0]


def max_path_bytes(mesh=None) -> int:
    """Per-device budget for materialised factor paths, in bytes; past it
    the engine streams paths span-by-span.

    ``STORAGE_TPU_MAX_PATH_BYTES`` overrides.  Otherwise the budget is
    :data:`PATH_BYTES_FRACTION` of the device's allocator limit, and
    :data:`CPU_PATH_BYTES` on a CPU device.  An accelerator that reports no
    limit is an error rather than a guess.
    """
    override = os.environ.get("STORAGE_TPU_MAX_PATH_BYTES")
    if override is not None:
        return int(float(override))
    device = _budget_device(mesh)
    if device.platform == "cpu":
        return int(CPU_PATH_BYTES)
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise StorageError(
            f"Device {device} reports no memory limit, so the factor-path "
            "budget cannot be derived; set STORAGE_TPU_MAX_PATH_BYTES."
        )
    return int(PATH_BYTES_FRACTION * limit)


class MultiFactorValuationResults(NamedTuple):
    """Reference ``MultiFactorValuationResults`` (``multi_factor.py:302-321``)."""

    npv: float
    deltas: pd.Series
    expected_profile: pd.DataFrame
    intrinsic_npv: float
    intrinsic_profile: pd.DataFrame
    sim_spot_regress: pd.DataFrame
    sim_spot_valuation: pd.DataFrame
    sim_inventory: pd.DataFrame
    sim_inject_withdraw: pd.DataFrame
    sim_cmdty_consumed: pd.DataFrame
    sim_inventory_loss: pd.DataFrame
    sim_net_volume: pd.DataFrame
    sim_pv: pd.DataFrame
    trigger_prices: pd.DataFrame
    trigger_profiles: pd.Series

    @property
    def extrinsic_npv(self) -> float:
        return self.npv - self.intrinsic_npv


def _empty_results(freq: str, npv: float = 0.0, intrinsic_npv: float = 0.0):
    empty_idx = pd.PeriodIndex([], freq=freq)
    empty_df = pd.DataFrame(index=empty_idx)
    empty_series = pd.Series(index=empty_idx, dtype=np.float64)
    return MultiFactorValuationResults(
        npv, empty_series, empty_df, intrinsic_npv, empty_df, empty_df, empty_df,
        empty_df, empty_df, empty_df, empty_df, empty_df, empty_df, empty_df,
        pd.Series(index=empty_idx, dtype=object),
    )


def three_factor_seasonal_value(
    cmdty_storage: CmdtyStorage,
    val_date: PeriodLike,
    inventory: float,
    fwd_curve: pd.Series,
    interest_rates: Union[None, float, pd.Series],
    settlement_rule: Optional[SettlementRule],
    spot_mean_reversion: float,
    spot_vol: float,
    long_term_vol: float,
    seasonal_vol: float,
    num_sims: int,
    basis_funcs: BasisFunctionsType,
    discount_deltas: bool,
    seed: Optional[int] = None,
    fwd_sim_seed: Optional[int] = None,
    extra_decisions: Optional[int] = None,
    num_inventory_grid_points: int = 100,
    numerical_tolerance: float = 1e-12,
    on_progress_update: Optional[Callable[[float], None]] = None,
    antithetic: bool = False,
    cancelled: Optional[Callable[[], bool]] = None,
    dtype=jnp.float32,
    mesh=None,
    return_sim_panels: bool = True,
    profile_sink: Optional[Callable[[Stopwatches], None]] = None,
) -> MultiFactorValuationResults:
    """Three-factor seasonal LSMC valuation (reference ``multi_factor.py:324-354``).

    Basis functions may reference the factors as ``x_st`` (short-term),
    ``x_lt`` (long-term) and ``x_sw`` (seasonal wave); spot as ``s`` — as a
    DSL string or composed ``Monomial`` objects (``storage_tpu.S``/``X``).
    Pass ``mesh`` (a 1-D ``jax.sharding.Mesh``) to shard paths over devices.

    ``seed``/``fwd_sim_seed`` give deterministic results **per release only**:
    RNG stream keying may change at any minor version (README parity notes
    #7-8); across versions only statistical agreement is guaranteed.
    """
    factors, factor_corrs = create_3_factor_season_params(
        cmdty_storage.freq, spot_mean_reversion, spot_vol, long_term_vol, seasonal_vol,
        to_period(val_date, normalize_freq(cmdty_storage.freq)), cmdty_storage.end,
    )
    monomials = as_monomials(basis_funcs, THREE_FACTOR_SEASONAL_ALIASES)
    return _multi_factor_calc(
        cmdty_storage, val_date, inventory, fwd_curve, interest_rates, settlement_rule,
        factors, factor_corrs, num_sims, monomials, discount_deltas, seed, fwd_sim_seed,
        extra_decisions, num_inventory_grid_points, numerical_tolerance,
        on_progress_update, antithetic, cancelled, dtype, mesh, return_sim_panels,
        profile_sink,
    )


def multi_factor_value(
    cmdty_storage: CmdtyStorage,
    val_date: PeriodLike,
    inventory: float,
    fwd_curve: pd.Series,
    interest_rates: Union[None, float, pd.Series],
    settlement_rule: Optional[SettlementRule],
    factors: Iterable[FactorType],
    factor_corrs: FactorCorrsType,
    num_sims: int,
    basis_funcs: BasisFunctionsType,
    discount_deltas: bool,
    seed: Optional[int] = None,
    fwd_sim_seed: Optional[int] = None,
    extra_decisions: Optional[int] = None,
    num_inventory_grid_points: int = 100,
    numerical_tolerance: float = 1e-12,
    on_progress_update: Optional[Callable[[float], None]] = None,
    antithetic: bool = False,
    cancelled: Optional[Callable[[], bool]] = None,
    dtype=jnp.float32,
    mesh=None,
    return_sim_panels: bool = True,
    profile_sink: Optional[Callable[[Stopwatches], None]] = None,
) -> MultiFactorValuationResults:
    """General multi-factor LSMC valuation (reference ``multi_factor.py:357-383``).

    ``basis_funcs`` accepts the DSL string or composed ``Monomial`` objects.
    ``seed``/``fwd_sim_seed`` give deterministic results **per release only**
    (README parity notes #7-8): RNG stream keying may change at any minor
    version; across versions only statistical agreement is guaranteed.
    """
    factors = list(factors)
    factor_corrs = validate_multi_factor_params(factors, factor_corrs)
    if normalize_freq(cmdty_storage.freq) != normalize_freq(fwd_curve.index.freqstr):
        raise ValueError("cmdty_storage and forward_curve have different frequencies.")
    monomials = as_monomials(basis_funcs)
    return _multi_factor_calc(
        cmdty_storage, val_date, inventory, fwd_curve, interest_rates, settlement_rule,
        factors, factor_corrs, num_sims, monomials, discount_deltas, seed, fwd_sim_seed,
        extra_decisions, num_inventory_grid_points, numerical_tolerance,
        on_progress_update, antithetic, cancelled, dtype, mesh, return_sim_panels,
        profile_sink,
    )


def _multi_factor_calc(
    cmdty_storage: CmdtyStorage,
    val_date: PeriodLike,
    inventory: float,
    fwd_curve: pd.Series,
    interest_rates,
    settlement_rule,
    factors: Sequence[FactorType],
    factor_corrs: np.ndarray,
    num_sims: int,
    monomials,
    discount_deltas: bool,
    seed: Optional[int],
    fwd_sim_seed: Optional[int],
    extra_decisions: Optional[int],
    num_inventory_grid_points: int,
    numerical_tolerance: float,
    on_progress_update,
    antithetic: bool,
    cancelled,
    dtype,
    mesh=None,
    return_sim_panels: bool = True,
    profile_sink=None,
) -> MultiFactorValuationResults:
    freq = normalize_freq(cmdty_storage.freq)
    val_period = to_period(val_date, freq)
    stopwatches = Stopwatches()
    # Genuine phase attribution needs device syncs at phase boundaries; only
    # pay for them when the caller asked for the profile.
    sync = profile_sink is not None
    stopwatches.start("All")

    if inventory < 0:
        raise ValueError("Inventory cannot be negative.")
    ndev = 1 if mesh is None else int(np.prod(list(mesh.shape.values())))
    if num_sims % ndev:
        raise ValueError(
            f"num_sims ({num_sims}) must be divisible by the number of mesh "
            f"devices ({ndev}) so paths shard evenly."
        )

    # Edge cases (reference LsmcStorageValuation.cs:64-84).
    if val_period > cmdty_storage.end:
        if on_progress_update is not None:
            on_progress_update(1.0)
        return _empty_results(freq)
    if val_period == cmdty_storage.end:
        if cmdty_storage.must_be_empty_at_end:
            if inventory > 0:
                raise InventoryConstraintsCannotBeFulfilledError(
                    "Storage must be empty at end, but inventory is greater than zero."
                )
            if on_progress_update is not None:
                on_progress_update(1.0)
            return _empty_results(freq)
        spot = float(fwd_curve[val_period])
        npv = cmdty_storage.terminal_storage_npv(spot, float(inventory))
        if on_progress_update is not None:
            on_progress_update(1.0)
        return _empty_results(freq, npv=npv, intrinsic_npv=npv)

    ctx = build_valuation_context(
        cmdty_storage, val_date, inventory, fwd_curve, interest_rates, settlement_rule,
        num_inventory_grid_points, numerical_tolerance,
    )

    # Intrinsic calc first (reference multi_factor.py:404-410), sharing the
    # compiled context with the LSMC run below (one pandas->arrays pass).
    logger.info("Calculating intrinsic value.")
    from .engines.intrinsic import intrinsic_value_with_ctx

    intrinsic = intrinsic_value_with_ctx(ctx, dtype=dtype)
    logger.info("Calculation of intrinsic value complete.")
    n = ctx.n_steps
    first_sim_step = 1 if ctx.val_date_is_first_step else 0
    sim_periods = list(ctx.periods[first_sim_step:])

    spec = basis_spec(monomials, num_factors=len(factors))

    # Path simulation: regression set + independent valuation set.  The
    # reference continues the same Mersenne Twister stream when fwd_sim_seed is
    # not given (LsmcValuationParameters.cs:181-192); here the equivalent is a
    # key split, and fwd_sim_seed == seed reproduces identical paths like the
    # reference test fixtures use.
    coeffs = build_sim_coefficients(
        factors, factor_corrs, val_period, fwd_curve, sim_periods
    )
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2**62))
    reg_key = jax.random.PRNGKey(int(seed))
    if fwd_sim_seed is None:
        val_key = jax.random.fold_in(reg_key, 1)
    else:
        val_key = jax.random.PRNGKey(int(fwd_sim_seed))

    # Simulation factories: the engine simulates each path set lazily so the
    # regression set can be freed before the valuation set allocates
    # (reference simulates per phase too, LsmcStorageValuation.cs:100, :346).
    sims_cache = {}
    sim_vols = jnp.asarray(coeffs.vols, dtype)
    sim_drift = jnp.asarray(coeffs.log_fwd_drift, dtype)

    # Long-horizon x production-path configs (e.g. multi-year hourly) cannot
    # materialise the full [m, F, S] factor array in device memory; past the
    # per-device budget the engine streams paths span-by-span from
    # checkpointed OU states (bit-identical draws — see
    # StreamingFactorSource).  Panels-per-sim are incompatible with streaming
    # (they are O(n x S) themselves).
    path_bytes = (
        len(sim_periods) * len(factors) * num_sims * jnp.dtype(dtype).itemsize
    ) // ndev
    budget = max_path_bytes(mesh)
    streaming = path_bytes > budget
    if streaming and return_sim_panels:
        raise ValueError(
            f"return_sim_panels=True requires materialising O(n_steps x "
            f"num_sims) panels, but this configuration's factor paths alone "
            f"({path_bytes / 1e9:.1f} GB per device) exceed the device budget "
            f"({budget / 1e9:.1f} GB, STORAGE_TPU_MAX_PATH_BYTES); "
            "pass return_sim_panels=False."
        )
    if streaming:
        from .models.simulation import StreamingFactorSource

        # Span length targeting ~1 GB of regenerated factors per span (and
        # never more than a quarter of the budget, so tests with a tiny
        # STORAGE_TPU_MAX_PATH_BYTES actually exercise multiple spans).
        per_step_bytes = len(factors) * num_sims * jnp.dtype(dtype).itemsize
        span_target = min(1e9, budget / 4)
        every = max(64, int(span_target // max(per_step_bytes, 1)))

        # The simulation stopwatches time the upfront CHECKPOINT pass only:
        # per-span regeneration is interleaved with consumption, so that part
        # of the simulation cost folds into BackwardInduction /
        # ForwardSimulation (unlike the materialised path's stopwatches —
        # noted here because the profile reports are otherwise comparable).
        def make_reg():
            logger.info("Streaming regression path simulation (span=%d).", every)
            with stopwatches.time("RegressionPriceSimulation"):
                return StreamingFactorSource(
                    coeffs, num_sims, reg_key, antithetic, dtype, every=every,
                    mesh=mesh,
                ).prepare()

        def make_val():
            logger.info("Streaming valuation path simulation (span=%d).", every)
            with stopwatches.time("ValuationPriceSimulation"):
                return StreamingFactorSource(
                    coeffs, num_sims, val_key, antithetic, dtype, every=every,
                    mesh=mesh,
                ).prepare()
    else:
        def make_reg():
            logger.info("Starting regression spot price simulation.")
            with stopwatches.time("RegressionPriceSimulation"):
                f = simulate_factor_paths(
                    coeffs, num_sims, None, antithetic, dtype, key=reg_key,
                )
                if sync:
                    jax.block_until_ready(f)
            logger.info("Spot regression price simulation complete.")
            if return_sim_panels:
                sims_cache["reg"] = spots_from_factor_paths(f, sim_vols, sim_drift)
            return f

        def make_val():
            logger.info("Starting valuation spot price simulation.")
            with stopwatches.time("ValuationPriceSimulation"):
                f = simulate_factor_paths(
                    coeffs, num_sims, None, antithetic, dtype, key=val_key,
                )
                if sync:
                    jax.block_until_ready(f)
            logger.info("Valuation spot price simulation complete.")
            if return_sim_panels:
                sims_cache["val"] = spots_from_factor_paths(f, sim_vols, sim_drift)
            return f

    logger.info("Calculating LSMC value.")
    arrays = run_lsmc(
        ctx, make_reg, make_val, sim_vols, sim_drift, spec,
        discount_deltas=discount_deltas,
        extra_decisions=int(extra_decisions or 0),
        dtype=dtype,
        on_progress_update=on_progress_update,
        cancelled=cancelled,
        mesh=mesh,
        collect_panels=return_sim_panels,
        stopwatches=stopwatches,
    )
    jax.block_until_ready(arrays.npv)
    logger.info("Calculation of LSMC value complete.")

    results, backward_npv = _assemble_results(
        ctx, arrays, intrinsic, sim_periods,
        sims_cache.get("reg"), sims_cache.get("val"), return_sim_panels)
    logger.info(
        "Forward Pv: %s; Backward Pv: %s",
        f"{results.npv:,.2f}",
        f"{backward_npv:,.2f}",
    )
    stopwatches.stop("All")
    logger.info("Profiling Report:\n%s", stopwatches.generate_profile_report())
    if profile_sink is not None:
        # Phase wall-clock capture for harnesses (bench.py commits the
        # breakdown next to the headline number).
        profile_sink(stopwatches)
    return results


def _fetch_panels(panels, max_chunk_bytes: int = 256 * 2**20) -> np.ndarray:
    """Device->host fetch of the per-sim panels in bounded slices.

    At production path counts the panels are GBs ([n+1, 6, S] f32); a single
    np.asarray stages the whole tensor through one transfer buffer, which
    spikes host memory.  Chunking over sims keeps each transfer bounded
    while writing straight into the final host array.
    """
    shape = tuple(panels.shape)
    S = shape[-1]
    per_sim = int(np.prod(shape[:-1])) * 4
    chunk = max(1, max_chunk_bytes // max(per_sim, 1))
    if S <= chunk:
        return np.asarray(panels, dtype=np.float64)
    # One fixed-size jitted slice reused for every chunk (per-chunk python
    # slicing would compile a distinct program per offset); the final chunk
    # overlaps backwards instead of changing shape.
    slicer = jax.jit(
        lambda p, s: jax.lax.dynamic_slice_in_dim(p, s, chunk, axis=-1)
    )
    out = np.empty(shape, dtype=np.float64)
    for a in range(0, S, chunk):
        start = min(a, S - chunk)
        out[..., start : start + chunk] = np.asarray(slicer(panels, start))
    return out


def _assemble_results(
    ctx, arrays: LsmcArrays, intrinsic, sim_periods, reg_spots_sim, val_spots_sim,
    return_sim_panels: bool = True,
) -> MultiFactorValuationResults:
    periods = ctx.periods
    freq = ctx.freq
    sim_index = pd.PeriodIndex(sim_periods, freq=freq)
    empty_panel = pd.DataFrame(index=periods)

    if return_sim_panels:
        panels_np = _fetch_panels(arrays.panels)  # [n+1, 6, S]

    def panel(field_idx: int) -> pd.DataFrame:
        if not return_sim_panels:
            return empty_panel
        return pd.DataFrame(panels_np[:, field_idx, :], index=periods)

    # ONE device->host transfer for every small output instead of ten, each
    # of which would synchronise with the device on its own.
    small = [
        arrays.deltas, arrays.profile_means,
        arrays.trigger_has_inject, arrays.trigger_has_withdraw,
        arrays.trigger_inject_volumes, arrays.trigger_inject_prices,
        arrays.trigger_withdraw_volumes, arrays.trigger_withdraw_prices,
        arrays.npv, arrays.backward_npv,
    ]
    shapes = [tuple(a.shape) for a in small]
    # Concatenate in the promoted dtype of the inputs: hard-casting to f32
    # here would silently round f64-mode results (~7 digits on a 1e6 NPV).
    batch_dtype = jnp.result_type(*small)
    flat = np.asarray(
        jnp.concatenate(
            [jnp.asarray(a, batch_dtype).ravel() for a in small]
        ),
        dtype=np.float64,
    )
    fetched, off = [], 0
    for shp in shapes:
        size = int(np.prod(shp)) if shp else 1
        fetched.append(flat[off : off + size].reshape(shp))
        off += size
    (deltas_np, profile_means, has_inj_f, has_wdr_f, inj_vols, inj_prices,
     wdr_vols, wdr_prices, npv_arr, backward_npv_arr) = fetched

    deltas = pd.Series(deltas_np, index=periods)

    # Expected storage profile: reduced over sims ON DEVICE inside the engine;
    # only [n+1, 6] crosses to the host (per-sim panels can be GBs at
    # production path counts).
    profile = pd.DataFrame(
        {
            "inventory": profile_means[:, 0],
            "inject_withdraw_volume": profile_means[:, 1],
            "cmdty_consumed": profile_means[:, 2],
            "inventory_loss": profile_means[:, 3],
            "net_volume": profile_means[:, 4],
            "period_pv": profile_means[:, 5],
        },
        index=periods,
    )

    # Trigger prices: scalar summary per decision period.  The reference keeps
    # the price at the max inject volume on the inject side, and the price of
    # the smallest withdrawal increment on the withdraw side
    # (LsmcStorageValuation.cs:525-526, 545-554).
    has_inj = has_inj_f > 0.5
    has_wdr = has_wdr_f > 0.5

    decision_index = periods[:-1]
    nan = np.nan
    trigger_prices = pd.DataFrame(
        {
            "inject_volume": np.where(has_inj, inj_vols[:, -1], nan),
            "inject_trigger_price": np.where(has_inj, inj_prices[:, -1], nan),
            "withdraw_volume": np.where(has_wdr, wdr_vols[:, -1], nan),
            "withdraw_trigger_price": np.where(has_wdr, wdr_prices[:, 0], nan),
        },
        index=decision_index,
    )

    profiles_list: List[TriggerPriceProfile] = []
    for k in range(len(decision_index)):
        inject_points = (
            [TriggerPricePoint(v, p) for v, p in zip(inj_vols[k], inj_prices[k])]
            if has_inj[k]
            else []
        )
        withdraw_points = (
            [TriggerPricePoint(v, p) for v, p in zip(wdr_vols[k], wdr_prices[k])]
            if has_wdr[k]
            else []
        )
        profiles_list.append(TriggerPriceProfile(inject_points, withdraw_points))
    trigger_profiles = pd.Series(profiles_list, index=decision_index, dtype=object)

    if return_sim_panels and reg_spots_sim is not None:
        sim_spot_regress = pd.DataFrame(np.asarray(reg_spots_sim, dtype=np.float64), index=sim_index)
        sim_spot_valuation = pd.DataFrame(np.asarray(val_spots_sim, dtype=np.float64), index=sim_index)
    else:
        sim_spot_regress = pd.DataFrame(index=sim_index)
        sim_spot_valuation = pd.DataFrame(index=sim_index)

    results = MultiFactorValuationResults(
        npv=float(npv_arr),
        deltas=deltas,
        expected_profile=profile,
        intrinsic_npv=intrinsic.npv,
        intrinsic_profile=intrinsic.profile,
        sim_spot_regress=sim_spot_regress,
        sim_spot_valuation=sim_spot_valuation,
        sim_inventory=panel(0),
        sim_inject_withdraw=panel(1),
        sim_cmdty_consumed=panel(2),
        sim_inventory_loss=panel(3),
        sim_net_volume=panel(4),
        sim_pv=panel(5),
        trigger_prices=trigger_prices,
        trigger_profiles=trigger_profiles,
    )
    return results, float(backward_npv_arr)
