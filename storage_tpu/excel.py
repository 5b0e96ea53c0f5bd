"""Worksheet-function-compatible facade (the Excel add-in's UDF surface).

The reference ships an Excel-DNA add-in whose worksheet functions take cell
RANGES (2-D arrays of dates/numbers), cache objects under string handles and
stream async results back into cells (SURVEY.md §2.4).  The .xll binary
itself is out of scope for a Python library, but its FUNCTION SURFACE is not:
this module exposes each ``cmdty.*`` UDF as a plain Python callable with the
same name, argument order and range conventions, over the same named-handle
cache and async runtime (:mod:`storage_tpu.runtime`), so spreadsheet-style
integrations (xlwings / pyxll / gRPC sheets backends) can bind 1:1.

Mapping (reference ``src/Cmdty.Storage.Excel``):

=================================  =========================================
``cmdty.CreateStorage``            :func:`create_storage`
                                   (``MultiFactorXl.cs:87-111``, range parser
                                   ``StorageExcelHelper.cs:116-188``)
``cmdty.StorageValueThreeFactor``  :func:`storage_value_three_factor`
                                   (``MultiFactorXl.cs:114-190``)
``cmdty.SubscribeProgress``        :func:`subscribe_progress`
``cmdty.SubscribeStatus``          :func:`subscribe_status`
``cmdty.SubscribeResultProperty``  :func:`subscribe_result_property`
                                   (``MultiFactorXl.cs:192-242``)
``cmdty.StorageIntrinsicValue``    :func:`storage_intrinsic_value`
                                   (``IntrinsicXl.cs:36-62``)
``cmdty.StorageIntrinsicDecisionProfile`` :func:`storage_intrinsic_decision_profile`
                                   (``IntrinsicXl.cs:62-95``)
``cmdty.StorageValueTrinomialTree``:func:`storage_value_trinomial_tree`
                                   (``TrinomialXl.cs:35-64``)
``cmdty.StorageValueIntrinsic``    :func:`storage_value_intrinsic`
                                   (``TrinomialXl.cs:64-95``)
``ExcelCalcWrapper``               :class:`storage_tpu.runtime.AsyncValuation`
=================================  =========================================

Error convention: like the add-in's error-to-``#`` marshalling
(``StorageExcelHelper.ExecuteExcelFunction``), every facade function catches
exceptions and returns the string ``"#ERROR! <message>"`` instead of raising;
:data:`NA` (``"#N/A"``) stands in for Excel's NA error while an async result
is pending.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from .runtime import AsyncValuation, CalcStatus, ObjectCache
from .storage import CmdtyStorage
from .types import RatchetInterp
from .valuation import three_factor_seasonal_value

NA = "#N/A"

#: Process-wide handle caches, like the add-in's static dictionaries
#: (``MultiFactorXl.cs:84-85``).
storage_cache = ObjectCache()
calc_cache = ObjectCache()

_INTERP = {
    "PiecewiseLinear": RatchetInterp.LINEAR,
    "Polynomial": RatchetInterp.POLYNOMIAL,
    "Step": RatchetInterp.STEP,
}


def _excel_fn(fn):
    """Error-to-``#`` string marshalling (``ExecuteExcelFunction``)."""

    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 - worksheet convention
            return f"#ERROR! {exc}"

    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def _rows(range_2d) -> List[Sequence]:
    """Rows of a worksheet range, stopping at the first blank-dated row
    (``TakeWhileNotEmptyOrError``)."""
    out = []
    for row in range_2d:
        first = row[0] if len(row) else None
        if first is None or (isinstance(first, str) and not first.strip()) or (
            isinstance(first, float) and np.isnan(first)
        ):
            break
        out.append(row)
    return out


def _day(date_like) -> pd.Period:
    return pd.Period(pd.Timestamp(date_like), freq="D")


def _ratchets_from_range(ratchets) -> list:
    """4-column (date, inventory, inject_rate, withdraw_rate) range -> the
    ``CmdtyStorage(ratchets=...)`` structure, grouping rows by date
    (``StorageExcelHelper.cs:140-155``; withdraw rates are entered positive
    in the sheet and negated here, matching the reference)."""
    tables: list = []
    last_date = None
    for i, row in enumerate(_rows(ratchets)):
        if len(row) != 4:
            raise ValueError(
                "Inject/withdraw constraints have been incorrectly entered. "
                "Argument value should be a range with 4 columns."
            )
        date, inventory, inject_rate, withdraw_rate = row
        day = _day(date)
        if last_date is None or day != last_date:
            tables.append((str(day), []))
            last_date = day
        tables[-1][1].append(
            (float(inventory), -abs(float(withdraw_rate)), float(inject_rate))
        )
    if not tables:
        raise ValueError("Inject/withdraw constraints haven't been specified.")
    return tables


def _series_from_range(range_2d, name: str, freq: str = "D") -> pd.Series:
    rows = _rows(range_2d)
    if not rows:
        raise ValueError(f"{name} range contains no rows.")
    idx = pd.PeriodIndex([pd.Timestamp(r[0]) for r in rows], freq=freq)
    return pd.Series([float(r[1]) for r in rows], index=idx)


def _rate_curve_from_range(interest_rate_curve) -> pd.Series:
    """(date, continuously-compounded zero rate) pillars, linearly
    interpolated to daily (``CreateLinearInterpolatedInterestRateFunc``)."""
    pillars = _series_from_range(interest_rate_curve, "Interest_rate_curve")
    daily = pillars.resample("D").asfreq().interpolate(method="linear")
    return daily


def _settlement_rule(settle_dates) -> Optional[Callable]:
    """(month, settlement date) rows -> delivery-day -> settlement-day rule
    (``StorageExcelHelper.CreateSettlementRule``)."""
    if settle_dates is None:
        return None
    rows = _rows(settle_dates)
    table = {
        pd.Period(pd.Timestamp(r[0]), freq="M"): _day(r[1]) for r in rows
    }

    def rule(delivery):
        month = pd.Period(delivery.start_time, freq="M")
        if month not in table:
            raise ValueError(f"No settlement date provided for delivery month {month}.")
        return table[month]

    return rule


def _default(value, fallback):
    missing = value is None or (isinstance(value, str) and not value.strip())
    return fallback if missing else value


def _build_storage(
    storage_start,
    storage_end,
    ratchets,
    ratchet_interpolation: str,
    injection_cost_rate: float,
    cmdty_consumed_on_injection: float = 0.0,
    withdrawal_cost_rate: float = 0.0,
    cmdty_consumed_on_withdrawal: float = 0.0,
    numerical_tolerance=None,
) -> CmdtyStorage:
    """Shared range-parsing construction for ``create_storage`` and the
    synchronous UDFs.  Raises on invalid input (callers marshal to ``#``);
    returns an UNCACHED storage so concurrent worksheet recalcs can never
    cross-wire each other's temporaries (the reference add-in's
    dictionary-threading TODO, ``MultiFactorXl.cs:89``)."""
    if ratchet_interpolation not in _INTERP:
        raise ValueError(
            f"Value of Inject_withdraw_interpolation '{ratchet_interpolation}' not "
            "recognised. Must be either 'PiecewiseLinear', 'Polynomial' or 'Step'."
        )
    return CmdtyStorage(
        freq="D",
        storage_start=str(_day(storage_start)),
        storage_end=str(_day(storage_end)),
        injection_cost=float(injection_cost_rate),
        withdrawal_cost=float(withdrawal_cost_rate),
        cmdty_consumed_inject=float(cmdty_consumed_on_injection),
        cmdty_consumed_withdraw=float(cmdty_consumed_on_withdrawal),
        ratchets=_ratchets_from_range(ratchets),
        ratchet_interp=_INTERP[ratchet_interpolation],
        # 1e-10 is the REFERENCE add-in's blank-cell default
        # (IntrinsicXl.cs:119 DefaultIfExcelEmptyOrMissing(..., 1E-10)) —
        # deliberately tighter than CmdtyStorage's Python-API default (1e-9).
        numerical_tolerance=float(_default(numerical_tolerance, 1e-10)),
    )


@_excel_fn
def create_storage(
    name: str,
    storage_start,
    storage_end,
    ratchets,
    ratchet_interpolation: str,
    injection_cost_rate: float,
    cmdty_consumed_on_injection: float = 0.0,
    withdrawal_cost_rate: float = 0.0,
    cmdty_consumed_on_withdrawal: float = 0.0,
    numerical_tolerance=None,
) -> str:
    """``cmdty.CreateStorage``: build and cache a storage under ``name``.
    ``numerical_tolerance`` reaches the storage's polynomial-constraint root
    acceptance, like the reference's ``PolynomialWithParams(tolerance)``
    (``StorageExcelHelper.cs:164``)."""
    storage = _build_storage(
        storage_start, storage_end, ratchets, ratchet_interpolation,
        injection_cost_rate, cmdty_consumed_on_injection,
        withdrawal_cost_rate, cmdty_consumed_on_withdrawal,
        numerical_tolerance,
    )
    return storage_cache.add(name, storage)


@_excel_fn
def storage_value_three_factor(
    name: str,
    storage_handle: str,
    valuation_date,
    current_inventory: float,
    forward_curve,
    interest_rate_curve,
    spot_vol: float,
    spot_mean_reversion: float,
    long_term_vol: float,
    seasonal_vol: float,
    discount_deltas: bool,
    settle_dates=None,
    num_sims: int = 1000,
    basis_functions: str = "1 + s + x_st + x_lt + x_sw",
    seed=None,
    fwd_sim_seed=None,
    num_grid_points=None,
    numerical_tolerance=None,
    extra_decisions=None,
) -> str:
    """``cmdty.StorageValueThreeFactor``: start an async 3-factor LSMC
    valuation cached under ``name``; returns the handle immediately."""
    storage = storage_cache.get(storage_handle)
    task = AsyncValuation(
        three_factor_seasonal_value,
        cmdty_storage=storage,
        val_date=str(_day(valuation_date)),
        inventory=float(current_inventory),
        fwd_curve=_series_from_range(forward_curve, "Forward_curve"),
        interest_rates=_rate_curve_from_range(interest_rate_curve),
        settlement_rule=_settlement_rule(settle_dates),
        spot_mean_reversion=float(spot_mean_reversion),
        spot_vol=float(spot_vol),
        long_term_vol=float(long_term_vol),
        seasonal_vol=float(seasonal_vol),
        num_sims=int(num_sims),
        basis_funcs=basis_functions,
        discount_deltas=bool(discount_deltas),
        seed=None if _default(seed, None) is None else int(seed),
        fwd_sim_seed=None if _default(fwd_sim_seed, None) is None else int(fwd_sim_seed),
        num_inventory_grid_points=int(_default(num_grid_points, 100)),
        numerical_tolerance=float(_default(numerical_tolerance, 1e-10)),
        extra_decisions=int(_default(extra_decisions, 0)),
    )
    calc_cache.add(name, task)
    task.start()
    return name


@_excel_fn
def subscribe_progress(name: str) -> float:
    """``cmdty.SubscribeProgress``: fraction complete of a named calc."""
    return float(calc_cache.get(name).progress)


@_excel_fn
def subscribe_status(name: str) -> str:
    """``cmdty.SubscribeStatus``: lifecycle status string of a named calc."""
    return calc_cache.get(name).status.value


@_excel_fn
def subscribe_result_property(
    object_handle: str, property_name: str, returned_whilst_waiting=NA
):
    """``cmdty.SubscribeResultProperty``: a property of a finished result;
    returns ``returned_whilst_waiting`` (default ``#N/A``) until done."""
    task = calc_cache.get(object_handle)
    if isinstance(task, AsyncValuation):
        if not task.done():
            return returned_whilst_waiting
        if task.status is not CalcStatus.SUCCESS:
            return f"#ERROR! calculation status is {task.status.value}"
    value = calc_cache.get_property(object_handle, property_name)
    return value


@_excel_fn
def storage_intrinsic_value(
    valuation_date,
    storage_start,
    storage_end,
    ratchets,
    inject_withdraw_interpolation: str,
    injection_cost_rate: float,
    cmdty_consumed_on_injection: float,
    withdrawal_cost_rate: float,
    cmdty_consumed_on_withdrawal: float,
    current_inventory: float,
    forward_curve,
    interest_rate_curve,
    num_grid_points=None,
    numerical_tolerance=None,
) -> float:
    """``cmdty.StorageIntrinsicValue``: synchronous intrinsic NPV."""
    from .engines.intrinsic import intrinsic_value

    storage = _build_storage(
        storage_start, storage_end, ratchets,
        inject_withdraw_interpolation, injection_cost_rate,
        cmdty_consumed_on_injection, withdrawal_cost_rate,
        cmdty_consumed_on_withdrawal, numerical_tolerance,
    )
    results = intrinsic_value(
        storage, str(_day(valuation_date)),
        float(current_inventory),
        _series_from_range(forward_curve, "Forward_curve"),
        _rate_curve_from_range(interest_rate_curve), None,
        num_inventory_grid_points=int(_default(num_grid_points, 100)),
        numerical_tolerance=float(_default(numerical_tolerance, 1e-10)),
    )
    return float(results.npv)


@_excel_fn
def storage_intrinsic_decision_profile(
    valuation_date,
    storage_start,
    storage_end,
    ratchets,
    inject_withdraw_interpolation: str,
    injection_cost_rate: float,
    cmdty_consumed_on_injection: float,
    withdrawal_cost_rate: float,
    cmdty_consumed_on_withdrawal: float,
    current_inventory: float,
    forward_curve,
    interest_rate_curve,
    num_grid_points=None,
    numerical_tolerance=None,
):
    """``cmdty.StorageIntrinsicDecisionProfile``: the intrinsic optimal
    decision profile as a ``[rows, 3]`` table of (period start, inject/
    withdraw volume, cmdty consumed) — ``IntrinsicXl.cs:62-95``."""
    from .engines.intrinsic import intrinsic_value

    storage = _build_storage(
        storage_start, storage_end, ratchets,
        inject_withdraw_interpolation, injection_cost_rate,
        cmdty_consumed_on_injection, withdrawal_cost_rate,
        cmdty_consumed_on_withdrawal, numerical_tolerance,
    )
    results = intrinsic_value(
        storage, str(_day(valuation_date)),
        float(current_inventory),
        _series_from_range(forward_curve, "Forward_curve"),
        _rate_curve_from_range(interest_rate_curve), None,
        num_inventory_grid_points=int(_default(num_grid_points, 100)),
        numerical_tolerance=float(_default(numerical_tolerance, 1e-10)),
    )
    profile = results.profile
    return [
        [
            period.start_time.to_pydatetime(),
            float(profile["inject_withdraw_volume"].iloc[i]),
            float(profile["cmdty_consumed"].iloc[i]),
        ]
        for i, period in enumerate(profile.index)
    ]


@_excel_fn
def storage_value_trinomial_tree(
    valuation_date,
    storage_start,
    storage_end,
    ratchets,
    inject_withdraw_interpolation: str,
    injection_cost_rate: float,
    cmdty_consumed_on_injection: float,
    withdrawal_cost_rate: float,
    cmdty_consumed_on_withdrawal: float,
    current_inventory: float,
    forward_curve,
    spot_volatility_curve,
    mean_reversion: float,
    interest_rate_curve,
    num_grid_points=None,
    numerical_tolerance=None,
) -> float:
    """``cmdty.StorageValueTrinomialTree``: synchronous one-factor tree NPV."""
    from .engines.tree import trinomial_value

    storage = _build_storage(
        storage_start, storage_end, ratchets,
        inject_withdraw_interpolation, injection_cost_rate,
        cmdty_consumed_on_injection, withdrawal_cost_rate,
        cmdty_consumed_on_withdrawal, numerical_tolerance,
    )
    return float(
        trinomial_value(
            storage, str(_day(valuation_date)),
            float(current_inventory),
            _series_from_range(forward_curve, "Forward_curve"),
            spot_volatility=_series_from_range(
                spot_volatility_curve, "Spot_volatility_curve"
            ),
            mean_reversion=float(mean_reversion),
            time_step=1.0 / 365.0,
            interest_rates=_rate_curve_from_range(interest_rate_curve),
            settlement_rule=None,
            num_inventory_grid_points=int(_default(num_grid_points, 100)),
            numerical_tolerance=float(_default(numerical_tolerance, 1e-10)),
        )
    )


@_excel_fn
def storage_value_intrinsic(
    valuation_date,
    storage_start,
    storage_end,
    ratchets,
    inject_withdraw_interpolation: str,
    injection_cost_rate: float,
    cmdty_consumed_on_injection: float,
    withdrawal_cost_rate: float,
    cmdty_consumed_on_withdrawal: float,
    current_inventory: float,
    forward_curve,
    interest_rate_curve,
    num_grid_points=None,
    numerical_tolerance=None,
) -> float:
    """``cmdty.StorageValueIntrinsic``: intrinsic NPV via the backward-
    induction tree DP over the degenerate (zero-vol) forward-path tree —
    ``TrinomialXl.cs:64-95`` / ``TreeStorageValuationExtensions.cs:104-124``."""
    from .engines.tree import intrinsic_tree_value

    storage = _build_storage(
        storage_start, storage_end, ratchets,
        inject_withdraw_interpolation, injection_cost_rate,
        cmdty_consumed_on_injection, withdrawal_cost_rate,
        cmdty_consumed_on_withdrawal, numerical_tolerance,
    )
    return float(
        intrinsic_tree_value(
            storage, str(_day(valuation_date)),
            float(current_inventory),
            _series_from_range(forward_curve, "Forward_curve"),
            _rate_curve_from_range(interest_rate_curve),
            None,
            num_inventory_grid_points=int(_default(num_grid_points, 100)),
            numerical_tolerance=float(_default(numerical_tolerance, 1e-10)),
        )
    )
