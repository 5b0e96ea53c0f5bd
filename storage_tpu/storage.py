"""The commodity-storage entity.

Replacement for the reference's ``CmdtyStorage<T>`` C# entity +
fluent builder (``StorageEntity/CmdtyStorage.cs:39-569``) and the Python
wrapper class (``cmdty_storage/cmdty_storage.py:58-278``).  The reference
represents every parameter as an opaque ``Func<T, ...>``; the only thing any
engine ever does with those functions is evaluate them on the storage's period
range, so here construction *compiles* all parameters straight to dense
step-indexed float64 arrays.  Engines slice the active window and ship the
arrays to device — no callback dispatch inside hot loops.
"""
from __future__ import annotations

import logging
from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import pandas as pd

from .ops.ratchets import INTERP_LINEAR, INTERP_POLY, INTERP_STEP, pad_pillars
from .types import InjectWithdrawRange, RatchetInterp
from .utils.frequencies import PeriodLike, normalize_freq, to_period

logger = logging.getLogger("storage_tpu")

ScalarOrSeries = Union[None, float, int, pd.Series]
RatchetsType = Optional[Iterable[Tuple[PeriodLike, Iterable[Tuple[float, float, float]]]]]


def _is_scalar(arg) -> bool:
    """Reference ``utils.is_scalar`` (``utils.py:104-105``)."""
    return isinstance(arg, (int, float)) and not isinstance(arg, bool)


def _raise_if_none(arg, message: str) -> None:
    if arg is None:
        raise ValueError(message)


def _raise_if_not_none(arg, message: str) -> None:
    if arg is not None:
        raise ValueError(message)


def _series_to_steps(
    series: pd.Series,
    periods: pd.PeriodIndex,
    param_description: str,
    required_end: pd.Period,
) -> np.ndarray:
    """Sample a pandas Series onto the storage period range.

    Enforces the reference builder's coverage checks: the series must start on
    or before the storage start and extend through ``required_end``
    (``CmdtyStorage.cs:343-358``).  Lookup is exact by period (no forward
    filling), matching ``TimeSeries`` indexing.
    """
    if len(series) == 0:
        raise ValueError(f"{param_description} time series cannot be empty.")
    idx = series.index
    if not isinstance(idx, pd.PeriodIndex):
        raise ValueError(f"{param_description} time series must have a PeriodIndex.")
    if idx.freqstr != periods.freqstr:
        raise ValueError(
            f"{param_description} time series frequency {idx.freqstr} differs from "
            f"storage frequency {periods.freqstr}."
        )
    if idx[0] > periods[0]:
        raise ValueError(
            f"{param_description} time series starts at {idx[0]} which is later than "
            f"the storage start period {periods[0]}."
        )
    if idx[-1] < required_end:
        raise ValueError(
            f"{param_description} time series ends at {idx[-1]} which is earlier than "
            f"{required_end}."
        )
    reindexed = series.reindex(periods)
    if reindexed.isna().any():
        missing = reindexed[reindexed.isna()].index[0]
        raise ValueError(f"{param_description} time series has no value for period {missing}.")
    return reindexed.to_numpy(dtype=np.float64)


class CmdtyStorage:
    """Ownership of a commodity storage facility, virtual or physical.

    Constructor signature and validation matrix mirror the reference Python
    wrapper (``cmdty_storage.py:60-206``):

    - Either ``ratchets`` + ``ratchet_interp`` *or* the quartet
      ``min_inventory``/``max_inventory``/``max_injection_rate``/
      ``max_withdrawal_rate`` must be provided, never a mixture.
    - Every rate/cost parameter accepts a scalar or a ``pd.Series`` over the
      storage's active periods.
    - ``terminal_storage_npv=None`` means the storage must be empty at end
      (reference ``builder.MustBeEmptyAtEnd()``, ``cmdty_storage.py:195-199``);
      otherwise it is a callable ``(cmdty_price, final_inventory) -> float``
      implemented with jax.numpy-compatible ops.
    """

    def __init__(
        self,
        freq: str,
        storage_start: PeriodLike,
        storage_end: PeriodLike,
        injection_cost: Union[float, pd.Series],
        withdrawal_cost: Union[float, pd.Series],
        ratchets: RatchetsType = None,
        ratchet_interp: Optional[RatchetInterp] = None,
        min_inventory: ScalarOrSeries = None,
        max_inventory: ScalarOrSeries = None,
        max_injection_rate: ScalarOrSeries = None,
        max_withdrawal_rate: ScalarOrSeries = None,
        cmdty_consumed_inject: ScalarOrSeries = None,
        cmdty_consumed_withdraw: ScalarOrSeries = None,
        terminal_storage_npv: Optional[Callable[[float, float], float]] = None,
        inventory_loss: ScalarOrSeries = None,
        inventory_cost: ScalarOrSeries = None,
        cost_cash_flow_rule: Optional[Callable[[pd.Period], "object"]] = None,
        numerical_tolerance: float = 1e-9,
    ):
        # Root-acceptance tolerance for polynomial-ratchet inventory-space
        # bound solves; the analogue of the reference's per-constraint
        # Newton-Raphson accuracy (PolynomialInjectWithdrawConstraint.cs:46,
        # set from Excel via PolynomialWithParams, StorageExcelHelper.cs:164).
        if numerical_tolerance <= 0:
            raise ValueError("numerical_tolerance must be a positive number.")
        self._numerical_tolerance = float(numerical_tolerance)
        self._freq = freq
        norm_freq = normalize_freq(freq)
        start = to_period(storage_start, norm_freq)
        end = to_period(storage_end, norm_freq)
        if start >= end:
            raise ValueError("Storage start period must be before end period.")
        # periods covers [start .. end] inclusive; decision steps are [start .. end-1].
        periods = pd.period_range(start=start, end=end, freq=norm_freq)
        self._periods = periods
        decision_periods = periods[:-1]
        last_active = periods[-2]
        n = len(decision_periods)

        if ratchets is not None:
            _raise_if_not_none(min_inventory, "min_inventory parameter should not be provided if ratchets parameter is provided.")
            _raise_if_not_none(max_inventory, "max_inventory parameter should not be provided if ratchets parameter is provided.")
            _raise_if_not_none(max_injection_rate, "max_injection_rate parameter should not be provided if ratchets parameter is provided.")
            _raise_if_not_none(max_withdrawal_rate, "max_withdrawal_rate parameter should not be provided if ratchets parameter is provided.")
            _raise_if_none(ratchet_interp, "ratchet_interp parameter should be provided if ratchets parameter is provided.")
            if ratchet_interp == RatchetInterp.STEP and terminal_storage_npv is None:
                logger.warning(
                    "When ratchet_interp is RatchetInterp.STEP it is advisable to specify "
                    "terminal_storage_npv otherwise exceptions are likely to occur during valuation."
                )
            self._interp_kind = {
                RatchetInterp.LINEAR: INTERP_LINEAR,
                RatchetInterp.STEP: INTERP_STEP,
                RatchetInterp.POLYNOMIAL: INTERP_POLY,
            }[ratchet_interp]
            tables, min_inv_arr, max_inv_arr = self._compile_ratchets(
                ratchets, periods, norm_freq, self._interp_kind
            )
        else:
            _raise_if_not_none(ratchet_interp, "ratchet_interp should not be provided if ratchets parameter is not provided.")
            _raise_if_none(min_inventory, "min_inventory parameter should be provided if ratchets parameter is not provided.")
            _raise_if_none(max_inventory, "max_inventory parameter should be provided if ratchets parameter is not provided.")
            _raise_if_none(max_injection_rate, "max_injection_rate parameter should be provided if ratchets parameter is not provided.")
            _raise_if_none(max_withdrawal_rate, "max_withdrawal_rate parameter should be provided if ratchets parameter is not provided.")
            self._interp_kind = INTERP_LINEAR
            min_inv_arr = self._scalar_or_series(
                min_inventory, periods, "Minimum inventory", periods[-1], allow_none=False
            )
            max_inv_arr = self._scalar_or_series(
                max_inventory, periods, "Maximum inventory", periods[-1], allow_none=False
            )
            if np.any(min_inv_arr < 0):
                raise ValueError("Minimum inventory must be non-negative.")
            if np.any(max_inv_arr < 0):
                raise ValueError("Maximum inventory must be non-negative.")
            inj_rate = self._scalar_or_series(
                max_injection_rate, decision_periods, "Max injection rate", last_active, allow_none=False
            )
            wdr_rate = self._scalar_or_series(
                max_withdrawal_rate, decision_periods, "Max withdrawal rate", last_active, allow_none=False
            )
            # Constant-rate constraint == 2-pillar table with equal rates.
            tables = [
                np.array(
                    [
                        [min_inv_arr[k], -wdr_rate[k], inj_rate[k]],
                        [max(max_inv_arr[k], min_inv_arr[k] + 1.0), -wdr_rate[k], inj_rate[k]],
                    ],
                    dtype=np.float64,
                )
                for k in range(n)
            ]

        self._pillar_tables: List[np.ndarray] = tables
        self._pillars_padded = pad_pillars(tables)
        self._min_inventory = min_inv_arr
        self._max_inventory = max_inv_arr

        self._injection_cost = self._scalar_or_series(
            injection_cost, decision_periods, "Per unit injection cost", last_active,
            allow_none=False,
        )
        if np.any(self._injection_cost < 0):
            raise ValueError("Per unit inject cost must be non-negative.")
        self._withdrawal_cost = self._scalar_or_series(
            withdrawal_cost, decision_periods, "Per unit withdrawal cost", last_active,
            allow_none=False,
        )
        if np.any(self._withdrawal_cost < 0):
            raise ValueError("Per unit withdrawal cost must be non-negative.")
        self._cmdty_consumed_inject = self._scalar_or_series(
            cmdty_consumed_inject, decision_periods, "Percentage of cmdty consumed on inject", last_active
        )
        self._cmdty_consumed_withdraw = self._scalar_or_series(
            cmdty_consumed_withdraw, decision_periods, "Percentage of cmdty consumed on withdraw", last_active
        )
        self._inventory_loss = self._scalar_or_series(
            inventory_loss, decision_periods, "Cmdty inventory loss", last_active
        )
        self._inventory_cost = self._scalar_or_series(
            inventory_cost, decision_periods, "Per unit inventory cost", last_active
        )

        # Cash-flow date for inject/withdraw/inventory costs: period start day
        # by default (reference ``WithPerUnitInjectionCost``,
        # ``CmdtyStorage.cs:334-341``); a callable period -> date reproduces the
        # reference's custom cash-flow-date overloads (:322-331).
        self._cost_cash_flow_rule = cost_cash_flow_rule

        self._must_be_empty_at_end = terminal_storage_npv is None
        self._terminal_npv = terminal_storage_npv
        if self._must_be_empty_at_end:
            # Reference Build() wraps max inventory to zero at/after the end
            # period when MustBeEmptyAtEnd (CmdtyStorage.cs:435-442).
            self._max_inventory = self._max_inventory.copy()
            self._max_inventory[-1] = 0.0

    @staticmethod
    def _scalar_or_series(
        value: ScalarOrSeries,
        periods: pd.PeriodIndex,
        description: str,
        required_end: pd.Period,
        allow_none: bool = True,
    ) -> np.ndarray:
        if value is None:
            if not allow_none:
                raise ValueError(f"{description} must be provided.")
            return np.zeros(len(periods), dtype=np.float64)
        if _is_scalar(value):
            return np.full(len(periods), float(value), dtype=np.float64)
        if isinstance(value, pd.Series):
            return _series_to_steps(value, periods, description, required_end)
        raise TypeError(f"{description} must be a scalar or pandas Series, got {type(value)!r}.")

    @staticmethod
    def _compile_ratchets(
        ratchets: RatchetsType,
        periods: pd.PeriodIndex,
        freq: str,
        interp_kind: int,
    ) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
        """Forward-fill ratchet tables over periods and derive min/max inventory.

        Mirrors ``CmdtyStorageBuilderExtensions.AddInjectWithdrawRanges``
        (``CmdtyStorageBuilderExtensions.cs:142-257``): each table applies from
        its period until the next table's period; per-period min/max inventory
        are the min/max pillar inventories; step tables must have equal rates
        on the top two pillars and monotone rates
        (``StepInjectWithdrawConstraint.cs:48-68``).
        """
        parsed: List[Tuple[pd.Period, np.ndarray]] = []
        for period_like, rows in ratchets:
            period = to_period(period_like, freq)
            table = np.array(
                [[float(inv), float(min_rate), float(max_rate)] for inv, min_rate, max_rate in rows],
                dtype=np.float64,
            )
            if table.shape[0] < 2:
                raise ValueError(
                    f"Period {period} contains less than 2 inject/withdraw/inventory constraints."
                )
            order = np.argsort(table[:, 0])
            table = table[order]
            if np.any(table[:, 1] > table[:, 2]):
                raise ValueError(
                    f"Ratchet table for period {period} has min rate above max rate."
                )
            if interp_kind == INTERP_STEP:
                tol = 1e-12
                if abs(table[-1, 2] - table[-2, 2]) > tol:
                    raise ValueError("Top two ratchets do not have the same max injection rate.")
                if abs(table[-1, 1] - table[-2, 1]) > tol:
                    raise ValueError("Top two ratchets do not have the same max withdrawal rate.")
                for i in range(1, table.shape[0] - 1):
                    if table[i, 2] > table[i - 1, 2]:
                        raise ValueError("Ratchet injection rates cannot increase with inventory.")
                    if table[i, 1] > table[i - 1, 1]:
                        raise ValueError("Ratchet withdrawal rates cannot decrease with inventory.")
            if interp_kind == INTERP_POLY:
                # Exact-fit polynomial through the ratchet points, order
                # num_pillars - 1 (PolynomialInjectWithdrawConstraint.cs:46-79).
                # Coefficients (highest power first) ride in columns 3/4.
                deg = table.shape[0] - 1
                cmin = np.polyfit(table[:, 0], table[:, 1], deg)
                cmax = np.polyfit(table[:, 0], table[:, 2], deg)
                table = np.column_stack([table, cmin, cmax])
            parsed.append((period, table))
        if not parsed:
            raise ValueError("No inject/withdraw constraints provided.")
        parsed.sort(key=lambda item: item[0])
        for (p1, _), (p2, _) in zip(parsed, parsed[1:]):
            if p1 == p2:
                raise ValueError("Repeated periods found in inject/withdraw ranges.")
        if parsed[0][0] > periods[0]:
            raise ValueError(
                f"First ratchet period {parsed[0][0]} is after the storage start {periods[0]}; "
                "ratchets must cover the storage start period."
            )

        tables: List[np.ndarray] = []
        min_inv = np.empty(len(periods), dtype=np.float64)
        max_inv = np.empty(len(periods), dtype=np.float64)
        cursor = 0
        current = parsed[0][1]
        for i, period in enumerate(periods):
            while cursor < len(parsed) and parsed[cursor][0] <= period:
                current = parsed[cursor][1]
                cursor += 1
            if i < len(periods) - 1:
                tables.append(current)
            min_inv[i] = current[0, 0]
            max_inv[i] = current[-1, 0]
        return tables, min_inv, max_inv

    # ------------------------------------------------------------------ #
    # Introspection API mirroring cmdty_storage.CmdtyStorage accessors   #
    # (cmdty_storage.py:208-277) and ICmdtyStorage<T>.                   #
    # ------------------------------------------------------------------ #

    @property
    def freq(self) -> str:
        return self._freq

    @property
    def numerical_tolerance(self) -> float:
        return self._numerical_tolerance

    @property
    def empty_at_end(self) -> bool:
        return self._must_be_empty_at_end

    @property
    def must_be_empty_at_end(self) -> bool:
        return self._must_be_empty_at_end

    @property
    def start(self) -> pd.Period:
        return self._periods[0]

    @property
    def end(self) -> pd.Period:
        return self._periods[-1]

    @property
    def periods(self) -> pd.PeriodIndex:
        """All storage periods [start .. end] inclusive."""
        return self._periods

    @property
    def num_decision_steps(self) -> int:
        return len(self._periods) - 1

    @property
    def interp_kind(self) -> int:
        return self._interp_kind

    @property
    def pillar_tables(self) -> List[np.ndarray]:
        """Exact per-decision-step ratchet tables (host use)."""
        return self._pillar_tables

    @property
    def pillars_padded(self) -> np.ndarray:
        """``[n, P, 3]`` padded pillar tensor (device use)."""
        return self._pillars_padded

    def _step_index(self, period: PeriodLike, *, allow_end: bool = False) -> int:
        p = to_period(period, normalize_freq(self._freq))
        offset = (p - self._periods[0]).n
        limit = len(self._periods) - (0 if allow_end else 1)
        if offset < 0 or offset >= limit:
            raise ValueError(
                f"Period {p} outside storage range [{self.start}, {self.end}]."
            )
        return offset

    def inject_withdraw_range(self, period: PeriodLike, inventory: float) -> InjectWithdrawRange:
        """Rates at (period, inventory); validates inventory bounds and returns
        (0, 0) at/after the end period (``CmdtyStorage.cs:86-100``)."""
        p = to_period(period, normalize_freq(self._freq))
        k = self._step_index(p, allow_end=True)
        min_inv, max_inv = self._min_inventory[k], self._max_inventory[k]
        if inventory < min_inv:
            raise ValueError(
                f"Inventory of {inventory} is below minimum allowed value of {min_inv} during period {p}."
            )
        if inventory > max_inv:
            raise ValueError(
                f"Inventory of {inventory} above maximum allowed value of {max_inv} during period {p}."
            )
        if p >= self.end:
            return InjectWithdrawRange(0.0, 0.0)
        from .ops.ratchets import interp_rates_host

        min_rate, max_rate = interp_rates_host(self._pillar_tables[k], inventory, self._interp_kind)
        return InjectWithdrawRange(min_rate, max_rate)

    def min_inventory(self, period: PeriodLike) -> float:
        return float(self._min_inventory[self._step_index(period, allow_end=True)])

    def max_inventory(self, period: PeriodLike) -> float:
        return float(self._max_inventory[self._step_index(period, allow_end=True)])

    def injection_cost(self, period: PeriodLike, inventory: float, injected_volume: float) -> float:
        k = self._step_index(period)
        return float(self._injection_cost[k] * injected_volume)

    def withdrawal_cost(self, period: PeriodLike, inventory: float, withdrawn_volume: float) -> float:
        k = self._step_index(period)
        return float(self._withdrawal_cost[k] * abs(withdrawn_volume))

    def cmdty_consumed_inject(self, period: PeriodLike, inventory: float, injected_volume: float) -> float:
        k = self._step_index(period)
        return float(self._cmdty_consumed_inject[k] * abs(injected_volume))

    def cmdty_consumed_withdraw(self, period: PeriodLike, inventory: float, withdrawn_volume: float) -> float:
        k = self._step_index(period)
        return float(self._cmdty_consumed_withdraw[k] * abs(withdrawn_volume))

    def terminal_storage_npv(self, cmdty_price: float, terminal_inventory: float) -> float:
        if self._terminal_npv is None:
            return 0.0
        return float(self._terminal_npv(cmdty_price, terminal_inventory))

    @property
    def terminal_npv_fn(self) -> Optional[Callable[[float, float], float]]:
        return self._terminal_npv

    @property
    def cost_cash_flow_rule(self):
        return self._cost_cash_flow_rule

    def inventory_pcnt_loss(self, period: PeriodLike) -> float:
        return float(self._inventory_loss[self._step_index(period)])

    def inventory_cost(self, period: PeriodLike, inventory: float) -> float:
        return float(self._inventory_cost[self._step_index(period)] * inventory)

    # Dense array accessors for the valuation compiler --------------------- #

    @property
    def min_inventory_by_step(self) -> np.ndarray:
        return self._min_inventory

    @property
    def max_inventory_by_step(self) -> np.ndarray:
        return self._max_inventory

    @property
    def injection_cost_by_step(self) -> np.ndarray:
        return self._injection_cost

    @property
    def withdrawal_cost_by_step(self) -> np.ndarray:
        return self._withdrawal_cost

    @property
    def cmdty_consumed_inject_by_step(self) -> np.ndarray:
        return self._cmdty_consumed_inject

    @property
    def cmdty_consumed_withdraw_by_step(self) -> np.ndarray:
        return self._cmdty_consumed_withdraw

    @property
    def inventory_loss_by_step(self) -> np.ndarray:
        return self._inventory_loss

    @property
    def inventory_cost_by_step(self) -> np.ndarray:
        return self._inventory_cost
