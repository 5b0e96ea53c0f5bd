"""Inventory-space reduction.

Computes, per period, the reachable [min, max] inventory interval as the
intersection of forward reachability (from the starting inventory) and
backward reachability (from the terminal constraints).  Reference:
``StorageHelper.CalculateInventorySpace`` (``StorageHelper.cs:39-107``) plus
the per-constraint ``InventorySpaceUpperBound``/``LowerBound`` solvers
(``ConstantInjectWithdrawConstraint.cs:50-66``,
``PiecewiseLinearInjectWithdrawConstraint.cs:74-160``,
``StepInjectWithdrawConstraint.cs:81-166``).

This runs **once per valuation on the host** in float64 NumPy — it depends only
on the storage configuration and starting inventory, not on simulated paths,
so it stays off the accelerator (see SURVEY.md §7 "Hard parts").
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ..exceptions import InventoryConstraintsCannotBeFulfilledError
from .ratchets import INTERP_LINEAR, INTERP_POLY, INTERP_STEP, interp_rates_host


def _solve_linear(x1: float, y1: float, x2: float, y2: float, y: float) -> float:
    """Solve y = m x + c through two points for x (``StorageHelper.cs:321-330``)."""
    gradient = (y2 - y1) / (x2 - x1)
    constant = y1 - gradient * x1
    return (y - constant) / gradient


def _is_constant_table(pillars: np.ndarray) -> bool:
    return bool(
        np.all(pillars[:, 1] == pillars[0, 1]) and np.all(pillars[:, 2] == pillars[0, 2])
    )


def _poly_bound_roots(coefs: np.ndarray, loss: float, target: float,
                      cur_min: float, cur_max: float,
                      accuracy: float = 1e-9) -> np.ndarray:
    """Real roots of ``x (1 - loss) + poly(x) - target`` within the inventory
    range.  The reference solves the same equation with bracketed
    Newton-Raphson (``PolynomialInjectWithdrawConstraint.cs:87-153``); a direct
    companion-matrix root solve is both exact and simpler here.  ``accuracy``
    (the storage's ``numerical_tolerance``, the analogue of the reference's
    Newton-Raphson accuracy) scales root acceptance at the range edges.
    """
    poly = np.array(coefs, dtype=np.float64)
    poly[-1] -= target
    poly[-2] += 1.0 - loss
    roots = np.roots(poly)
    tol = accuracy * max(1.0, abs(cur_max))
    real = roots[np.abs(roots.imag) < max(1e-8, accuracy)].real
    return real[(real >= cur_min - tol) & (real <= cur_max + tol)]


def upper_bound(
    pillars: np.ndarray,
    interp_kind: int,
    next_lo: float,
    next_hi: float,
    cur_min: float,
    cur_max: float,
    loss: float,
    numerical_tolerance: float = 1e-9,
) -> float:
    """Max inventory this period from which next period's space is reachable."""
    if interp_kind == INTERP_POLY:
        min_at_max, max_at_max = interp_rates_host(pillars, cur_max, interp_kind)
        # Deliberate parity deviation: this feasibility early-return applies
        # the loss factor, consistent with the root equation below; the
        # reference's check omits it (PolynomialInjectWithdrawConstraint.cs:
        # 94-101 uses `currentPeriodMaxInventory + rate`) even though its own
        # PolyToSolve includes `inventory * (1 - inventoryPercentLoss)`
        # (:104-106) — an internal inconsistency that shifts bounds for lossy
        # polynomial-ratchet storages.  Same deviation in lower_bound.
        if (cur_max * (1.0 - loss) + min_at_max <= next_hi
                and next_lo <= cur_max * (1.0 - loss) + max_at_max):
            return cur_max
        candidates = _poly_bound_roots(pillars[:, 3], loss, next_hi, cur_min, cur_max,
                                       numerical_tolerance)
        if len(candidates) == 0:
            raise InventoryConstraintsCannotBeFulfilledError(
                "Storage inventory constraints cannot be satisfied."
            )
        return float(np.clip(candidates.max(), cur_min, cur_max))
    if _is_constant_table(pillars):
        # Reference ConstantInjectWithdrawConstraint.InventorySpaceUpperBound
        min_rate = float(pillars[0, 1])
        solved = (next_hi - min_rate) / (1.0 - loss)
        return min(solved, cur_max)

    min_at_max, max_at_max = interp_rates_host(pillars, cur_max, interp_kind)
    next_max_from_max = cur_max * (1.0 - loss) + max_at_max
    next_min_from_max = cur_max * (1.0 - loss) + min_at_max
    if next_min_from_max <= next_hi and next_lo <= next_max_from_max:
        return cur_max

    if interp_kind == INTERP_LINEAR:
        # Walk pillar brackets downward; inventory-after-max-withdrawal is
        # piecewise linear in inventory (PiecewiseLinear...cs:92-115).
        upper_inv = float(pillars[-1, 0])
        upper_after_withdraw = next_min_from_max
        for i in range(len(pillars) - 2, -1, -1):
            lower_inv = float(pillars[i, 0])
            lower_after_withdraw = lower_inv * (1.0 - loss) + float(pillars[i, 1])
            if (
                lower_after_withdraw <= next_hi <= upper_after_withdraw
                and upper_inv > lower_inv
            ):
                return _solve_linear(
                    lower_inv, lower_after_withdraw, upper_inv, upper_after_withdraw, next_hi
                )
            upper_after_withdraw = lower_after_withdraw
            upper_inv = lower_inv
        raise InventoryConstraintsCannotBeFulfilledError(
            "Storage inventory constraints cannot be satisfied."
        )

    # Step interpolation: rate constant within each bracket; keep the maximum
    # of multiple solutions (Step...cs:99-122).
    solution = None
    for i in range(len(pillars) - 1):
        max_withdraw_rate = float(pillars[i, 1])
        lo_inv = float(pillars[i, 0])
        hi_inv = float(pillars[i + 1, 0])
        if hi_inv <= lo_inv:
            continue
        lo_after = lo_inv * (1.0 - loss) + max_withdraw_rate
        hi_after = hi_inv * (1.0 - loss) + max_withdraw_rate
        if lo_after <= next_hi <= hi_after:
            solution = _solve_linear(lo_inv, lo_after, hi_inv, hi_after, next_hi)
    if solution is None:
        raise InventoryConstraintsCannotBeFulfilledError(
            "Storage inventory constraints cannot be satisfied."
        )
    return solution


def lower_bound(
    pillars: np.ndarray,
    interp_kind: int,
    next_lo: float,
    next_hi: float,
    cur_min: float,
    cur_max: float,
    loss: float,
    numerical_tolerance: float = 1e-9,
) -> float:
    """Min inventory this period from which next period's space is reachable."""
    if interp_kind == INTERP_POLY:
        min_at_min, max_at_min = interp_rates_host(pillars, cur_min, interp_kind)
        if (cur_min * (1.0 - loss) + min_at_min <= next_hi
                and next_lo <= cur_min * (1.0 - loss) + max_at_min):
            return cur_min
        candidates = _poly_bound_roots(pillars[:, 4], loss, next_lo, cur_min, cur_max,
                                       numerical_tolerance)
        if len(candidates) == 0:
            raise InventoryConstraintsCannotBeFulfilledError(
                "Storage inventory constraints cannot be satisfied."
            )
        return float(np.clip(candidates.min(), cur_min, cur_max))
    if _is_constant_table(pillars):
        max_rate = float(pillars[0, 2])
        solved = (next_lo - max_rate) / (1.0 - loss)
        return max(solved, cur_min)

    min_at_min, max_at_min = interp_rates_host(pillars, cur_min, interp_kind)
    next_max_from_min = cur_min * (1.0 - loss) + max_at_min
    next_min_from_min = cur_min * (1.0 - loss) + min_at_min
    if next_min_from_min <= next_hi and next_lo <= next_max_from_min:
        return cur_min

    if interp_kind == INTERP_LINEAR:
        lower_inv = float(pillars[0, 0])
        lower_after_inject = next_max_from_min
        for i in range(1, len(pillars)):
            upper_inv = float(pillars[i, 0])
            upper_after_inject = upper_inv * (1.0 - loss) + float(pillars[i, 2])
            if (
                lower_after_inject <= next_lo <= upper_after_inject
                and upper_inv > lower_inv
            ):
                return _solve_linear(
                    lower_inv, lower_after_inject, upper_inv, upper_after_inject, next_lo
                )
            lower_after_inject = upper_after_inject
            lower_inv = upper_inv
        raise InventoryConstraintsCannotBeFulfilledError(
            "Storage inventory constraints cannot be satisfied."
        )

    solution = None
    for i in range(len(pillars) - 2, -1, -1):
        max_inject_rate = float(pillars[i, 2])
        lo_inv = float(pillars[i, 0])
        hi_inv = float(pillars[i + 1, 0])
        if hi_inv <= lo_inv:
            continue
        lo_after = lo_inv * (1.0 - loss) + max_inject_rate
        hi_after = hi_inv * (1.0 - loss) + max_inject_rate
        if lo_after <= next_lo <= hi_after:
            solution = _solve_linear(lo_inv, lo_after, hi_inv, hi_after, next_lo)
    if solution is None:
        raise InventoryConstraintsCannotBeFulfilledError(
            "Storage inventory constraints cannot be satisfied."
        )
    return solution


@dataclass(frozen=True)
class InventorySpace:
    """Reduced inventory space over steps ``0..n`` (step 0 = first active period).

    ``min_inventory[0] == max_inventory[0] == starting_inventory``; entries
    ``1..n`` correspond to the reference's inventory-space time series
    (``StorageHelper.cs:95-106``).
    """

    min_inventory: np.ndarray  # [n+1]
    max_inventory: np.ndarray  # [n+1]


def calculate_inventory_space(
    pillar_tables: Sequence[np.ndarray],  # per decision step k=0..n-1, [P_k, 3]
    interp_kind: int,
    min_inv: np.ndarray,  # [n+1] storage min inventory per step
    max_inv: np.ndarray,  # [n+1] storage max inventory per step (end adjusted for must-be-empty)
    loss: np.ndarray,  # [n] fractional inventory loss per decision step
    starting_inventory: float,
    must_be_empty_at_end: bool,
    use_native: bool = True,
    numerical_tolerance: float = 1e-9,
) -> InventorySpace:
    """Forward/backward reachability intersection (``StorageHelper.cs:39-107``).

    Dispatches to the native C++ kernel (``csrc/storage_host_ops.cpp``) when
    available — the reduction is a long sequential pillar-walk, the one
    host-side component worth native code at hourly horizons — and falls back
    to this NumPy implementation otherwise.
    """
    if use_native and interp_kind in (INTERP_LINEAR, INTERP_STEP):
        from ..native import inventory_space_native

        native_result = inventory_space_native(
            [np.asarray(t, dtype=np.float64) for t in pillar_tables],
            interp_kind,
            np.asarray(min_inv, dtype=np.float64),
            np.asarray(max_inv, dtype=np.float64),
            np.asarray(loss, dtype=np.float64),
            float(starting_inventory),
            must_be_empty_at_end,
        )
        if native_result is not None:
            return InventorySpace(
                min_inventory=native_result[0], max_inventory=native_result[1]
            )

    n = len(pillar_tables)
    if n + 1 != len(min_inv) or n + 1 != len(max_inv) or n != len(loss):
        raise ValueError("Inconsistent array lengths in calculate_inventory_space.")
    if starting_inventory < min_inv[0] - 1e-12 or starting_inventory > max_inv[0] + 1e-12:
        raise InventoryConstraintsCannotBeFulfilledError(
            f"Starting inventory {starting_inventory} outside storage bounds "
            f"[{min_inv[0]}, {max_inv[0]}] at the first active period."
        )

    fwd_min = np.empty(n + 1, dtype=np.float64)
    fwd_max = np.empty(n + 1, dtype=np.float64)
    fwd_min[0] = fwd_max[0] = starting_inventory
    for k in range(n):
        loss_k = float(loss[k])
        min_rate, _ = interp_rates_host(pillar_tables[k], fwd_min[k], interp_kind)
        fwd_min[k + 1] = max(fwd_min[k] * (1.0 - loss_k) + min_rate, min_inv[k + 1])
        _, max_rate = interp_rates_host(pillar_tables[k], fwd_max[k], interp_kind)
        fwd_max[k + 1] = min(fwd_max[k] * (1.0 - loss_k) + max_rate, max_inv[k + 1])

    back_min = np.empty(n + 1, dtype=np.float64)
    back_max = np.empty(n + 1, dtype=np.float64)
    back_min[n] = 0.0 if must_be_empty_at_end else min_inv[n]
    back_max[n] = 0.0 if must_be_empty_at_end else max_inv[n]
    for k in range(n - 1, 0, -1):
        back_max[k] = upper_bound(
            pillar_tables[k], interp_kind, back_min[k + 1], back_max[k + 1],
            min_inv[k], max_inv[k], float(loss[k]), numerical_tolerance,
        )
        back_min[k] = lower_bound(
            pillar_tables[k], interp_kind, back_min[k + 1], back_max[k + 1],
            min_inv[k], max_inv[k], float(loss[k]), numerical_tolerance,
        )
    back_min[0] = back_max[0] = starting_inventory

    space_min = np.maximum(fwd_min, back_min)
    space_max = np.minimum(fwd_max, back_max)
    space_min[0] = space_max[0] = starting_inventory
    if np.any(space_min > space_max):
        raise InventoryConstraintsCannotBeFulfilledError()
    return InventorySpace(min_inventory=space_min, max_inventory=space_max)
