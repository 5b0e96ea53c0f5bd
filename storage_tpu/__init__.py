"""storage_tpu — commodity storage valuation in JAX.

A from-scratch JAX/XLA re-build of the capabilities of ``cmdty/storage``
(C#/.NET + MKL + pythonnet): multi-factor Least-Squares Monte Carlo, intrinsic
and trinomial-tree valuation of commodity storage facilities, with Monte-Carlo
paths as the data-parallel axis over device meshes.

Public API mirrors ``cmdty_storage/__init__.py:24-35``.
"""
from __future__ import annotations

import logging

from .exceptions import InventoryConstraintsCannotBeFulfilledError, StorageError
from .storage import CmdtyStorage
from .types import InjectWithdrawRange, RatchetInterp, TriggerPricePoint, TriggerPriceProfile
from .engines.intrinsic import IntrinsicValuationResults, intrinsic_value
from .engines.lsmc import ValuationCancelledError
from .models.multi_factor import (
    MultiFactorModel,
    MultiFactorSpotSim,
    create_3_factor_season_params,
)
from .valuation import (
    MultiFactorValuationResults,
    multi_factor_value,
    three_factor_seasonal_value,
)
from .engines.tree import (
    TreeValuationResults,
    intrinsic_tree_value,
    trinomial_deltas,
    trinomial_value,
)
from .utils.frequencies import FREQ_TO_PERIOD_TYPE, SUPPORTED_FREQS
from .utils.basis import (
    Monomial,
    S,
    X,
    all_markov_powers_up_to,
    as_monomials,
    markov_factor_power,
    ones,
    parse_basis_functions,
    spot_price_power,
)

# Single source of truth for the package version: pyproject.toml reads this
# attribute via setuptools' dynamic-version mechanism.
__version__ = "0.6.0"

logger: logging.Logger = logging.getLogger("storage_tpu")
logger.addHandler(logging.NullHandler())


def numerics_provider() -> str:
    """Report the numerical backend (reference ``utils.numerics_provider``,
    which reported MKL vs managed — ``utils.py:311-312``)."""
    import jax

    return f"jax/XLA backend={jax.default_backend()}"


__all__ = [
    "CmdtyStorage",
    "RatchetInterp",
    "InjectWithdrawRange",
    "TriggerPricePoint",
    "TriggerPriceProfile",
    "IntrinsicValuationResults",
    "intrinsic_value",
    "MultiFactorModel",
    "MultiFactorSpotSim",
    "MultiFactorValuationResults",
    "multi_factor_value",
    "three_factor_seasonal_value",
    "create_3_factor_season_params",
    "trinomial_value",
    "trinomial_deltas",
    "intrinsic_tree_value",
    "TreeValuationResults",
    "InventoryConstraintsCannotBeFulfilledError",
    "StorageError",
    "ValuationCancelledError",
    "FREQ_TO_PERIOD_TYPE",
    "SUPPORTED_FREQS",
    "parse_basis_functions",
    "as_monomials",
    "Monomial",
    "S",
    "X",
    "ones",
    "spot_price_power",
    "markov_factor_power",
    "all_markov_powers_up_to",
    "numerics_provider",
    "__version__",
]
