"""Least-squares continuation-value regression kernels.

The reference computes a thin-QR pseudo-inverse of the design matrix per
period and applies it to each next-inventory value vector
(``LsmcStorageValuation.cs:185-205``, MKL-backed).  This formulation uses
**normal equations with standardised basis columns**:

    coeffs = (Xs'Xs + lam I)^-1  Xs' V       for all grid columns at once,

which is (a) a pair of large matmuls ``[B,S]x[S,B]`` and ``[B,S]x[S,G]``
followed by a tiny ``[B,B]`` Cholesky solve, and (b) the distributed-ready
form: under a path-sharded mesh both Gram and cross products are ``psum``
reductions over shards (SURVEY.md §2.2 "Parallelism strategies").
Standardising columns (z-scoring non-constant columns) keeps the Gram matrix
well-conditioned so float32 suffices where the reference needed float64 QR.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..utils.basis import Monomial


class BasisSpec(NamedTuple):
    """Static dense encoding of a monomial basis for jit use.

    ``spot_powers[b]`` and ``factor_powers[b, f]`` are integer exponents; the
    design matrix column b is ``s**spot_powers[b] * prod_f x_f**factor_powers[b, f]``.
    """

    spot_powers: Tuple[int, ...]
    factor_powers: Tuple[Tuple[int, ...], ...]  # [B][F]

    @property
    def num_basis(self) -> int:
        return len(self.spot_powers)


def basis_spec(monomials: Sequence[Monomial], num_factors: int) -> BasisSpec:
    """Build a :class:`BasisSpec` from parsed monomials.

    Raises if a monomial references a factor index outside the model
    (mirrors the reference's runtime failure when basis functions index
    missing Markov factors).
    """
    spot_powers = []
    factor_powers = []
    for m in monomials:
        if m.max_factor_index >= num_factors:
            raise ValueError(
                f"Basis function {m} references factor x{m.max_factor_index} but the "
                f"model only has {num_factors} factors."
            )
        spot_powers.append(m.spot_power)
        row = [0] * num_factors
        for idx, power in m.factor_powers:
            row[idx] = power
        factor_powers.append(tuple(row))
    return BasisSpec(tuple(spot_powers), tuple(factor_powers))


def design_matrix(spec: BasisSpec, spot, factors):
    """Design matrix ``[S, B]`` from spot prices ``[S]`` and factors ``[F, S]``.

    Equivalent of ``LsmcStorageValuation.PopulateDesignMatrix``
    (``LsmcStorageValuation.cs:753-770``), fully vectorised.  Exponents are
    static Python ints so XLA sees fixed multiply chains it can fuse.
    """
    columns = []
    for b in range(spec.num_basis):
        col = jnp.ones_like(spot)
        sp = spec.spot_powers[b]
        if sp:
            col = col * spot**sp
        for f, fp in enumerate(spec.factor_powers[b]):
            if fp:
                col = col * factors[f] ** fp
        columns.append(col)
    return jnp.stack(columns, axis=-1)


def standardize_columns(design, eps: float = 1e-12):
    """Z-score non-constant columns of ``design [S, B]``.

    Returns ``(standardized, mean, scale)``; constant columns (e.g. the ones
    basis) pass through with mean 0 / scale 1 so the intercept survives.
    The same (mean, scale) must be re-applied to the valuation-path design
    matrix in the forward pass so saved coefficients stay meaningful
    (reference keeps raw coefficients per period, ``LsmcStorageValuation.cs:206``).
    """
    mean = jnp.mean(design, axis=0)
    var = jnp.mean((design - mean) ** 2, axis=0)
    sd = jnp.sqrt(var)
    is_const = sd <= eps * (1.0 + jnp.abs(mean))
    mean = jnp.where(is_const, 0.0, mean)
    scale = jnp.where(is_const, 1.0, sd)
    return (design - mean) / scale, mean, scale


def fit_continuation(design_std, values, ridge: float = 1e-6):
    """Regression coefficients for every next-grid value column at once.

    Args:
      design_std: standardized design matrix ``[S, B]``.
      values: next-period value-by-sim matrix ``[S, G]``.
      ridge: relative Tikhonov term — scaled by ``S`` because standardized
        Gram diagonals are ~``S``.  Guards the float32 Cholesky against basis
        collinearity; at default it perturbs fitted values by ~1e-7 relative.

    Returns:
      coeffs ``[B, G]`` such that ``design_std @ coeffs`` estimates
      ``E[values | regressors]`` — the pseudo-inverse product of
      ``LsmcStorageValuation.cs:186-199`` reformulated as matmuls.
    """
    num_sims = design_std.shape[0]
    # HIGHEST precision: full f32 products, never TF32 or bf16 passes, whose
    # short mantissa visibly degrades the regression fit and hence the
    # exercise policy (the NPV stays a valid lower bound, just a worse one).
    gram = jnp.dot(
        design_std.T, design_std,
        preferred_element_type=design_std.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    rhs = jnp.dot(
        design_std.T, values,
        preferred_element_type=design_std.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    reg = ridge * num_sims
    gram = gram + reg * jnp.eye(gram.shape[0], dtype=gram.dtype)
    cho = jax.scipy.linalg.cho_factor(gram)
    coeffs = jax.scipy.linalg.cho_solve(cho, rhs)
    # Near-expiry design matrices can be almost perfectly collinear (e.g. the
    # s and s**2 columns one day out), and a float32 Cholesky may then produce
    # NaNs.  Fall back to the zero fit (i.e. predict the column mean when the
    # target is pre-centred) rather than letting NaNs poison the DP — the
    # reference's float64 QR tolerates these steps, a silent NaN would not.
    return jnp.where(jnp.isfinite(coeffs), coeffs, 0.0)
