"""Basis-function DSL.

The reference parses strings such as ``'1 + s + x_st + x_st**2 + s*x_st'`` and
compiles each monomial with Roslyn C# scripting at runtime
(``BasisFunctionsBuilder.cs:90-131``, ``Sim.cs:30-45``).  Here no codegen is
needed: each monomial reduces to a pair ``(spot_power, factor_powers)`` and the
design matrix is built with vectorised ``jnp`` power/product ops
(:func:`storage_tpu.ops.regression.design_matrix`).

Grammar (whitespace-insensitive)::

    expr     := term ('+' term)*
    term     := factor ('*' factor)*
    factor   := atom ('**' int)?
    atom     := '1' | 's' | 'x<i>' | named factor alias (e.g. 'x_st')

``s`` is the simulated spot price; ``x0..x9`` are the Markov factor states.
``three_factor_seasonal_value`` aliases ``x_st/x_lt/x_sw -> x0/x1/x2``
(reference ``multi_factor.py:349-350``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Tuple, Union

_FACTOR_RE = re.compile(r"^x(\d+)$")
_INT_RE = re.compile(r"^\d+$")

# Aliases used by three_factor_seasonal_value: short-term, long-term, seasonal
# wave factors (reference multi_factor.py:349-350).
THREE_FACTOR_SEASONAL_ALIASES = {"x_st": 0, "x_lt": 1, "x_sw": 2}


@dataclass(frozen=True)
class Monomial:
    """One basis function: ``s**spot_power * prod_i x_i**factor_powers[i]``.

    Supports the reference's operator-combination API
    (``PowerMonomialBuilder.cs:30-76``, ``Sim.cs:30-45``): ``*`` multiplies two
    monomials (powers add), ``**`` raises one to an integer power (powers
    scale), and ``+`` concatenates monomials into a basis-function list that
    every engine accepts alongside the string DSL::

        basis = ones() + S + X(0) + X(0) ** 2 + S * X(0)
    """

    spot_power: int = 0
    factor_powers: Tuple[Tuple[int, int], ...] = ()  # sorted ((factor_idx, power), ...)

    @property
    def max_factor_index(self) -> int:
        return max((i for i, _ in self.factor_powers), default=-1)

    def __str__(self) -> str:
        parts: List[str] = []
        if self.spot_power:
            parts.append("s" if self.spot_power == 1 else f"s**{self.spot_power}")
        for idx, power in self.factor_powers:
            parts.append(f"x{idx}" if power == 1 else f"x{idx}**{power}")
        return " * ".join(parts) if parts else "1"

    def __mul__(self, other: "Monomial") -> "Monomial":
        """Product of two monomials: spot/factor powers add
        (reference ``PowerMonomialBuilder.operator *``)."""
        if not isinstance(other, Monomial):
            return NotImplemented
        powers = dict(self.factor_powers)
        for idx, power in other.factor_powers:
            powers[idx] = powers.get(idx, 0) + power
        return Monomial(
            spot_power=self.spot_power + other.spot_power,
            factor_powers=tuple(sorted(powers.items())),
        )

    def __pow__(self, power: int) -> "Monomial":
        """``m**k``: every exponent scales by ``k``
        (reference ``PowerMonomialBuilder.Pow``)."""
        if not isinstance(power, int) or isinstance(power, bool):
            return NotImplemented
        if power < 0:
            raise ValueError(f"Basis-function powers must be non-negative, got {power}.")
        return Monomial(
            spot_power=self.spot_power * power,
            factor_powers=tuple(
                sorted((i, p * power) for i, p in self.factor_powers)
            ),
        )

    def pow(self, power: int) -> "Monomial":
        """Method form of ``**`` (reference ``PowerMonomialBuilder.Pow``)."""
        return self.__pow__(power)

    def __add__(self, other) -> List["Monomial"]:
        """``m1 + m2`` / ``m + [m1, m2]`` build a basis-function list
        (reference ``PowerMonomialBuilder.operator +`` /
        ``BasisFunctionsBuilder.Combine``)."""
        if isinstance(other, Monomial):
            return [self, other]
        if isinstance(other, (list, tuple)) and all(
            isinstance(m, Monomial) for m in other
        ):
            return [self, *other]
        return NotImplemented

    def __radd__(self, other) -> List["Monomial"]:
        """``[m1, m2] + m`` appends to an existing basis list."""
        if isinstance(other, (list, tuple)) and all(
            isinstance(m, Monomial) for m in other
        ):
            return [*other, self]
        return NotImplemented


def parse_basis_functions(
    expression: str,
    factor_aliases: Optional[Mapping[str, int]] = None,
) -> List[Monomial]:
    """Parse a basis-function expression into a list of monomials.

    Reference behaviour: ``BasisFunctionsBuilder.Parse`` splits on '+', rewrites
    ``xN``/``**k`` and compiles (``BasisFunctionsBuilder.cs:90-131``).  Here the
    result is a plain data structure; no compilation.
    """
    if not expression or not expression.strip():
        raise ValueError("Basis function expression cannot be empty.")
    aliases = dict(factor_aliases or {})
    monomials: List[Monomial] = []
    for term in expression.split("+"):
        term = term.strip()
        if not term:
            raise ValueError(f"Empty term in basis function expression {expression!r}.")
        monomials.append(_parse_term(term, aliases, expression))
    return monomials


def _parse_term(term: str, aliases: Mapping[str, int], full_expr: str) -> Monomial:
    spot_power = 0
    factor_powers: Dict[int, int] = {}
    # Split on single '*' but not '**': temporarily protect the power operator.
    protected = term.replace("**", "^")
    for factor_str in protected.split("*"):
        factor_str = factor_str.strip()
        if not factor_str:
            raise ValueError(f"Malformed term {term!r} in expression {full_expr!r}.")
        if "^" in factor_str:
            base_str, _, power_str = factor_str.partition("^")
            base_str = base_str.strip()
            power_str = power_str.strip()
            if not _INT_RE.match(power_str):
                raise ValueError(
                    f"Invalid power {power_str!r} in term {term!r} of expression {full_expr!r}."
                )
            power = int(power_str)
        else:
            base_str = factor_str
            power = 1
        if base_str == "1":
            if power != 1:
                raise ValueError(f"Cannot raise constant to a power in term {term!r}.")
            continue
        if base_str == "s":
            spot_power += power
            continue
        if base_str in aliases:
            idx = aliases[base_str]
        else:
            match = _FACTOR_RE.match(base_str)
            if not match:
                raise ValueError(
                    f"Unknown symbol {base_str!r} in term {term!r} of expression "
                    f"{full_expr!r}. Expected '1', 's', 'xN' or one of "
                    f"{sorted(aliases)}."
                )
            idx = int(match.group(1))
        factor_powers[idx] = factor_powers.get(idx, 0) + power
    return Monomial(
        spot_power=spot_power,
        factor_powers=tuple(sorted(factor_powers.items())),
    )


def spot_price_power(power: int) -> Monomial:
    """Programmatic basis builder: ``s**power`` (reference ``BasisFunctions.SpotPricePower``)."""
    return Monomial(spot_power=power)


def markov_factor_power(factor_index: int, power: int) -> Monomial:
    """``x_i**power`` (reference ``BasisFunctions.MarkovFactorPower``)."""
    return Monomial(factor_powers=((factor_index, power),))


def ones() -> Monomial:
    """Constant basis function (reference ``BasisFunctions.Ones``)."""
    return Monomial()


def all_markov_powers_up_to(num_factors: int, max_power: int) -> List[Monomial]:
    """1, x_i, x_i**2, ... for every factor.

    Reference: ``BasisFunctions.AllMarkovFactorAllPositiveIntegerPowersUpTo``.
    """
    basis = [ones()]
    for i in range(num_factors):
        for p in range(1, max_power + 1):
            basis.append(markov_factor_power(i, p))
    return basis


#: The simulated spot price as a composable monomial (reference ``Sim.Spot`` /
#: ``Sim.S``, ``Sim.cs:32-33``): ``ones() + S + S**2 + S * X(0)``.
S = Monomial(spot_power=1)


def X(factor_index: int) -> Monomial:
    """Markov factor ``factor_index`` as a composable monomial
    (reference ``Sim.Factor`` / ``Sim.X0..X9``, ``Sim.cs:34-45``)."""
    if factor_index < 0:
        raise ValueError(f"Factor index must be non-negative, got {factor_index}.")
    return markov_factor_power(factor_index, 1)


BasisFunctionsType = Union[str, Iterable[Monomial], Monomial]


def as_monomials(
    basis_funcs: BasisFunctionsType,
    factor_aliases: Optional[Mapping[str, int]] = None,
) -> List[Monomial]:
    """Normalise a basis-function argument to a list of monomials.

    Engines accept either the string DSL (``'1 + s + x0**2'``) or monomials
    composed programmatically with ``+``/``*``/``**`` (reference accepts both
    ``BasisFunctionsBuilder.Parse`` strings and ``PowerMonomialBuilder``
    expressions interchangeably, ``LsmcValuationParameters.cs:80-118``).
    """
    if isinstance(basis_funcs, str):
        return parse_basis_functions(basis_funcs, factor_aliases)
    if isinstance(basis_funcs, Monomial):
        return [basis_funcs]
    monomials = list(basis_funcs)
    if not monomials:
        raise ValueError("Basis function list cannot be empty.")
    bad = [m for m in monomials if not isinstance(m, Monomial)]
    if bad:
        raise TypeError(
            f"basis_funcs must be a DSL string or Monomial objects; got {bad[0]!r}."
        )
    return monomials
