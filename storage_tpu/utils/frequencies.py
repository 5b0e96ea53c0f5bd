"""Calendar frequency registry.

Replacement for the reference's ``Cmdty.TimePeriodValueTypes`` period
types (QuarterHour/HalfHour/Hour/Day/Month/Quarter) and the Python wrapper's
``FREQ_TO_PERIOD_TYPE`` dict (reference: ``cmdty_storage/utils.py:118-133``).

Inside jitted code periods are plain integer step indices; pandas ``Period`` /
``PeriodIndex`` objects only appear at the API boundary.  This module maps the
user-facing frequency aliases onto pandas frequencies and provides the period
coercion helpers that the reference implements via .NET interop
(``utils.py:48-72``).
"""
from __future__ import annotations

from datetime import date, datetime
from typing import Union

import pandas as pd

# Allowable storage granularities, mirroring the reference's FREQ_TO_PERIOD_TYPE
# keys ('15min', '30min', 'H', 'D', 'M', 'Q').  pandas>=3 renamed 'H' to 'h', so
# both spellings are accepted and normalised.
_FREQ_ALIASES = {
    "15min": "15min",
    "30min": "30min",
    "H": "h",
    "h": "h",
    "D": "D",
    "M": "M",
    "Q": "Q",
}

SUPPORTED_FREQS = tuple(_FREQ_ALIASES)

#: Drop-in-compat alias for the reference's ``FREQ_TO_PERIOD_TYPE`` registry
#: (``cmdty_storage/utils.py:118-133``): the reference maps freq strings to
#: CLR time-period types; here the "period type" IS the normalized pandas
#: Period freqstr each alias resolves to.
FREQ_TO_PERIOD_TYPE = dict(_FREQ_ALIASES)

PeriodLike = Union[str, date, datetime, pd.Period]


def normalize_freq(freq: str) -> str:
    """Validate and canonicalise a frequency alias.

    Raises ``ValueError`` for unsupported frequencies, matching the reference's
    check in ``cmdty_storage.py:78-79``.
    """
    try:
        return _FREQ_ALIASES[freq]
    except KeyError:
        # pandas reports calendar quarters with a year-end anchor ('Q-DEC');
        # the reference's Quarter type is calendar-anchored, i.e. 'Q'.
        if isinstance(freq, str) and freq.startswith("Q-"):
            return "Q"
        raise ValueError(
            "freq parameter value of '{}' not supported. The allowable values "
            "are {}.".format(freq, sorted(set(_FREQ_ALIASES)))
        ) from None


def to_period(period_like: PeriodLike, freq: str) -> pd.Period:
    """Coerce a str/date/datetime/Period to a ``pd.Period`` of ``freq``.

    Mirrors ``utils.from_datetime_like`` (reference ``utils.py:48-51``): a
    Period of a different frequency is converted via its start time.
    """
    freq = normalize_freq(freq)
    if isinstance(period_like, pd.Period):
        if period_like.freqstr == pd.Period("2020", freq=freq).freqstr:
            return period_like
        return pd.Period(period_like.start_time, freq=freq)
    if isinstance(period_like, str):
        return pd.Period(period_like, freq=freq)
    if isinstance(period_like, (datetime, date)):
        return pd.Period(pd.Timestamp(period_like), freq=freq)
    raise TypeError(
        f"Cannot convert object of type {type(period_like)!r} to a pandas Period."
    )


def period_range(start: PeriodLike, end: PeriodLike, freq: str) -> pd.PeriodIndex:
    """Inclusive period range at the given frequency."""
    freq = normalize_freq(freq)
    return pd.period_range(start=to_period(start, freq), end=to_period(end, freq), freq=freq)


def to_day(date_like: PeriodLike) -> date:
    """Coerce to a calendar day (reference ``time_func._to_date``)."""
    if isinstance(date_like, pd.Period):
        ts = date_like.start_time
        return date(ts.year, ts.month, ts.day)
    if isinstance(date_like, str):
        ts = pd.Timestamp(date_like)
        return date(ts.year, ts.month, ts.day)
    if isinstance(date_like, datetime):
        return date_like.date()
    if isinstance(date_like, date):
        return date_like
    raise TypeError(f"Cannot convert object of type {type(date_like)!r} to a date.")


def period_start_day(period: pd.Period) -> date:
    """First calendar day of a period (reference ``period.First<Day>()``)."""
    ts = period.start_time
    return date(ts.year, ts.month, ts.day)


def days_index(obj) -> "np.ndarray":
    """Vectorised :func:`to_day`: an array of ``datetime64[D]`` for any
    period/date collection.

    Per-element ``Period.start_time`` costs ~0.1 ms each inside pandas (it
    dominated the host share of the headline valuation at daily resolution);
    ``PeriodIndex.to_timestamp()`` converts the whole index in one C call.
    Falls back to the scalar coercion for heterogeneous sequences.
    """
    import numpy as np

    if isinstance(obj, pd.PeriodIndex):
        return obj.to_timestamp().values.astype("datetime64[D]")
    if isinstance(obj, pd.DatetimeIndex):
        return obj.values.astype("datetime64[D]")
    if isinstance(obj, np.ndarray) and np.issubdtype(obj.dtype, np.datetime64):
        return obj.astype("datetime64[D]")
    return np.array([np.datetime64(to_day(x)) for x in obj], dtype="datetime64[D]")
