"""Phase wall-clock profiling.

Equivalent of the reference's ``Stopwatches`` class
(``LsmcValuation/Stopwatches.cs:33-82``): named phase timers around the LSMC
stages plus a pretty percentage-breakdown report logged at INFO at the end of
a calculation (``LsmcStorageValuation.cs:606-612``).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional


class Stopwatches:
    """Named phase timers with an 'All' envelope."""

    PHASES = (
        "RegressionPriceSimulation",
        "ValuationPriceSimulation",
        "BackwardInduction",
        "ForwardSimulation",
    )

    def __init__(self) -> None:
        self._elapsed: Dict[str, float] = {}
        self._started: Dict[str, float] = {}

    def start(self, phase: str) -> None:
        self._started[phase] = time.perf_counter()

    def stop(self, phase: str) -> None:
        t0 = self._started.pop(phase, None)
        if t0 is not None:
            self._elapsed[phase] = self._elapsed.get(phase, 0.0) + time.perf_counter() - t0

    @contextmanager
    def time(self, phase: str):
        self.start(phase)
        try:
            yield
        finally:
            self.stop(phase)

    def elapsed(self, phase: str) -> float:
        return self._elapsed.get(phase, 0.0)

    def generate_profile_report(self) -> str:
        """Percentage-breakdown table like the reference's
        ``GenerateProfileReport`` (``Stopwatches.cs:55-80``)."""
        total = self.elapsed("All")
        lines: List[str] = []
        name_width = max(len(p) for p in list(self.PHASES) + ["All", "Other"])
        for phase in self.PHASES:
            secs = self.elapsed(phase)
            pct = (secs / total * 100.0) if total > 0 else 0.0
            lines.append(f"{phase.ljust(name_width)}  {secs:9.3f} s  {pct:6.2f}%")
        accounted = sum(self.elapsed(p) for p in self.PHASES)
        other = max(total - accounted, 0.0)
        pct_other = (other / total * 100.0) if total > 0 else 0.0
        lines.append(f"{'Other'.ljust(name_width)}  {other:9.3f} s  {pct_other:6.2f}%")
        lines.append(f"{'All'.ljust(name_width)}  {total:9.3f} s  100.00%")
        return "\n".join(lines)
