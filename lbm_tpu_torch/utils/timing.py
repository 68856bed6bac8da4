"""Phase wall-clock timing.

The reference brackets four phases with gettimeofday — Init / Compute /
Collate / Total — and prints them at exit (SerialCode/d2q9-bgk.c:156-200).
PhaseTimer reproduces that observability contract.
"""

from __future__ import annotations

import time


class PhaseTimer:
    """Wall-clock phase timer with the reference's report format."""

    PHASES = ("init", "compute", "collate")

    def __init__(self) -> None:
        self._start: dict[str, float] = {}
        self.elapsed: dict[str, float] = {p: 0.0 for p in self.PHASES}
        self._total_start: float | None = None
        self._total_end: float | None = None

    def start(self, phase: str) -> None:
        now = time.perf_counter()
        if self._total_start is None:
            self._total_start = now
        self._start[phase] = now

    def stop(self, phase: str) -> float:
        now = time.perf_counter()
        dt = now - self._start.pop(phase)
        self.elapsed[phase] = self.elapsed.get(phase, 0.0) + dt
        self._total_end = now
        return dt

    class _Section:
        def __init__(self, timer: "PhaseTimer", phase: str):
            self._timer, self._phase = timer, phase

        def __enter__(self):
            self._timer.start(self._phase)
            return self

        def __exit__(self, *exc):
            self._timer.stop(self._phase)
            return False

    def section(self, phase: str) -> "PhaseTimer._Section":
        return PhaseTimer._Section(self, phase)

    @property
    def total(self) -> float:
        if self._total_start is None or self._total_end is None:
            return 0.0
        return self._total_end - self._total_start

    def report(self) -> str:
        """Text block matching the reference's exit report
        (SerialCode/d2q9-bgk.c:197-200)."""
        lines = [
            "Elapsed Init time:\t\t\t%.6f (s)" % self.elapsed.get("init", 0.0),
            "Elapsed Compute time:\t\t\t%.6f (s)" % self.elapsed.get("compute", 0.0),
            "Elapsed Collate time:\t\t\t%.6f (s)" % self.elapsed.get("collate", 0.0),
            "Elapsed Total time:\t\t\t%.6f (s)" % self.total,
        ]
        return "\n".join(lines)
