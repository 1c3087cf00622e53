"""What a run carries from its start to its result line: the arguments, the
cell, the clock, what the runner measured in the window, what the traced
slice read, and the numbers compared with the reference."""
from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import Optional


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock: its start
    tick in /proc against the boot clock, where Linux gives them; else now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        return now


@dataclass
class Check:
    """One number compared with the reference, and its limit: the run is
    correct when every value is at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Context:
    args: object
    cell: object
    device: object
    started: float = field(default_factory=process_start)
    window_t0: Optional[float] = None
    window_t1: Optional[float] = None
    measure: dict = field(default_factory=dict)   # the runner's host-clock readings
    trace: dict = field(default_factory=dict)     # the traced slice's readings
    checks: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    phases: list = field(default_factory=list)    # (set-up phase, seconds from process start)

    @property
    def seconds(self) -> float:
        return float(self.args.seconds)

    @property
    def traced(self) -> bool:
        return bool(self.args.trace)

    def mark(self, phase: str) -> None:
        """The end of a set-up phase, printed with the window's start."""
        self.phases.append((phase, time.perf_counter() - self.started))

    def window_start(self) -> None:
        self.window_t0 = time.perf_counter()
        self.measure["setup_s"] = self.window_t0 - self.started
        print("set-up, seconds from process start: " + "; ".join(
            f"{p} {t:.2f}" for p, t in self.phases) + f"; window {self.measure['setup_s']:.2f}",
            file=sys.stderr, flush=True)

    def window_end(self) -> None:
        self.window_t1 = time.perf_counter()
        self.measure["window_s"] = self.window_t1 - self.window_t0

    def elapsed(self) -> float:
        return time.perf_counter() - self.window_t0

    def check(self, name: str, value: float) -> None:
        self.checks.append(Check(name, float(value), float(self.cell.limits[name])))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) and self.failed == 0
