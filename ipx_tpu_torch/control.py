"""Run control: parameters access, logging, timing, time-limit interrupt.

Counterpart of the reference's control object (reference: src/control.{h,cc})
plus its multistream log fan-out (reference: src/multistream.h:15-50) and
wall-clock timer (reference: src/timer.h:10-22). A single Control instance is
shared by every component of one solve; it is the sole owner of log sinks and
the interrupt clock.

The port's copy of ipx_tpu/control.py.
"""
from __future__ import annotations

import sys
import time
from typing import Iterable, Optional

from .parameters import Parameters
from .status import Errflag, InterruptError


class Timer:
    """Wall-clock stopwatch (reference: src/timer.h:10-22)."""

    __slots__ = ("_start",)

    def __init__(self):
        self._start = time.perf_counter()

    def reset(self) -> None:
        self._start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._start


class Control:
    """Shared parameter/log/interrupt hub (reference: src/control.h:28-114).

    Logging levels:
      log(msg)        -- always shown when display!=0 (and to logfile)
      debug(msg, lvl) -- shown when parameters.debug >= lvl
      interval_log()  -- rate-limited progress lines, at most one per
                         print_interval seconds (reference: src/control.cc:24-47)
    """

    def __init__(self, parameters: Optional[Parameters] = None):
        self.parameters = parameters if parameters is not None else Parameters()
        self._timer = Timer()
        self._logfile = None
        self._logfile_path = None
        self._last_interval = 0.0
        self.dump_info = False   # print full Info after solve (debug >= 2)

    # -- parameters ---------------------------------------------------
    def set_parameters(self, parameters: Parameters) -> None:
        self.parameters = parameters

    # -- timing / interrupt -------------------------------------------
    def reset_timer(self) -> None:
        self._timer.reset()
        self._last_interval = 0.0

    def elapsed(self) -> float:
        return self._timer.elapsed()

    def interrupt_check(self) -> None:
        """Raise InterruptError when over the time limit. Polled in every
        long-running loop (reference: src/control.cc:17-22)."""
        tl = self.parameters.time_limit
        if tl >= 0 and self._timer.elapsed() >= tl:
            raise InterruptError(Errflag.INTERRUPT_TIME)

    # -- logging ------------------------------------------------------
    def open_logfile(self) -> None:
        path = self.parameters.logfile
        if path and path != self._logfile_path:
            self.close_logfile()
            self._logfile = open(path, "a")
            self._logfile_path = path

    def close_logfile(self) -> None:
        if self._logfile is not None:
            self._logfile.close()
            self._logfile = None
            self._logfile_path = None

    def _emit(self, text: str) -> None:
        if self.parameters.display:
            sys.stdout.write(text)
            sys.stdout.flush()
        if self._logfile is not None:
            self._logfile.write(text)
            self._logfile.flush()

    def log(self, text: str) -> None:
        self._emit(text)

    def debug(self, text: str, level: int = 1) -> None:
        if self.parameters.debug >= level:
            self._emit(text)

    def interval_log(self, text: str) -> None:
        """Emit at most once per print_interval seconds of wall clock."""
        now = self._timer.elapsed()
        interval = self.parameters.print_interval
        if interval >= 0 and now - self._last_interval >= interval:
            self._emit(text)
            self._last_interval = now

    def reset_print_interval(self) -> None:
        self._last_interval = self._timer.elapsed()

    # -- formatting helpers (reference: src/control.h:117-153) --------
    @staticmethod
    def textline(name: str) -> str:
        """Left-aligned 'name' padded for two-column summary output."""
        return f"{name:<45}"

    def __del__(self):
        try:
            self.close_logfile()
        except Exception:
            pass


def format_duration(seconds: float) -> str:
    if seconds < 100:
        return f"{seconds:.2f}s"
    return f"{seconds:.0f}s"
