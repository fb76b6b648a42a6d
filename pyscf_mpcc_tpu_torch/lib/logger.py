"""Verbosity-leveled logging with wall/CPU timers.

Reproduces the semantics of the reference logger (pyscf/lib/logger.py:29-192):
levels QUIET(0) < ERROR(3) < WARN(4) < NOTE/INFO(5) < DEBUG(6) < DEBUG1..4,
and ``timer(msg, *t0) -> t1`` for stage timing.
"""

from __future__ import annotations

import sys
import time

QUIET = 0
ERROR = 3
WARN = 4
NOTE = 4
INFO = 5
DEBUG = 6
DEBUG1 = 7
DEBUG2 = 8
TIMER_LEVEL = INFO


class Logger:
    def __init__(self, stdout=None, verbose=INFO):
        self.stdout = stdout or sys.stdout
        self.verbose = verbose

    def _log(self, level, msg, *args):
        if self.verbose >= level:
            print(msg % args if args else msg, file=self.stdout, flush=True)

    def error(self, msg, *args):
        self._log(ERROR, "Error: " + msg, *args)

    def warn(self, msg, *args):
        self._log(WARN, "Warn: " + msg, *args)

    def note(self, msg, *args):
        self._log(NOTE, msg, *args)

    def info(self, msg, *args):
        self._log(INFO, msg, *args)

    def debug(self, msg, *args):
        self._log(DEBUG, msg, *args)

    def debug1(self, msg, *args):
        self._log(DEBUG1, msg, *args)

    def timer(self, msg, cpu0=None, wall0=None):
        if wall0 is None:
            return time.process_time(), time.perf_counter()
        cpu1, wall1 = time.process_time(), time.perf_counter()
        if self.verbose >= TIMER_LEVEL:
            self._log(TIMER_LEVEL, "    CPU time for %s %9.2f sec, wall time %9.2f sec",
                      msg, cpu1 - cpu0, wall1 - wall0)
        return cpu1, wall1


def new_logger(obj=None, verbose=None):
    if verbose is None:
        verbose = getattr(obj, "verbose", INFO)
    return Logger(getattr(obj, "stdout", None), verbose)
