"""Leveled, tag-filtered logging with progress/ETA reporting.

Keeps the observability model of the reference logger (src/logger.{h,cpp}):
verbosity levels -v..-v9 gate per-call-site messages, named tags
(-log <tag>) activate targeted debug dumps (e.g. "dpmatrix"), ANSI color
is used on TTYs, and long phases get progress lines with an ETA whose
reporting interval widens geometrically (logger.cpp:144-213).  Also
re-serialises its own configuration into CLI flags so remote/batch
workers inherit it (Logger::args, logger.cpp:81-90).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Optional, Set

_COLORS = {
    1: "\x1b[32m",  # green
    2: "\x1b[33m",  # yellow
    3: "\x1b[36m",  # cyan
}
_RESET = "\x1b[0m"
_THREAD_COLOR = "\x1b[35m"  # magenta, like the reference's threadAnsiColor


class Logger:
    def __init__(self):
        self.verbosity = 0
        self.tags: Set[str] = set()
        self.use_color = sys.stderr.isatty()
        self._lock = threading.RLock()
        self._lock_timeout = 1.0
        # thread-name registry + last-owner tracking for interleaving-safe
        # banners (Logger::lock/getThreadName, logger.cpp:92-142)
        self._thread_names: Dict[int, str] = {}
        self._last_owner: Optional[int] = None
        self._owner_site: str = "?"

    # -- thread-name registry (logger.cpp:121-142) -------------------------

    def set_thread_name(self, ident: int, name: str) -> None:
        self._thread_names[ident] = name

    def name_last_thread(self, threads, prefix: str) -> None:
        """Name the most recently spawned thread '<prefix> thread #N'
        (Logger::nameLastThread, logger.cpp:135-138)."""
        self.set_thread_name(threads[-1].ident, f"{prefix} thread #{len(threads)}")

    def erase_thread_name(self, thread: threading.Thread) -> None:
        self._thread_names.pop(thread.ident, None)

    def get_thread_name(self, ident: Optional[int] = None) -> str:
        if ident is None:
            ident = threading.get_ident()
        return self._thread_names.get(ident, f"thread {ident}")

    # -- configuration ----------------------------------------------------

    def parse_args(self, args) -> bool:
        """Consume -verbose/-v*/-log/-nocolor from an arg deque."""
        import re

        if not args:
            return False
        arg = args[0]
        if arg == "-verbose":
            self.verbosity += 1
            args.popleft()
            return True
        if re.fullmatch(r"-v+", arg):
            self.verbosity += len(arg) - 1
            args.popleft()
            return True
        m = re.fullmatch(r"-v(\d+)", arg)
        if m:
            self.verbosity = int(m.group(1))
            args.popleft()
            return True
        if arg == "-log":
            if len(args) < 2:
                raise SystemExit("-log must have an argument")
            args.popleft()
            self.tags.add(args.popleft())
            return True
        if arg == "-nocolor":
            self.use_color = False
            args.popleft()
            return True
        return False

    def args(self) -> str:
        """Re-serialise config for remote workers (logger.cpp:81-90)."""
        parts: List[str] = []
        if self.verbosity > 0:
            parts.append(f"-v{self.verbosity}")
        for tag in sorted(self.tags):
            parts.append(f"-log {tag}")
        if not self.use_color:
            parts.append("-nocolor")
        return (" " + " ".join(parts)) if parts else ""

    # -- gating -----------------------------------------------------------

    def logging_at(self, level: int) -> bool:
        return self.verbosity >= level

    def logging_tag(self, tag: str) -> bool:
        return tag in self.tags

    # -- output -----------------------------------------------------------

    def _banner(self, acquired: bool) -> str:
        """Thread banner written when the log's owner changes, or a
        deadlock-tolerance note when the 1s timed lock fails
        (Logger::lock, logger.cpp:92-112)."""
        me = threading.get_ident()
        if acquired:
            banner = ""
            if self._last_owner != me and len(self._thread_names) > 1:
                name = self.get_thread_name(me)
                banner = (
                    f"{_THREAD_COLOR}({name}){_RESET} "
                    if self.use_color else f"({name}) "
                )
            self._last_owner = me
            return banner
        note = (
            f"({self.get_thread_name(me)}, ignoring lock by "
            f"{self.get_thread_name(self._last_owner)} at {self._owner_site})"
        )
        return (f"{_THREAD_COLOR}{note}{_RESET} " if self.use_color
                else note + " ")

    def _emit(self, text: str) -> None:
        # deadlock-tolerant timed lock: after 1s, log anyway with a note
        # naming the stuck owner instead of blocking (logger.cpp:92-112)
        acquired = self._lock.acquire(timeout=self._lock_timeout)
        try:
            if acquired:
                frame = sys._getframe(2)
                self._owner_site = f"{frame.f_code.co_filename} line {frame.f_lineno}"
            sys.stderr.write(self._banner(acquired) + text)
            sys.stderr.flush()
        finally:
            if acquired:
                self._lock.release()

    def log(self, level: int, message: str) -> None:
        if not self.logging_at(level):
            return
        if self.use_color:
            color = _COLORS.get(min(level, 3), "")
            self._emit(f"{color}{message}{_RESET}\n")
        else:
            self._emit(message + "\n")

    def log_tag(self, tag: str, message: str) -> None:
        if self.logging_tag(tag):
            self._emit(message + "\n")


logger = Logger()


class ProgressLogger:
    """Phase progress with ETA and geometrically widening report interval
    (ProgressLogger, logger.cpp:144-213: 2s doubling up to 10s)."""

    def __init__(self, level: int = 2, min_interval: float = 2.0,
                 max_interval: float = 10.0, log: Optional[Logger] = None):
        self.level = level
        self.logger = log or logger
        self.min_interval = min_interval
        self.max_interval = max_interval
        self._start = None
        self._last_report = None
        self._interval = min_interval
        self._name = ""

    def init_progress(self, name: str) -> None:
        self._name = name
        self._start = time.monotonic()
        self._last_report = self._start
        self._interval = self.min_interval
        self.logger.log(self.level, f"{name}: started")

    def log_progress(self, fraction: float, detail: str = "") -> None:
        if self._start is None or not self.logger.logging_at(self.level):
            return
        now = time.monotonic()
        if now - self._last_report < self._interval:
            return
        self._last_report = now
        self._interval = min(self._interval * 2, self.max_interval)
        elapsed = now - self._start
        if 0 < fraction < 1:
            eta = elapsed * (1 - fraction) / fraction
            msg = (
                f"{self._name}: {fraction * 100:.1f}% "
                f"({detail}) elapsed {elapsed:.0f}s, ETA {eta:.0f}s"
            )
        else:
            msg = f"{self._name}: {fraction * 100:.1f}% ({detail})"
        self.logger.log(self.level, msg)

    def done(self) -> None:
        if self._start is not None:
            elapsed = time.monotonic() - self._start
            self.logger.log(self.level, f"{self._name}: finished in {elapsed:.1f}s")
            self._start = None
