"""Progress reporting and fatal-error helpers.

Reproduces the reference's progress/log line format
(CompAIRR src/util.cc:24-88): when logging to stderr, a prompt
followed by carriage-return-redrawn percentages; when logging to a file
(-l), just the prompt and a final " 100% (<seconds>s)" line. Every
phase of every command is wrapped in these.
"""

from __future__ import annotations

import sys
import time
from typing import IO, Optional


class Fatal(SystemExit):
    """Raised for fatal errors; exits with status 1."""

    def __init__(self, msg: str):
        self.msg = msg
        super().__init__(1)


def fatal(msg: str) -> None:
    # mirrors util.cc:84-88: "\nError: <msg>\n" to stderr, exit(1)
    sys.stderr.write(f"\nError: {msg}\n")
    raise Fatal(msg)


class Logger:
    """Destination for all diagnostics (stderr or a -l log file)."""

    GRANULARITY = 200

    def __init__(self, stream: Optional[IO[str]] = None, to_file: bool = False):
        self.f: IO[str] = stream if stream is not None else sys.stderr
        self.to_file = to_file  # True when -l/--log given
        self._prompt = ""
        self._size = 0
        self._chunk = 1
        self._next = 1
        self._t0 = 0.0

    def write(self, text: str) -> None:
        self.f.write(text)

    def flush(self) -> None:
        self.f.flush()

    # --- progress API (util.cc:32-70) ---

    def progress_init(self, prompt: str, size: int,
                      since: Optional[float] = None) -> None:
        """Start a phase; since (time.monotonic()) dates its start back
        to work done before its prompt could be written."""
        self._prompt = prompt
        self._size = size
        self._chunk = 1 if size < self.GRANULARITY else size // self.GRANULARITY
        self._next = self._chunk
        if self.to_file:
            self.f.write(prompt)
        else:
            self.f.write(f"{prompt} 0%")
        self.f.flush()
        self._t0 = time.monotonic() if since is None else since

    def progress_update(self, progress: int) -> None:
        if not self.to_file and progress >= self._next:
            pct = 100.0 * progress / self._size if self._size else 100.0
            self.f.write(f"  \r{self._prompt} {pct:.0f}%")
            self._next = progress + self._chunk
            self.f.flush()

    def progress_done(self) -> None:
        dt = time.monotonic() - self._t0
        if self.to_file:
            self.f.write(f" 100% ({dt:.9f}s)\n")
        else:
            self.f.write(f"  \r{self._prompt} 100% ({dt:.9f}s)\n")
        self.f.flush()

    def show_time(self, prompt: str) -> None:
        # mirrors compairr.cc:187-198
        ts = time.strftime("%a %b %d %H:%M:%S %Z %Y", time.localtime())
        self.f.write(f"{prompt}{ts}\n")


class NullLogger(Logger):
    """Logger that swallows everything (library use / tests)."""

    def __init__(self):
        super().__init__(stream=_DevNull(), to_file=True)


class _DevNull:
    def write(self, text: str) -> None:
        pass

    def flush(self) -> None:
        pass
