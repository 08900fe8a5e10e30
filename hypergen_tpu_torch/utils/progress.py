"""Terminal progress bar with position/percent/elapsed/ETA
(reference C22, reference:src/utils.rs:223-232)."""

from __future__ import annotations

import sys
import time


def _fmt_secs(s: float) -> str:
    s = max(int(s), 0)
    h, rem = divmod(s, 3600)
    m, sec = divmod(rem, 60)
    return f"{h:02d}:{m:02d}:{sec:02d}"


class ProgressBar:
    def __init__(self, total: int, enabled: bool = True, width: int = 40):
        self.total = max(total, 1)
        self.pos = 0
        self.width = width
        self.enabled = enabled and sys.stderr.isatty()
        self.t0 = time.monotonic()

    def inc(self, n: int = 1) -> None:
        self.pos += n
        if self.enabled:
            self._draw()

    def _draw(self) -> None:
        frac = min(self.pos / self.total, 1.0)
        filled = int(frac * self.width)
        elapsed = time.monotonic() - self.t0
        eta = elapsed * (1 - frac) / frac if frac > 0 else 0.0
        bar = "#" * filled + "-" * (self.width - filled)
        sys.stderr.write(
            f"\r[{bar}] {self.pos}/{self.total} ({frac*100:.0f}%) "
            f"- Elapsed: {_fmt_secs(elapsed)}, ETA: {_fmt_secs(eta)}"
        )
        sys.stderr.flush()

    @property
    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    @property
    def per_sec(self) -> float:
        e = self.elapsed
        return self.pos / e if e > 0 else 0.0

    def finish(self) -> None:
        if self.enabled:
            sys.stderr.write("\r" + " " * (self.width + 60) + "\r")
            sys.stderr.flush()
