"""Per-phase device timing with CUDA events, off unless enabled.

The physics and the env mark their phases (fk, smooth, assemble, solve,
cfrc, integrate, env) with `TIMER.phase(name)`.  While `TIMER.enabled` is
False a phase costs one Python context switch and records nothing; when
it is True each phase records a pair of CUDA events on the current
stream, and `totals_ms()` synchronizes and sums them by name.
"""

from __future__ import annotations

import contextlib

import torch


class PhaseTimer:
    def __init__(self):
        self.enabled = False
        self._events: list = []

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self._events.append((name, start, end))

    def reset(self):
        self._events = []

    def totals_ms(self) -> dict[str, float]:
        torch.cuda.synchronize()
        out: dict[str, float] = {}
        for name, s, e in self._events:
            out[name] = out.get(name, 0.0) + s.elapsed_time(e)
        return out


TIMER = PhaseTimer()
