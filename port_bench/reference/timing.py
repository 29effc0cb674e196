"""The port's phase timer, reduced to a no-op: the reference is never
timed."""

import contextlib


class _NoTimer:
    enabled = False

    @contextlib.contextmanager
    def phase(self, name: str):
        yield


TIMER = _NoTimer()
