"""Preemption-safe training (port of train/preemption.py; pure Python
signal handling, copied).

A scheduler preempts with a SIGTERM and a grace window: the driver
finishes the in-flight step, saves a resumable checkpoint (weights,
optimiser, EMA, epoch and STEP) and returns, so a restarted job resumes
mid-epoch. Mid-epoch resume is exact because every epoch's batch order and
every step's random draws are position-addressed (data/mnist_dataset.py:
_EpochLoader.epoch, core/prng.py:RNG).

    with PreemptionGuard() as guard:
        for step in epoch:
            ...
            if guard.preempted:
                save_resumable(...); return

`request_preemption()` triggers the same path programmatically (tests,
fault injection).
"""
from __future__ import annotations

import signal
import threading
from typing import Iterable

_flag = threading.Event()
_depth = 0
_depth_lock = threading.Lock()
_prev_handlers: dict = {}


def request_preemption() -> None:
    """Programmatic preemption (fault injection / tests)."""
    _flag.set()


def arm(signals: Iterable[int] = (signal.SIGTERM,)) -> None:
    """Permanently route `signals` to the preemption flag (no restore).

    The train CLIs call this at startup, so that a SIGTERM landing before
    the epoch driver enters its PreemptionGuard (data loading, model
    set-up, the kernels' first build) is remembered and honoured at the
    first completed step instead of killing the process with nothing
    saved.
    """
    for s in signals:
        try:
            signal.signal(s, lambda *_: _flag.set())
        except ValueError:            # non-main thread: flag-only mode
            pass


class PreemptionGuard:
    """Routes SIGTERM to a process-global flag while active; restores the
    previous handlers when the OUTERMOST guard exits. Nesting-safe: an
    inner guard neither reinstalls handlers nor erases a pending flag (a
    SIGTERM before entry must be honoured at the first step, and an outer
    driver must still see a preemption its nested driver responded to).
    The flag is consumed (cleared) only when the outermost guard exits."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)

    def __enter__(self):
        global _depth
        with _depth_lock:
            if _depth == 0:
                # module-level bookkeeping: nested and non-LIFO exits of
                # two guards must not restore handlers or clear the flag
                # while any guard is still active
                for s in self._signals:
                    try:
                        _prev_handlers[s] = signal.signal(
                            s, lambda *_: _flag.set())
                    except ValueError:  # non-main thread: flag-only mode
                        pass
            _depth += 1
        return self

    def __exit__(self, *exc):
        global _depth
        with _depth_lock:
            _depth -= 1
            if _depth == 0:
                for s, h in _prev_handlers.items():
                    signal.signal(s, h)
                _prev_handlers.clear()
                _flag.clear()         # consumed by the last active driver
        return False

    @property
    def preempted(self) -> bool:
        return _flag.is_set()
