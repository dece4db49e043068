"""The measured window: work units completed per second of host clock.

`measure(call, seconds, sync_each, sync)` starts calls while the window
is open and counts every call it started: all the work and all the time.
* sync_each (sampler calls, the user's unit of work): each call ends in a
  synchronise; a call is not started where the last call's time would
  take it past the window's end. The window ends with the last call.
* otherwise (training steps, which the users launch back to back): steps
  are launched until the window's time is up, then one synchronise drains
  the queue and the window ends there.
The rate is units / (end - start)."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List


@dataclass
class Window:
    units: int
    calls: int
    seconds: float
    call_s: List[float] = field(default_factory=list)   # sync_each only

    @property
    def rate(self) -> float:
        return self.units / self.seconds


def measure(call: Callable[[int], int], seconds: float, sync_each: bool,
            sync: Callable[[], None],
            clock: Callable[[], float] = time.perf_counter) -> Window:
    sync()
    t0 = clock()
    deadline = t0 + seconds
    units, n, last = 0, 0, 0.0
    end = t0
    durations = []
    while True:
        now = clock()
        if now >= deadline or (sync_each and n and now + last > deadline):
            break
        units += call(n)
        n += 1
        if sync_each:
            sync()
            end = clock()
            last = end - now
            durations.append(last)
    if not sync_each:
        sync()
        end = clock()
    return Window(units, n, end - t0, durations)
