"""The kernel timer's event counting (core/card.py), on synthetic events.

`session_time` counts only the device events after a session's marker
kernel and holds them to n calls × the launches per call; `timed_sessions`
repeats a session that kept fewer, takes the median of three that kept
all, and raises ProfilerSilent when none kept all. No card is needed: the events are (name, start µs, end µs) tuples, as
`device_events` returns them.
"""
import pytest
import torch

from ratio_guided_multimodal_fm_tpu_torch.core.card import (
    MARKER_KERNEL,
    ProfilerSilent,
    after_marker,
    session_time,
    timed_sessions,
)

torch.set_num_threads(1)

K = "gn_silu_bwd_kernel<float>"
R = "gn_wb_reduce_kernel"
MARK = (f"void at::native::{MARKER_KERNEL}(long)", 90.0, 100.0)


def session(n, launches=((K, 30.0), (R, 5.0)), lost=0, marker=True,
            period=100.0):
    """Warm-up kernels, the marker, then n calls of the given kernels (name,
    µs), one call every `period` µs; the first `lost` events of the session
    dropped, as the profiler drops them."""
    ev = [("add_kernel", float(i), i + 0.5) for i in range(50)]
    if marker:
        ev.append(MARK)
    for c in range(n):
        t = 200.0 + c * period
        for name, dur in launches:
            ev.append((name, t, t + dur))
            t += dur
    return ev[lost:]


def test_after_marker_keeps_what_follows_the_last_marker():
    ev = session(2)
    kept = after_marker(ev)
    assert [e[0] for e in kept] == [K, R, K, R]
    assert after_marker(session(2, marker=False)) is None
    # a second marker moves the start
    ev2 = ev + [(MARK[0], 1000.0, 1001.0), (K, 1002.0, 1003.0)]
    assert after_marker(ev2) == [(K, 1002.0, 1003.0)]


def test_full_session_divides_the_union_by_n():
    ms, by = session_time(session(4), (K, R), n=4, launches=2)
    assert ms == pytest.approx(0.035)        # 35 µs busy a call
    assert by[K] == pytest.approx(0.030) and by[R] == pytest.approx(0.005)
    # overlapping spans count once
    ev = session(2, launches=((K, 30.0), (R, 5.0)))
    ev = [(n, s - 10.0, e - 10.0) if n == R else (n, s, e) for n, s, e in ev]
    ms, _ = session_time(ev, (K, R), n=2, launches=2)
    assert ms == pytest.approx(0.030)


def test_short_session_returns_none_and_too_many_raise():
    # the warm-up kernels absorb the loss: nothing after the marker is lost
    assert session_time(session(4, lost=30), (K, R), 4, 2) is not None
    # a lost marker, or kernels lost after it, is a short session
    assert session_time(session(4, lost=51), (K, R), 4, 2) is None
    short = session(4)
    short.remove(short[-1])
    assert session_time(short, (K, R), 4, 2) is None
    # dividing by n alone would have read it as 4 full calls
    with pytest.raises(ValueError, match="more than 1 a call"):
        session_time(session(4), (K, R), 4, 1)


def test_timed_sessions_repeats_a_short_session():
    walked = []

    def sessions():
        for ev in (session(3, lost=60), session(3)[:-2], session(3)):
            walked.append(ev)
            yield ev

    ms, _ = timed_sessions(sessions(), (K, R), 3, 2)
    assert ms == pytest.approx(0.035) and len(walked) == 3


def test_timed_sessions_take_the_median_of_three_full_sessions():
    walked = []

    def sessions():
        for ev in (session(3), session(3)[:-2],
                   session(3, launches=((K, 15.0), (R, 2.5))),
                   session(3), session(3, launches=((K, 40.0), (R, 5.0)))):
            walked.append(ev)
            yield ev

    # a session that reads the kernels at half their time is outvoted, and
    # the walk stops at the third full session
    ms, by = timed_sessions(sessions(), (K, R), 3, 2)
    assert ms == pytest.approx(0.035) and by[K] == pytest.approx(0.030)
    assert len(walked) == 4


def test_timed_sessions_raise_naming_what_was_kept():
    def sessions():
        yield session(3, lost=60)       # the marker and more lost
        yield session(3)[:-3]           # 3 of 6 kept
        yield session(3, launches=())   # silent

    with pytest.raises(ProfilerSilent, match=r"kept \[None, 3, 0\] of the 6"):
        timed_sessions(sessions(), (K, R), 3, 2)
