"""The profiler session on the card: markers found, every kernel of the
stretch kept, busy time within the window. Needs a CUDA card:
`python -m pytest -m cuda portbench/tests/test_portbench_card.py` on the
card's machine; skips elsewhere."""
import pytest
import torch

from portbench.harness import trace as tr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("host_ops", [False, True])
def test_stretch_keeps_every_kernel(card, host_ops):
    a = torch.ones(1 << 20, device=card)

    def work():
        for _ in range(50):
            a.mul_(1.0001)           # one elementwise kernel each
    work()
    torch.cuda.synchronize()
    _, t = tr.profile_stretch(work, host_ops=host_ops)
    assert t is not None
    busy, n = tr.device_time(t)
    assert n == 50, tr.by_name(t)
    assert 0 < tr.busy_ns(t) <= t.window_ns
    assert 0.0 <= tr.idle_share(t) < 100.0
    if host_ops:
        assert t.host
