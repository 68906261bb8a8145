"""On the card only (skipped from a fixture elsewhere): the markers the
traced run brackets its ranges with show in a device-only trace."""
import pytest
import torch

import tracing


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_markers_show_in_the_trace(cuda):
    from torch.profiler import ProfilerActivity, profile
    name = tracing.marker_name()
    x = torch.randn(256, 256, device=cuda)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tracing.mark()
        y = x @ x
        tracing.mark()
        torch.cuda.synchronize()
    plain, labels, inside = tracing.split_markers(
        tracing.device_ops(prof), name, [("mm", "open"), ("mm", "close")])
    assert inside["mm"] > 0 and labels == ["mm"] * len(plain)
    del y
