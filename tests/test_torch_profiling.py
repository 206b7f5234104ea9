"""`utils/profiling.py::kernel_launch_us` with a fake profiler, on the CPU.

The profiler may keep no event of a kernel that launched. The readout then
retries the profile once, and reports the kernel as not measured (absent,
or None for the sum) if it still has none: never 0.
"""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from controllable_xgating_torch.ops import kernels
from controllable_xgating_torch.utils import profiling

NAME = "void cxg::topk_chunk<5>(float const*, int)"


def event(us: float, name: str = NAME):
    return SimpleNamespace(device_type=DeviceType.CUDA, name=name,
                           time_range=SimpleNamespace(elapsed_us=lambda: us))


@pytest.fixture
def fake_profiler(monkeypatch):
    """The events each successive profile keeps (a list of lists); records
    how many profiles were taken."""
    kept, taken = [], []

    class FakeProfile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            taken.append(1)

        def events(self):
            return kept[len(taken) - 1]

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    return kept, taken


def launching():
    """A call that counts one launch of the top-K kernel's wrapper."""
    kernels.WRAPPERS["topk_tail"].launches += 1


def test_a_lost_profile_is_taken_again(fake_profiler):
    kept, taken = fake_profiler
    kept += [[], [event(3.0), event(5.0), event(4.0), event(1.0, "aten::copy_")]]
    got = profiling.kernel_launch_us(launching, calls=3)
    assert len(taken) == 2
    assert got == {"cxg::topk_chunk<5>": [3.0, 5.0, 4.0]}


def test_a_kernel_never_kept_is_not_measured(fake_profiler):
    kept, taken = fake_profiler
    kept += [[]] * 6  # two profiles for each of the three readouts
    assert profiling.kernel_launch_us(launching, calls=3) == {}
    assert len(taken) == 2  # one retry, no more
    assert profiling.kernel_device_split(launching, calls=3) == {}
    assert profiling.kernel_device_us(launching, calls=3) is None  # never 0.0


def test_no_retry_when_nothing_launched(fake_profiler):
    kept, taken = fake_profiler
    kept += [[], []]
    assert profiling.kernel_launch_us(lambda: None, calls=2) == {}
    assert len(taken) == 1


def test_the_split_is_the_median_launch_times_launches_per_call(fake_profiler):
    kept, _ = fake_profiler
    kept += [[event(2.0), event(9.0), event(3.0), event(4.0)]] * 2
    assert profiling.kernel_device_split(launching, calls=2) == {"cxg::topk_chunk<5>": 4.0 * 2}
    assert profiling.kernel_device_us(launching, calls=2) == 8.0
