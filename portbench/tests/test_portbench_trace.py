"""The trace reduction on a hand-made event list: busy time is the union of
device intervals inside the window, host spans mirrored on the device
timeline are not kernels, idle gaps go to the host event running then."""

import pytest
from torch.autograd import DeviceType

from portbench.trace import WINDOW_SPAN, Trace, short_name


class Event:
    def __init__(self, name, start, end, device, kind=None):
        self._v = (name, start, end, device)
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return self._v[3]


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": lambda _self: events})()})()


CPU, GPU = DeviceType.CPU, DeviceType.CUDA


def _events(with_kinds):
    def k(kind):
        return kind if with_kinds else None

    return [
        Event(WINDOW_SPAN, 100, 1100, CPU),
        Event("portbench.facade", 100, 900, CPU),
        Event("aten::sort", 150, 400, CPU),
        Event("portbench.facade", 110, 890, GPU, k("gpu_user_annotation")),
        Event("void foo_kernel<float>(float*)", 200, 300, GPU, k("kernel")),
        Event("void alsh_project_kernel(int const*)", 250, 500, GPU, k("kernel")),
        Event("Memcpy DtoH (Device -> Pageable)", 700, 800, GPU, k("gpu_memcpy")),
        Event("void late_kernel()", 1200, 1300, GPU, k("kernel")),  # after the window
    ]


@pytest.mark.parametrize("with_kinds", [True, False], ids=["activity_types", "names"])
def test_trace_reduction(with_kinds):
    t = Trace.from_profiler(Prof(_events(with_kinds)))
    assert t.window_s == pytest.approx(1e-6)
    assert [n for n, _, _ in t.kernels] == ["void foo_kernel<float>(float*)",
                                            "void alsh_project_kernel(int const*)"]
    assert len(t.copies) == 1
    assert t.busy() == [(200, 500), (700, 800)]
    assert t.busy_s() == pytest.approx(400e-9)
    assert t.kernel_seconds(["alsh_project_kernel"]) == pytest.approx(250e-9)
    assert t.kernel_seconds(["alsh_project"]) == 0  # whole identifiers only
    gaps = dict(t.idle_gaps())
    assert gaps["aten::sort"] == pytest.approx(100e-9)  # 100..200
    assert gaps["portbench.facade"] == pytest.approx(200e-9)  # 500..700
    assert gaps["host outside any op"] == pytest.approx(300e-9)  # 800..1100
    assert t.device_ops()[0] == ["alsh_project_kernel", pytest.approx(250e-9)]


def test_short_name():
    assert short_name("void ns::(anonymous namespace)::k<float, 1>(float const*)") == \
        "ns::k<float, 1>"
