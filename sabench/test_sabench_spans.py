"""The join of the program's spans to the device trace (`sabench.spans`):
attribution on synthetic kineto events, and a traced tiny cell on the
CPU."""
import pytest
import torch

from sabench import spans, tiny

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    """Stands in for a kineto event: the methods `span_table` reads."""

    def __init__(self, name, start, end, kind, corr=0):
        self._name, self._start, self._end = name, start, end
        self._kind, self._corr = kind, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return CUDA if self._kind in ("kernel", "gpu_user_annotation") \
            else CPU

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")

    def correlation_id(self):
        return self._corr


def span(name, start, end):
    kind = "user_annotation" if name.startswith("sabench.") else "cpu_op"
    return Event(name, start, end, kind)


EVENTS = [
    span("sabench.window", 0, 1000),
    span("sabench.from_docs", 10, 990),
    span("repro_torch.index.encode_docs", 20, 300),
    span("repro_torch.build", 310, 980),
    span("repro_torch.dcv.level", 320, 900),
    span("repro_torch.dcv.level", 330, 600),
    span("repro_torch.dcv.window_order", 340, 500),
    Event("cudaLaunchKernel", 350, 352, "cuda_runtime", corr=7),
    # an operator sharing the id in its own numbering, not a launch
    Event("aten::index", 20, 25, "cpu_op", corr=7),
    Event("radix_scatter", 400, 700, "kernel", corr=7),
    # kineto's device view of a user annotation: not work
    Event("repro_torch.x", 380, 720, "gpu_user_annotation", corr=7),
    Event("cudaLaunchKernel", 950, 952, "cuda_runtime", corr=8),
    Event("gather", 960, 970, "kernel", corr=8),
    Event("no_runtime_call", 750, 800, "kernel", corr=99),
    # launched by the benchmark, outside every program span
    Event("cudaMemcpyAsync", 994, 995, "cuda_runtime", corr=9),
    Event("Memcpy DtoH", 996, 999, "kernel", corr=9),
]


def test_device_and_idle_time_go_to_the_spans_that_cover_them():
    out = spans.span_table(EVENTS)
    table = {n: {k: round(v * 1e9) if k != "calls" else v
                 for k, v in row.items()}
             for n, row in out["spans"].items()}
    # the nested level counts its kernel once
    assert table["repro_torch.dcv.level"] == {
        "calls": 2, "host_s": 580, "self_host_s": 420, "device_s": 300,
        "idle_s": 50 + 160}
    assert table["repro_torch.dcv.window_order"] == {
        "calls": 1, "host_s": 160, "self_host_s": 160, "device_s": 300,
        "idle_s": 0}
    assert table["repro_torch.build"]["device_s"] == 310
    assert table["repro_torch.build"]["self_host_s"] == 10 + 80
    assert table["repro_torch.index.encode_docs"] == {
        "calls": 1, "host_s": 280, "self_host_s": 280, "device_s": 0,
        "idle_s": 400}
    assert table["sabench.from_docs"]["idle_s"] == 996 - 970
    assert table["sabench.window"]["device_s"] == 310 + 3
    assert table["sabench.window"]["idle_s"] == 1
    # the kernel with no runtime call and the benchmark's copy
    assert round(out["unattributed_device_s"] * 1e9) == 50 + 3
    # every idle ns of the window goes to one span
    assert sum(r["idle_s"] for r in table.values()) == 1000 - 363


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError, match="sabench.window"):
        spans.span_table(EVENTS[1:])


def test_traced_tiny_cell_reports_the_host_spans(tmp_path):
    root = tiny.make_root(tmp_path)
    out = spans.trace_cell("tiny-tokens.build", 2 ** 31 + 11, 0.0, "cpu",
                           root=root)
    trace = out["trace"]
    table = trace["spans"]
    assert table["repro_torch.index.encode_docs"]["calls"] == 1
    assert table["repro_torch.index.encode_docs"]["host_s"] > 0
    assert table["repro_torch.build"]["host_s"] > 0
    # the CPU has no device events: nothing to attribute
    assert all(row["device_s"] == 0 for row in table.values())
    assert trace["unattributed_device_s"] == 0 and trace["busy_s"] == 0
    assert trace["units"] == 1 and len(out["build_s"]) == 2
    assert "repro_torch.build" in spans.format_table(trace)
