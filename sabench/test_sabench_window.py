"""The build window and what a run reports beside it, on the CPU with a
stand-in for the tracer."""
import torch

from sabench import harness, tiny


class RecordingTracer:
    """Stands in for `sabench.trace.Tracer` and logs what the window asks
    of it."""

    def __init__(self, enabled=True):
        self.enabled = enabled
        self.calls, self.units = [], 0
        self.active = False

    def begin(self):
        self.calls.append("begin")
        self.active = self.enabled

    def tick(self, units=0, own_syncs=0):
        self.calls.append("tick")
        if self.active:
            self.units += units

    def end(self):
        self.calls.append("end")
        self.active = False


def window(tmp_path, tracer):
    root = tiny.make_root(tmp_path)
    cell, driver = harness.resolve("tiny-tokens.build", 5, 0.0,
                                   tracer.enabled, "cpu", root)
    return driver.window(driver.setup(cell), 0.0, tracer)


def test_traced_build_window_starts_after_the_first_build(tmp_path):
    tracer = RecordingTracer()
    record = window(tmp_path, tracer)
    # build 0 is ticked untraced, then the trace covers build 1 whole
    assert tracer.calls[:4] == ["tick", "begin", "tick", "end"]
    assert tracer.units == 1 and len(record["builds"]) == 2


def test_untraced_window_closes_at_the_first_build_past_its_seconds(
        tmp_path):
    record = window(tmp_path, RecordingTracer(enabled=False))
    assert len(record["builds"]) == 1 and record["attempted"] == 1


def test_kernel_build_is_reported_apart_from_setup(tmp_path, monkeypatch):
    assert harness.load_kernels(torch.device("cpu")) is None
    root = tiny.make_root(tmp_path)
    monkeypatch.setattr(harness, "load_kernels", lambda device: 1.5)
    result = harness.run_cell("tiny-tokens.build", 3, 0.0, False, "cpu",
                              root=root)
    assert result["kernel_build_s"] == 1.5
    assert "setup_s" in result["metrics"] and list(result)[-1] == "checks"
