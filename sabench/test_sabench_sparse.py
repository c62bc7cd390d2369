"""The sampled-index cell on the CPU: a tiny "sparse_build" cell added as
files alone beside `tiny.make_root`'s, judged correct against the plain
sparse reference, its traced run's span table and counters, and its
control caught. The sparse reference imports nothing of the program."""
import json

import pytest
import torch

from sabench import harness, reference, reference_sparse, tiny
from sabench.test_sabench_imports import HERE, top_level_imports
from sabench.trace import Tracer

CELL = "tiny-sparse.sparse_build"
LIKE = "infinigram-llama2-sparse16.sparse_build"
CONFIG = {
    "tokens": 4096,
    "corpus": {"vocab": 16, "zipf_exponent": 1.0,
               "doc_length": {"dist": "lognormal", "mean": 32, "sigma": 1.0},
               "copy_share": 0.1, "passage": [8, 24]},
    "plan": {"sample_rate": 4},
}
SEED = 2 ** 31 + 27


@pytest.fixture
def root(tmp_path):
    """A benchmark root with the tiny sampled cell beside the tiny cells,
    reporting what the real sampled cell reports."""
    root = tiny.make_root(tmp_path)
    path = "sabench/configs/tiny-sparse.json"
    (root / path).write_text(json.dumps(CONFIG))
    (root / "sabench/traffic/tiny-sparse-build.json").write_text(
        json.dumps({"kind": "sparse_build"}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-sparse", "source": "test",
                             "file": path, "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-sparse",
                               "traffic": "tiny-sparse-build", "chips": 1,
                               "why": "test"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if LIKE in metric.get("workloads", ()):
            metric["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_sampled_cell_is_correct_and_reports_its_rate(root):
    result = harness.run_cell(CELL, SEED, 0.1, False, "cpu", root=root)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"build_tokens_per_s", "setup_s"}
    assert result["checks"]["sa_positions_wrong"]["value"] == 0
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_traced_sampled_cell_reads_its_spans_and_counters(root):
    result = harness.run_cell(CELL, SEED, 0.0, True, "cpu", root=root)
    assert result["correct"], result["checks"]
    rounds = result["metrics"]["sparse_doubling_rounds"]
    assert rounds["unit"] == "rounds" and rounds["value"] >= 1
    # no device on the CPU: no device metric is written
    assert "sparse_construct_device_ms_per_build" not in result["metrics"]
    assert "device_ms_per_build" not in result["metrics"]

    # the traced build's span table, and the reader given device time
    cell, driver = harness.resolve(CELL, SEED, 0.0, True, "cpu", root)
    tracer = Tracer(True, cell.device)
    state = driver.setup(cell)
    record = driver.window(state, 0.0, tracer)
    record["trace"] = tracer.record()
    table = record["span_table"]["spans"]
    for name in ("construct", "heads", "double"):
        assert table[f"repro_torch.sparse.{name}"]["calls"] >= 1, name
    assert table["repro_torch.sparse.construct"]["calls"] == 1
    assert table["repro_torch.index.upload"]["calls"] == 1
    table["repro_torch.sparse.construct"]["device_s"] = 0.004
    record["trace"]["busy_s"] = 0.005
    read = harness.readers(cell, root)
    assert read["sparse_construct_device_ms_per_build"].read(record) == \
        pytest.approx(4.0)


def test_control_in_the_programs_place_is_caught(root):
    result = harness.run_cell(CELL, SEED, 0.1, False, "cpu", root=root,
                              use_control=True)
    assert not result["correct"]
    assert result["checks"]["sa_positions_wrong"]["value"] > 0


def test_sparse_reference_keeps_the_dense_order_at_sampled_positions():
    text = torch.tensor([2, 1, 2, 1, 2, 0, 1, 2, 1, 2, 1])
    dense = reference.suffix_array(text)
    for s in (1, 2, 3, 4, 11):
        want = [int(p) for p in dense if p % s == 0]
        assert reference_sparse.sparse_suffix_array(text, s).tolist() == want
    with pytest.raises(ValueError):
        reference_sparse.sparse_suffix_array(text, 0)


def test_sparse_reference_imports_nothing_of_the_program():
    imports = top_level_imports((HERE / "reference_sparse.py").read_text())
    assert imports <= {"__future__", "torch", "sabench"}
