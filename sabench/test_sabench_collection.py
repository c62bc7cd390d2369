"""The genome-collection cell on the CPU: the seeded strain generator
(`sabench.collection`) against the configuration it reads, and a tiny
"collection_build" cell added as files alone beside `tiny.make_root`'s,
judged correct, its control caught, its traced run reporting the DC-v
counters. The generator imports nothing of the program."""
import ast
import json
import math

import numpy as np
import pytest
import torch

from sabench import collection, harness, tiny
from sabench.test_sabench_imports import HERE, top_level_imports

CONFIG = json.loads((HERE / "configs" / "pizzachili-cere.json").read_text())
CELL = "tiny-cere.collection_build"
LIKE = "pizzachili-cere.collection_build"
SEED = 2 ** 31 + 31


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors: where the suite's
    workers share the cores, torch's default pool of one thread a core
    slows such tests fifteenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small(doc_length: int) -> dict:
    """The configuration with each strain cut to `doc_length` bases."""
    config = dict(CONFIG, doc_length=doc_length)
    config["tokens"] = config["strains"] * doc_length
    return config


def test_the_configuration_states_the_collection():
    assert CONFIG["strains"] == 37
    assert CONFIG["strains"] * CONFIG["doc_length"] == CONFIG["tokens"] \
        == 2 ** 27 - 6
    assert set(CONFIG["reduced"]) == {"doc_length"}
    assert CONFIG["collection"]["alphabet"] == ["A", "C", "G", "T"]
    assert CONFIG["plan"] == {}


def test_same_seed_same_collection():
    a, b = (collection.make_collection(small(500), SEED, "cpu")
            for _ in range(2))
    assert torch.equal(a.data, b.data) and torch.equal(a.lengths, b.lengths)
    c = collection.make_collection(small(500), SEED + 1, "cpu")
    assert not torch.equal(a.data, c.data)


def test_strains_of_the_stated_length_over_four_bases():
    config = small(5000)
    data = collection.make_collection(config, SEED, "cpu")
    assert data.n_docs == 37 and data.tokens == config["tokens"]
    assert data.lengths.tolist() == [5000] * 37
    assert all(len(d) == 5000 and d.dtype.kind == "i" for d in data.docs)
    assert torch.equal(torch.from_numpy(np.concatenate(list(data.docs))),
                       data.data)
    assert int(data.data.min()) >= 0 and int(data.data.max()) <= 3
    gc = float(((data.data == 1) | (data.data == 2)).double().mean())
    # 185,000 bases: the GC share's standard deviation is ~0.0011
    assert abs(gc - CONFIG["collection"]["gc_share"]) < 0.01


def test_substitution_share_is_binomial_around_the_rate():
    config = small(20000)
    data = collection.make_collection(config, SEED, "cpu")
    strains = data.data.reshape(37, -1)
    # the base is every site's majority: 19 of 37 strains never share a
    # substitution at rate 0.001
    base = strains.mode(dim=0).values
    subs = int((strains != base).sum())
    sites, p = strains.numel(), CONFIG["collection"]["substitution_rate"]
    mean, sd = sites * p, math.sqrt(sites * p * (1 - p))
    assert abs(subs - mean) < 5 * sd, (subs, mean, sd)


def test_generator_imports_nothing_of_the_program():
    source = (HERE / "collection.py").read_text()
    assert top_level_imports(source) <= {"__future__", "numpy", "torch",
                                         "sabench"}
    # of the benchmark, only the corpus record (itself of the yardstick)
    assert {node.module for node in ast.walk(ast.parse(source))
            if isinstance(node, ast.ImportFrom)
            and node.module.startswith("sabench")} == {"sabench.corpus"}


@pytest.fixture
def root(tmp_path):
    """A benchmark root with a tiny collection cell beside the tiny cells,
    reporting what the real collection cell reports."""
    root = tiny.make_root(tmp_path)
    path = "sabench/configs/tiny-cere.json"
    # the window sort the default plan resolves to on the card; on the CPU
    # "auto" would take the bitonic network's slow plain version
    (root / path).write_text(json.dumps(dict(small(300),
                                             plan={"sort_impl": "radix"})))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-cere", "source": "test",
                             "file": path, "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-cere",
                               "traffic": "collection_build", "chips": 1,
                               "why": "test"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if LIKE in metric.get("workloads", ()):
            metric["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_collection_cell_is_correct_and_reports_its_rate(root):
    result = harness.run_cell(CELL, SEED, 0.1, False, "cpu", root=root)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"build_tokens_per_s", "setup_s"}
    assert result["checks"]["sa_positions_wrong"]["value"] == 0
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_control_in_the_programs_place_is_caught(root):
    result = harness.run_cell(CELL, SEED, 0.1, False, "cpu", root=root,
                              use_control=True)
    assert not result["correct"]
    assert result["checks"]["sa_positions_wrong"]["value"] > 0


def test_traced_collection_cell_reports_the_dcv_counters(root):
    result = harness.run_cell(CELL, SEED, 0.0, True, "cpu", root=root)
    assert result["correct"], result["checks"]
    rounds = result["metrics"]["dcv_refine_rounds"]
    rows = result["metrics"]["dcv_lemma1_rows_per_build"]
    assert rounds["unit"] == "rounds" and rounds["value"] >= 1
    assert rows["unit"] == "rows" and rows["value"] >= 1
    # no device on the CPU: no device metric is written
    assert "device_ms_per_build" not in result["metrics"]


def test_counter_readers_read_nothing_without_the_programs_counters(root):
    cell, _ = harness.resolve(CELL, SEED, 0.0, True, "cpu", root)
    read = harness.readers(cell, root)
    for name in ("dcv_refine_rounds", "dcv_lemma1_rows_per_build"):
        assert read[name].read({"kind": "build"}) is None
        # a program that counts other things but not the DC-v recursion
        assert read[name].read({"counters_per_build": {
            "repro_torch.builds": 1.0}}) is None
        assert read[name].read({"counters_per_build": {
            "repro_torch.dcv.levels": 5.0}}) == 0.0
