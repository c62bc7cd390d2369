"""Every cell of `BENCHMARK.json` resolves to its files, the file keeps
the contract's static rules, and a cell, a mix and a metric added as
files alone are found and reported."""
import json
import re

import pytest

from sabench import harness, tiny

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DRIVER_API = ("setup", "window", "release", "judge", "control")


def all_metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    for trace in (False, True):
        resolved, driver = harness.resolve(cell, 1, 1.0, trace, "cpu")
        assert all(callable(getattr(driver, f)) for f in DRIVER_API)
        assert resolved.metrics, (cell, trace)
        for reader in harness.readers(resolved).values():
            assert callable(reader.read)
    names = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
    assert "setup_s" in names and len(names) >= 2
    assert harness.cell_metrics(BENCH, cell, True)


def test_benchmark_keeps_the_contracts_static_rules():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + all_metrics()]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for config in BENCH["configs"]:
        data = json.loads((harness.ROOT / config["file"]).read_text())
        assert config["file"].startswith(BENCH["paths"][0] + "/")
        assert set(config["reduced"]) <= set(data), config["name"]
        assert all(NAME.match(k) for k in config["reduced"])
        assert 1 <= len(config["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for cell in BENCH["workloads"]:
        assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    for metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for metric in all_metrics():
        assert UNIT.match(metric["unit"])
        assert metric["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for metric in BENCH["per_layer"]:
        assert metric["moves"] in e2e
        moved = next(m for m in BENCH["end_to_end"]
                     if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(
            moved.get("workloads", metric["workloads"]))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_cell_mix_and_metric_added_as_files_alone_are_found(tmp_path):
    root = tiny.make_root(tmp_path)
    (root / "sabench" / "metrics" / "docs_per_build.py").write_text(
        "def read(record):\n"
        "    return float(len(record['builds'])) or None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({
        "name": "docs_per_build", "unit": "builds", "better": "higher",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["tiny-tokens.build"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = harness.run_cell("tiny-tokens.build", 7, 0.1, False, "cpu",
                              root=root)
    assert result["correct"]
    assert set(result["metrics"]) == {"build_tokens_per_s", "setup_s",
                                      "docs_per_build"}
    assert result["metrics"]["docs_per_build"]["value"] >= 1
