"""Tiny cells for the benchmark's own tests on the CPU: a copy of the
benchmark's tree under a temporary root, with configurations and mixes
added as files alone and listed in that root's `BENCHMARK.json`."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from sabench.harness import HERE, ROOT, load_benchmark

CONFIGS = {
    "tiny-tokens": {
        "tokens": 4096,
        "corpus": {"vocab": 16, "zipf_exponent": 1.0,
                   "doc_length": {"dist": "lognormal", "mean": 32,
                                  "sigma": 1.0},
                   "copy_share": 0.1, "passage": [8, 24]},
        "plan": {},
    },
    "tiny-bsp": {
        "tokens": 1024, "mesh_ranks": 8,
        "corpus": {"vocab": 256, "zipf_exponent": 1.0,
                   "doc_length": {"dist": "fixed", "value": 64},
                   "copy_share": 0.25, "passage": [16, 16]},
        "plan": {"backend": "auto", "sort_impl": "auto"},
    },
}

TRAFFIC = {
    "tiny-build": {"kind": "build"},
}

#: tiny cell -> (configuration, mix, the cell whose metrics it reports)
CELLS = {"tiny-tokens.build": ("tiny-tokens", "tiny-build",
                               "infinigram-llama2.build"),
         "tiny-bsp.build": ("tiny-bsp", "tiny-build", "webbytes-bsp8.build")}


def make_root(tmp: Path) -> Path:
    """`tmp` made a benchmark root holding the tiny cells beside the real
    ones, each added as files alone."""
    shutil.copytree(ROOT / HERE, tmp / HERE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = load_benchmark(ROOT)
    for name, config in CONFIGS.items():
        path = f"{HERE}/configs/{name}.json"
        (tmp / path).write_text(json.dumps(config))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": path, "reduced": [], "why": "test"})
    for name, traffic in TRAFFIC.items():
        (tmp / HERE / "traffic" / f"{name}.json").write_text(
            json.dumps(traffic))
    for cell, (config, traffic, like) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if like in metric.get("workloads", ()):
                metric["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
