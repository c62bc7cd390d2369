"""One run of one cell: resolve it by name, set up, measure, judge, report.

A cell of `BENCHMARK.json` names a configuration and a traffic mix. The
configuration's entry gives its file; the mix is `traffic/<mix>.json`,
whose `kind` names the driver `drivers/<kind>.py`; each metric is read by
`metrics/<metric>.py`. So a cell, a mix or a metric is added as files
alone. A driver module has `setup(cell)`, `window(state, seconds,
tracer)`, `release(state)`, `judge(state, record)` and `control(state)`.
A metric reader has `read(record)`, which returns None where the record
holds nothing for it; the metric is then left out of the line.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from sabench.trace import Tracer

ROOT = Path(__file__).resolve().parents[1]
HERE = "sabench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: torch.device
    metrics: list          # BENCHMARK.json metric entries this run reports


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path):
    """A module of the benchmark loaded from its file, under a name of its
    own (drivers and readers are found by file name, not imported)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    name = f"sabench_{path.parent.name}_{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_entry(bench: dict, name: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, name: str, trace: bool) -> list:
    """The metrics a run of cell `name` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def resolve(name: str, seed: int, seconds: float, trace: bool, device,
            root: Path = ROOT) -> tuple[Cell, object]:
    """The cell and its driver module, from `BENCHMARK.json` under `root`
    and the files it names."""
    bench = load_benchmark(root)
    entry = cell_entry(bench, name)
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    traffic = json.loads(
        (root / HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    cell = Cell(name=name, chips=int(entry["chips"]),
                config=json.loads((root / config["file"]).read_text()),
                traffic=traffic, seed=int(seed), seconds=float(seconds),
                device=torch.device(device),
                metrics=cell_metrics(bench, name, trace))
    driver = load_module(root / HERE / "drivers" / f"{traffic['kind']}.py")
    return cell, driver


def readers(cell: Cell, root: Path = ROOT) -> dict:
    return {m["name"]: load_module(root / HERE / "metrics" / f"{m['name']}.py")
            for m in cell.metrics}


def device_info(device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device))}
    return {"platform": device.type, "kind": device.type, "count": 1,
            "memory_peak_bytes": 0}


def load_kernels(device) -> float | None:
    """Seconds to build (in a checkout's first run) or load the program's
    CUDA kernel library, which set-up includes; None off the card or
    where the program has no such library."""
    if device.type != "cuda":
        return None
    try:
        from repro_torch.kernels import _build
        load = _build.library
    except (ImportError, AttributeError):
        return None
    t0 = time.perf_counter()
    load()
    return time.perf_counter() - t0


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             *, root: Path = ROOT, t_process: float | None = None,
             use_control: bool = False) -> dict:
    """One run; returns the result line's object, `checks` last.
    `use_control` puts the driver's control in the program's place.
    `kernel_build_s` reports apart the part of `setup_s` spent building
    or loading the kernels: a checkout's first run compiles them."""
    t_process = time.perf_counter() if t_process is None else t_process
    cell, driver = resolve(name, seed, seconds, trace, device, root)
    read = readers(cell, root)
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cell.device)
    print(f"{name}: imports and the card {time.perf_counter() - t_process:.3f}"
          f" s", file=sys.stderr)
    tracer = Tracer(trace, cell.device)
    kernel_build_s = load_kernels(cell.device)
    if kernel_build_s is not None:
        print(f"{name}: kernels built or loaded in {kernel_build_s:.3f} s",
              file=sys.stderr)
    state = driver.setup(cell)
    tracer.warm()
    setup_s = time.perf_counter() - t_process
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    print(f"{name}: set-up {setup_s:.3f} s, device peak {peak} B",
          file=sys.stderr)
    record = driver.window(state, cell.seconds, tracer)
    record["setup_s"] = setup_s
    device = device_info(cell.device)
    driver.release(state)
    t_judge = time.perf_counter()
    checks = driver.control(state) if use_control else \
        driver.judge(state, record)
    t_trace = time.perf_counter()
    record["trace"] = tracer.record()
    print(f"{name}: {record['attempted']} attempted, judged in "
          f"{t_trace - t_judge:.3f} s, trace read in "
          f"{time.perf_counter() - t_trace:.3f} s", file=sys.stderr)
    metrics = {}
    for m in cell.metrics:
        value = read[m["name"]].read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": all(value <= limit for _, value, limit in checks),
              "attempted": record["attempted"], "failed": record["failed"],
              "metrics": metrics, "device": device}
    if record["trace"] is not None:
        device["busy_s"] = record["trace"]["busy_s"]
        device["window_s"] = record["trace"]["window_s"]
        result["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                               "idle_gaps": record["trace"]["idle_gaps"]}
    if kernel_build_s is not None:
        result["kernel_build_s"] = kernel_build_s
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process,
    compared by their whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})
