#!/usr/bin/env python3
"""Where the time of the one-pass dense rank (`dense_rank.cu`) goes, on one
NVIDIA card.

Run from the root of a checkout:

    python3 chip_dense_rank.py [--against DIR]

It builds `src/repro_torch/kernels/csrc/dense_rank.cu` as the port does and
two variants of the same source, each into its own library under
`build/repro_torch/variants/`:

* ``acquire_release``: the tile words published with a release store and
  read with acquire loads instead of relaxed atomics;
* ``no_look_back``: every tile takes 0 as its prefix (ranks WRONG past the
  first tile): the time the kernel takes without its look-back.

It makes `chip_smoke.py`'s main-path corpus (14,667,776 tokens), takes the
level-0 inputs the builds hand the kernel (the Step-1 sample rows of a
"kernel" build, int32[9,786,710, 3]; the window order and the sample
positions of a "radix" build) and times, in turns (port, variants, port),
each form through its wrapper and the rows form alone (its scratch zeroed
beforehand, CUDA events around the launches only). Beside them: a clone of
the sample rows (a copy of the same bytes and more) and PyTorch's gather
`word[pos]` (the same random reads). The port's results must equal the
plain versions'. Prints one JSON line, then the card's name and power
limit. Exits non-zero without a CUDA device.

With ``--against DIR`` (the root of another checkout, e.g. the parent
commit unpacked with `git archive` into a directory `.gitignore` lists)
it first times the warm default build of the same corpus on each side, in
turns (DIR, this, this, DIR), one process a turn, and prints a
``{"default_builds": ...}`` line with each turn's seconds and each side's
median.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: variant name -> (text of the source, its replacement), ...
VARIANTS = {
    "acquire_release": (
        ("st.relaxed.gpu.global.u64", "st.release.gpu.global.u64"),
        ("ld.relaxed.gpu.global.u64", "ld.acquire.gpu.global.u64")),
    "no_look_back": (("excl = look_back(tiles, tile, lane);", "excl = 0;"),),
}
#: warm default builds a side, after one not counted.
WARM_BUILDS = 5
#: one side of `--against`: argv = (root of a checkout, this directory).
#: Builds the main-path corpus with that checkout's port, then times its
#: warm default builds; prints them as a JSON list.
SIDE = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1] + "/src"]
sys.path.append(sys.argv[2])
import torch
from chip_smoke import DOC_LEN, N_DOCS, SEED, make_corpus
from repro_torch.api import SAOptions, SuffixArrayIndex, build_suffix_array
dev = torch.device("cuda", 0)
idx = SuffixArrayIndex.from_docs(make_corpus(N_DOCS, DOC_LEN, SEED),
                                 SAOptions(), device=dev)
out = []
for _ in range(int(sys.argv[3]) + 1):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sa = build_suffix_array(idx.text, SAOptions(), device=dev)
    torch.cuda.synchronize()
    out.append(time.perf_counter() - t0)
    assert torch.equal(sa, idx.sa)
print(json.dumps(out[1:]))
"""
ENTRY_POINTS = ("repro_dense_rank_rows", "repro_dense_rank_gather")


def build_variants() -> dict:
    """name -> loaded library of each variant, built in parallel."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "dense_rank.cu").read_text()
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        jobs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", str(cu), "-o",
             str(out / f"{name}.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn in ENTRY_POINTS:
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def level0_inputs(dev):
    """(sample rows of a "kernel" build, words, window order, sample
    positions of a "radix" build), all of level 0."""
    import chip_smoke as cs
    from repro_torch.api import SAOptions, SuffixArrayIndex
    from repro_torch.core import dcv_torch
    from repro_torch.kernels import ops
    docs = cs.make_corpus(cs.N_DOCS, cs.DOC_LEN, cs.SEED)
    text = SuffixArrayIndex.from_docs(docs, SAOptions(), device=dev).text
    xp, n_v, v, _, _ = cs.window_levels(dev, text)[0]
    srt = ops.bitonic_sort(dcv_torch.window_rows(xp, n_v, v))
    order = srt[:n_v, v].long()
    in_d = dcv_torch.cover_constants(v, dev)[1]
    samples = srt[:n_v, :v][in_d[order % v]].contiguous()
    (_, _, words, window), (_, _, _, sp) = cs.default_build_ranks(dev,
                                                                   text)[:2]
    return samples, words, window, sp


def default_builds(other: Path) -> dict:
    """Warm default builds of the main-path corpus, other / this / this /
    other, one process a turn."""
    import statistics
    turns = []
    for side, root in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        run = subprocess.run(
            [sys.executable, "-c", SIDE, str(root), str(ROOT),
             str(WARM_BUILDS)], capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"{side} ({root}) failed:\n{run.stderr}")
        turns.append({"side": side, "builds_s": json.loads(
            run.stdout.strip().splitlines()[-1])})
    med = {side: statistics.median(s for t in turns if t["side"] == side
                                   for s in t["builds_s"])
           for side in ("other", "this")}
    return {"other": str(other), "turns": turns, "median_s": med}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_dense_rank: no CUDA device; this runs on the card only",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--against"]:
        print(json.dumps({"default_builds": default_builds(
            Path(sys.argv[2]).resolve())}), flush=True)
    import chip_smoke as cs
    from repro_torch.kernels import _build, dense_rank, ref
    dev = torch.device("cuda", 0)
    libs = {"port": _build.library(), **build_variants()}
    samples, words, window, sp = level0_inputs(dev)
    n_rows, w = samples.shape
    stream = torch.cuda.current_stream(dev).cuda_stream

    def scratch(n):
        return torch.zeros(-(-n // dense_rank.TILE_ROWS) + 2,
                           dtype=torch.int64, device=dev)

    def rows(lib):
        ranks = torch.empty(n_rows, dtype=torch.int32, device=dev)
        scr = scratch(n_rows)
        _build.check(lib.repro_dense_rank_rows(
            samples.data_ptr(), n_rows, w, w, ranks.data_ptr(),
            scr.data_ptr(), 0, stream), "dense_rank_rows")
        return ranks, scr[1:2].view(torch.int32)[0]

    def gather(lib, pos):
        n = len(pos)
        ranks = torch.empty(n, dtype=torch.int32, device=dev)
        is_start = torch.empty(n, dtype=torch.bool, device=dev)
        scr = scratch(n)
        ptrs = (ctypes.c_void_p * len(words))(*(x.data_ptr() for x in words))
        _build.check(lib.repro_dense_rank_gather(
            ptrs, len(words), pos.data_ptr(), n, ranks.data_ptr(),
            is_start.data_ptr(), scr.data_ptr(), 0, stream),
            "dense_rank_gather")
        return ranks, is_start, scr[1:2].view(torch.int32)[0]

    def rows_alone(lib, reps=20):
        """ms a launch with the scratch zeroed beforehand."""
        ranks = torch.empty(n_rows, dtype=torch.int32, device=dev)
        scrs = [scratch(n_rows) for _ in range(reps + 1)]
        lib.repro_dense_rank_rows(samples.data_ptr(), n_rows, w, w,
                                  ranks.data_ptr(), scrs[-1].data_ptr(), 0,
                                  stream)
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for scr in scrs[:reps]:
            lib.repro_dense_rank_rows(samples.data_ptr(), n_rows, w, w,
                                      ranks.data_ptr(), scr.data_ptr(), 0,
                                      stream)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps

    want_rows = ref.dense_rank_rows_ref(samples)
    want = {"window": ref.dense_rank_gathered_ref(words, window),
            "samples": ref.dense_rank_gathered_ref(words, sp)}
    for got, exp in zip(rows(libs["port"]), want_rows):
        cs.require_equal("dense_rank_rows", got, exp)
    for site, pos in (("window", window), ("samples", sp)):
        for got, exp in zip(gather(libs["port"], pos), want[site]):
            cs.require_equal(f"dense_rank_gather {site}", got, exp)

    t0 = time.perf_counter()
    times: dict[str, dict] = {}
    for name in ["port", *VARIANTS, "port"]:
        lib = libs[name]
        entry = times.setdefault(name, {"rows_ms": [], "rows_alone_ms": [],
                                        "window_ms": [], "samples_ms": []})
        entry["rows_ms"].append(cs.time_ms(lambda: rows(lib), dev, reps=20))
        entry["rows_alone_ms"].append(rows_alone(lib))
        for site, pos in (("window", window), ("samples", sp)):
            entry[f"{site}_ms"].append(
                cs.time_ms(lambda: gather(lib, pos), dev, reps=10))
    bandwidth = cs.dram_bytes_per_s(torch.cuda.get_device_name(0))
    out = {
        "card": cs.card_line(), "rows": [n_rows, w], "window": len(window),
        "samples": len(sp), "words": len(words), "times": times,
        "rows_bound_ms": 1e3 * (samples.numel() * 4 + n_rows * 4)
        / bandwidth,
        "window_bound_ms": 1e3 * cs.gather_bytes(words, window) / bandwidth,
        "samples_bound_ms": 1e3 * cs.gather_bytes(words, sp) / bandwidth,
        "clone_rows_ms": cs.time_ms(lambda: samples.clone(), dev, reps=20),
        "torch_gather_window_ms": cs.time_ms(lambda: words[0][window], dev,
                                             reps=10),
        "torch_gather_samples_ms": cs.time_ms(lambda: words[0][sp], dev,
                                              reps=10),
        "seconds": time.perf_counter() - t0}
    print(json.dumps(out))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
