"""Build the CUDA kernels of `repro_torch.kernels` at first use and bind them.

The sources in `csrc/` are compiled with `nvcc` for `sm_90a` into one shared
library with a plain C interface, loaded through `ctypes`. Each source is
compiled to an object file by its own `nvcc` process, all started together,
then linked. The library lands in `build/repro_torch/` at the root of the
checkout, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once.

Every C entry point returns `cudaGetLastError()` after its launch; `check`
turns a non-zero status into a `RuntimeError`.

`LAUNCHES` counts kernel launches by kernel name. Each wrapper adds one where
it launches its kernel and nowhere else, so a caller can zero the counts,
run a path and see which kernels it went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("bitonic_stage.cu", "bitonic_sort.cu", "seg_boundary.cu",
           "radix_hist.cu", "radix_scatter.cu", "dense_rank.cu",
           "lemma1_merge.cu", "encode_place.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: kernel name -> launches so far (plain ints; zero them to start a count).
LAUNCHES = {"bitonic_stage": 0, "bitonic_tile": 0, "bitonic_cross": 0,
            "seg_boundary": 0, "radix_hist": 0, "radix_scatter": 0,
            "dense_rank_rows": 0, "dense_rank_gather": 0, "lemma1_merge": 0,
            "encode_place": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C entry point -> argument types (every entry point returns an int status).
_SIGNATURES = {
    # rows, n, w, num_keys, k, j, device, stream
    "repro_bitonic_stage": (_P, _LL, _I, _I, _LL, _LL, _I, _P),
    # rows, n, w, num_keys, log_s, k_first, k_last, device, stream
    "repro_bitonic_tile": (_P, _LL, _I, _I, _I, _LL, _LL, _I, _P),
    # rows, n, w, num_keys, k, j_hi, r, cb, device, stream
    "repro_bitonic_cross": (_P, _LL, _I, _I, _LL, _LL, _I, _I, _I, _P),
    # rows, flags, csum, totals, n, w, num_keys, block, device, stream
    "repro_seg_boundary": (_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P),
    # digits, out, n, block, n_bins, device, stream
    "repro_radix_hist": (_P, _P, _LL, _I, _I, _I, _P),
    # keys, out, n, block, shift, device, stream
    "repro_radix_pass_counts": (_P, _P, _LL, _I, _I, _I, _P),
    # keys, payload, keys_out, payload_out, offsets, n, block, shift,
    # payload_bytes, device, stream
    "repro_radix_scatter": (_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P),
    # rows, n, w, num_keys, ranks, scratch, device, stream
    "repro_dense_rank_rows": (_P, _LL, _I, _I, _P, _P, _I, _P),
    # words (host array of pointers), k, pos, n, ranks, is_start, scratch,
    # device, stream
    "repro_dense_rank_gather": (_P, _I, _P, _LL, _P, _P, _P, _I, _P),
    # p, klass, rvals, lane, width, lam1, lam2, n, v, d, out, device, stream
    "repro_lemma1_merge": (_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _P, _I,
                           _P),
    # flat, ends, n, d, text, flag, device, stream
    "repro_encode_place": (_P, _P, _LL, _LL, _P, _P, _I, _P),
}

_lib = None
_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, then PATH, then the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "build only where the CUDA toolkit is installed")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources into the shared library unless it exists.
    Returns its path. Concurrent builders each write a private file and
    rename it into place, so a reader never sees a partial library."""
    tag = _digest()
    lib = BUILD_DIR / f"libkernels_{tag}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    private = f"{tag}.{os.getpid()}.{threading.get_ident()}"
    jobs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{Path(src).stem}.{private}.o"
        cmd = [compiler, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for src, _obj, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            failures.append(f"nvcc failed on {src}:\n{out}")
    objs = [obj for _src, obj, _proc in jobs]
    try:
        if failures:
            raise RuntimeError("\n".join(failures))
        tmp = BUILD_DIR / f"libkernels.{private}.so"
        link = subprocess.run(
            [compiler, "-shared", *map(str, objs), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc failed to link {lib.name}:\n"
                               f"{link.stdout}")
        os.replace(tmp, lib)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(status: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA error {status} at launch")
