"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

`ops` holds the wrappers the rest of the package calls; `ref` the plain
versions; `csrc/` the CUDA sources, built at first use by `_build`.
"""
