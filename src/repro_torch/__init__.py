"""PyTorch and CUDA port of the DC-v suffix-array system in `repro`.

Text → DC-v suffix array (`core.dcv_torch`) → batched count / locate
(`api`), with the window row sort and the sample ranking on hand-written
Hopper kernels (`kernels`). The package imports torch and numpy only.
Entry points run on ``device="cuda"`` unless the caller asks for
``device="cpu"``, where the kernels' plain PyTorch versions run instead.
"""
