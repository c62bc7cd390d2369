"""Bulk-synchronous building blocks: the port of `repro.bsp`.

Algorithm 3 (`suffix_array.suffix_array_bsp`) on a single-controller mesh
(`repro_torch.launch.mesh.LocalMesh`): Algorithm 2's parallel sort by
regular sampling (`psort`), the two-hop row exchange (`exchange`), the
rank-local primitives (`primitives`; `within_group_index` also serves the
MoE router, `repro_torch.models.ffn`) and the cost accounting
(`counters`). The modules are imported where they are used, so that the
MoE does not load the suffix-array stack.
"""
from .primitives import within_group_index

__all__ = ["within_group_index"]
