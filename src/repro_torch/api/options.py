"""`SAOptions` — the single plan object for suffix-array construction.

The port of `repro.api.options`, with the same validation and
`fingerprint` and the same fields less `cache`: the JAX package's builder
cache and bucketed padding bound its compiled shapes, and eager PyTorch
compiles none. Consumers construct one `SAOptions` and hand it to
`repro_torch.api.build_suffix_array`; backends read only the fields they
understand.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Union

from ..core.compat import check_sort_impl
from ..core.seq_ref import accelerated_next_v, fixed_next_v

#: name → schedule fn; `SAOptions.schedule` accepts either the name or a raw
#: ``(v, |D|, m) -> v'`` callable.
SCHEDULES: dict[str, Callable[[int, int, int], int]] = {
    "accelerated": accelerated_next_v,
    "fixed": fixed_next_v,
}

AUTO = "auto"

#: plan field → {port name: the JAX package's name} where the two differ:
#: the torch backend is the counterpart of "jax", the stock-sort and
#: hand-kernel window sorts of "lax" and "pallas". Names not listed
#: ("auto", "oracle", "seq", "bsp", "radix") are spelled alike.
REFERENCE_NAMES = {"backend": {"torch": "jax"},
                   "sort_impl": {"torch": "lax", "kernel": "pallas"}}


@dataclass(frozen=True)
class SAOptions:
    """Construction plan for one suffix-array build.

    Fields
    ------
    backend:        registry key (``"oracle" | "seq" | "torch" | "bsp"``) or
                    ``"auto"``: pick ``"bsp"`` when `mesh` is set, else
                    ``"torch"``. ``"bsp"`` runs Algorithm 3 on the mesh.
    v0:             initial difference-cover modulus (paper Algorithm 1).
    schedule:       ``"accelerated"`` (v' ~ v^{5/4}, the paper's headline),
                    ``"fixed"`` (constant v baseline), or a callable
                    ``(v, |D|, m) -> v'``.
    base_threshold: recursion cutoff; ``None`` keeps each backend's native
                    default (seq: 32, torch: 256, bsp: max(1024, n/p)).
    sort_impl:      the torch backend's window sort
                    (`repro_torch.core.compat`): ``"kernel"`` the Hopper
                    kernels, ``"torch"`` stock `torch.sort`, ``"radix"``
                    the LSD radix sort on the histogram and scatter
                    kernels, ``"bitonic"`` the legacy fused comparator
                    network, ``"auto"`` → ``"radix"`` on a CUDA device
                    and ``"kernel"`` on the CPU. The bsp backend's
                    rank-local sorts (`repro_torch.bsp.psort`):
                    ``"radix"``, ``"torch"``, ``"bitonic"``, ``"auto"`` →
                    ``"radix"`` (``"torch"`` without `pack_keys`).
    mesh, axis, pack_keys, counters:
                    BSP-backend fields: the `repro_torch.launch.mesh`
                    mesh and its axis name, SM1/SM2 key packing, and a
                    `repro_torch.bsp.counters.BSPCounters` sink.
    stats:          ``repro_torch.core.seq_ref.SeqStats`` sink (seq backend).
    validate:       check input values are non-negative ints before building.
    segment_docs, compact_fanin:
                    serving-layer segmentation knobs, excluded from
                    `fingerprint()`.
    sample_rate:    sampled-position indexing stride: ``1`` is the dense
                    suffix array; ``s > 1`` makes `SuffixArrayIndex.build`
                    / `.from_docs` build a `repro_torch.sparse` index of
                    every s-th position.
    """

    backend: str = AUTO
    v0: int = 3
    schedule: Union[str, Callable[[int, int, int], int]] = "accelerated"
    base_threshold: int | None = None
    sort_impl: str = AUTO
    mesh: Any = None
    axis: str = "bsp"
    pack_keys: bool = True
    counters: Any = None
    stats: Any = None
    validate: bool = True
    segment_docs: int | None = None
    compact_fanin: int = 4
    sample_rate: int = 1

    def __post_init__(self):
        if isinstance(self.schedule, str) and self.schedule not in SCHEDULES:
            raise ValueError(
                f"unknown schedule {self.schedule!r}; "
                f"expected one of {sorted(SCHEDULES)} or a callable")
        if self.v0 < 3:
            raise ValueError(f"v0 must be ≥ 3 (difference covers), got {self.v0}")
        check_sort_impl(self.sort_impl)
        if self.segment_docs is not None and self.segment_docs < 1:
            raise ValueError(
                f"segment_docs must be ≥ 1, got {self.segment_docs}")
        if self.compact_fanin < 2:
            raise ValueError(
                f"compact_fanin must be ≥ 2, got {self.compact_fanin}")
        if self.sample_rate < 1:
            raise ValueError(
                f"sample_rate must be ≥ 1, got {self.sample_rate}")

    @property
    def schedule_fn(self) -> Callable[[int, int, int], int]:
        if callable(self.schedule):
            return self.schedule
        return SCHEDULES[self.schedule]

    def resolve_backend(self) -> str:
        """Concrete registry key for this plan (applies the auto rule)."""
        if self.backend != AUTO:
            return self.backend
        return "bsp" if self.mesh is not None else "torch"

    def fingerprint(self) -> str:
        """Stable identity of the construction plan, for staleness checks.

        Covers the fields that *describe* the build (backend spelling, v0,
        schedule, base_threshold, sort_impl, pack_keys, sample_rate) and
        excludes runtime objects (mesh, counters/stats sinks),
        execution-only knobs (validate) and serving-layer
        segmentation knobs (segment_docs, compact_fanin). Callable
        schedules fingerprint by name. Backend and sort_impl are spelled
        in the JAX package's names (`REFERENCE_NAMES`), so a plan and its
        counterpart there share one fingerprint and the persisted indexes
        of the two packages (`repro_torch.api.store`) share one identity.
        """
        sched = (self.schedule if isinstance(self.schedule, str)
                 else f"callable:{getattr(self.schedule, '__name__', 'anon')}")
        backend, sort_impl = (
            REFERENCE_NAMES[field].get(value, value) for field, value in
            (("backend", self.backend), ("sort_impl", self.sort_impl)))
        return (f"plan-v2|backend={backend}|v0={self.v0}"
                f"|schedule={sched}|base={self.base_threshold}"
                f"|sort={sort_impl}|pack={int(self.pack_keys)}"
                f"|rate={self.sample_rate}")

    def replace(self, **changes) -> "SAOptions":
        return dataclasses.replace(self, **changes)
