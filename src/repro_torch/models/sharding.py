"""Logical-axis sharding: parameters carry logical axis names, a rule table
maps them to mesh axes (MaxText-style).

The port of `repro.models.sharding`, as arithmetic: a mesh is its axis
sizes (``{"data": 16, "model": 16}``, `repro_torch.launch.mesh.
production_mesh_shape`), a partition spec is a tuple with one entry a
dimension (None, a mesh axis, or a tuple of mesh axes), and what a
sharding gives is the per-device shape. No device is touched: one card
has no 256-chip mesh, and the dry run (`repro_torch.launch.dryrun`)
needs only the shapes.

Every parameter of the port's `LM` carries its logical axes as
``p.logical_axes`` (set where it is made, `models.attention._param`);
the JAX package's stacked layer leaves have a leading ``"layers"`` axis
(ruled None) that the port's per-layer parameters drop. The JAX
package's ``constrain`` (``with_sharding_constraint`` by logical axes)
and ``ParamCollector`` have no counterpart: there is no mesh to
constrain on one card, and ``_param``'s ``init_rule`` and
``logical_axes`` play the collector's part.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# Default logical → mesh axis rules. `None` = replicate.
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),      # data parallel (pods are extra DP)
    "seq": None,                   # sequence usually unsharded
    "seq_sp": "model",             # sequence-parallel regions (MoE dispatch)
    "vocab": "model",
    "embed": None,                 # d_model
    "embed_fsdp": ("data", "pod"),  # FSDP over ALL pure-DP axes (ZeRO)
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",                # d_ff
    "experts": "model",            # EP
    "expert_mlp": None,
    "layers": None,                # scan dim
    "conv": None,
    "state": None,
}


@dataclass(frozen=True)
class ShardingRules:
    rules: dict = field(default_factory=lambda: dict(DEFAULT_RULES))

    def spec(self, logical_axes: tuple) -> tuple:
        """The partition spec of `logical_axes` (before any mesh)."""
        parts = []
        used = set()
        for ax in logical_axes:
            m = self.rules.get(ax) if ax is not None else None
            # never map two tensor dims to the same mesh axis
            flat = tuple(m) if isinstance(m, tuple) else ((m,) if m else ())
            if any(f in used for f in flat):
                m = None
            for f in flat:
                used.add(f)
            parts.append(m)
        return tuple(parts)

    def with_overrides(self, **kv) -> "ShardingRules":
        r = dict(self.rules)
        r.update(kv)
        return ShardingRules(rules=r)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def filter_spec(spec: tuple, shape, mesh_shape: dict) -> tuple:
    """`repro.models.sharding.logical_to_sharding`'s filter: keep the mesh
    axes the mesh has and, in order, those whose running product still
    divides the dimension (whisper's 12 heads on a 16-way ``model`` axis
    fall back to replication)."""
    out = []
    for entry, dim in zip(spec, shape):
        kept, total = [], 1
        for a in _axes(entry):
            if a in mesh_shape and dim % (total * mesh_shape[a]) == 0:
                kept.append(a)
                total *= mesh_shape[a]
        out.append(None if not kept else
                   kept[0] if len(kept) == 1 else tuple(kept))
    return tuple(out)


def shard_shape(shape, spec: tuple, mesh_shape: dict) -> tuple:
    """The per-device shape of a tensor of `shape` laid out by `spec`
    (each dimension divided by the product of its mesh axes' sizes,
    which must divide it)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, spec):
        n = 1
        for a in _axes(entry):
            n *= mesh_shape[a]
        if dim % n:
            raise ValueError(f"dimension {dim} does not divide over {entry} "
                             f"({n} devices)")
        out.append(dim // n)
    return tuple(out)


def logical_to_shard_shape(shape, logical_axes: tuple, mesh_shape: dict,
                           rules: ShardingRules | None = None
                           ) -> tuple[tuple, tuple]:
    """(the per-device shape, the kept spec) of a tensor of `shape` with
    `logical_axes` under `rules` on a mesh of `mesh_shape`."""
    rules = rules or ShardingRules()
    spec = filter_spec(rules.spec(logical_axes), shape, mesh_shape)
    return shard_shape(shape, spec, mesh_shape), spec


def param_shardings(model, mesh_shape: dict,
                    rules: ShardingRules | None = None) -> dict:
    """{name: (per-device shape, spec)} of every parameter of `model`
    (an `LM`, on any device: only shapes are read)."""
    return {name: logical_to_shard_shape(tuple(p.shape), p.logical_axes,
                                         mesh_shape, rules)
            for name, p in model.named_parameters()}


__all__ = ["DEFAULT_RULES", "ShardingRules", "filter_spec",
           "logical_to_shard_shape", "param_shardings", "shard_shape"]
