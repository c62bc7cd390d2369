"""The mesh of the BSP layer: one controller, p ranks, every collective a
rendezvous. The port of `repro.launch.mesh`.

The JAX package runs Algorithm 3 from one host process over a 1-D `Mesh`
through `shard_map`: one program, written per shard, whose collectives
(`ppermute`, `all_gather`, `all_to_all`) every shard reaches in the same
order. `LocalMesh` is that program's counterpart over the devices of one
process. A rank's body is a Python generator: it computes on its own
tensors and *yields* each collective (``halo = yield ppermute(x, perm)``;
nested bodies use ``yield from``). `LocalMesh.run` advances the p
generators to their next yield, checks that all p yielded the same
collective with the same static arguments (kind, permutation, shape,
dtype), performs it as tensor copies between the ranks' devices, sends
each rank its share and counts one rendezvous. A rank that yields another
collective than the rest, or returns while the rest yield, is a divergent
schedule — the runtime counterpart of the reference's SCHED001 lint — and
raises `ScheduleError` at once.

There are no threads: a failing rank raises in the caller, nothing can
hang, and the kernels' lazy build and launch counters stay
single-threaded. Ranks on one card run one after another on its stream;
each kernel of each rank goes to that stream anyway.

Semantics kept from `jax.lax`: `ppermute` gives zeros to a rank that
receives nothing; `all_gather` stacks the ranks in rank order;
`all_to_all` (split and concat axis 0, untiled) gives rank r the stack of
every rank's row r.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.compat import resolve_device
from ..trace import span

KINDS = ("ppermute", "all_gather", "all_to_all")


@dataclass(frozen=True)
class Collective:
    """What a rank's body yields: the collective's kind, this rank's
    tensor and, for `ppermute`, the (source, destination) pairs."""

    kind: str
    x: torch.Tensor
    perm: tuple = ()

    def signature(self) -> tuple:
        """The static arguments every rank must agree on."""
        return (self.kind, self.perm, tuple(self.x.shape), self.x.dtype)


def ppermute(x: torch.Tensor, perm) -> Collective:
    """Send x from rank s to rank d for each (s, d) in `perm`."""
    return Collective("ppermute", x, tuple((int(s), int(d)) for s, d in perm))


def all_gather(x: torch.Tensor) -> Collective:
    """Every rank receives the ranks' x stacked in rank order: [p, *x.shape]."""
    return Collective("all_gather", x)


def all_to_all(x: torch.Tensor) -> Collective:
    """x is [p, ...]; rank r receives the stack of every rank's x[r]."""
    return Collective("all_to_all", x)


class ScheduleError(RuntimeError):
    """The ranks' bodies reached different collectives: on a real mesh
    they would wait for each other for ever."""


class LocalMesh:
    """A 1-D mesh of p ranks over the devices of this process; rank r runs
    on ``devices[r]``. `rendezvous` counts the collectives performed."""

    def __init__(self, devices, axis: str = "bsp"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one rank")
        self.axis = axis
        self.rendezvous = 0

    @property
    def p(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> tuple[str]:
        return (self.axis,)

    @property
    def shape(self) -> dict:
        return {self.axis: self.p}

    def __repr__(self) -> str:
        return f"LocalMesh(p={self.p}, axis={self.axis!r}, " \
               f"devices={sorted({str(d) for d in self.devices})})"

    def run(self, body, per_rank_args) -> list:
        """Run ``body(rank, *per_rank_args[rank])`` on every rank, in
        lockstep from one collective to the next; returns the ranks'
        return values in rank order."""
        if len(per_rank_args) != self.p:
            raise ValueError(f"{len(per_rank_args)} argument tuples for a "
                             f"mesh of {self.p} ranks")
        gens = [body(me, *args) for me, args in enumerate(per_rank_args)]
        if not all(hasattr(g, "send") for g in gens):
            raise TypeError("a rank's body must be a generator (it yields "
                            "its collectives)")
        replies = [None] * self.p
        try:
            while True:
                requests, results = [], []
                with span("repro_torch.mesh.local"):
                    for g, reply in zip(gens, replies):
                        try:
                            requests.append(g.send(reply))
                        except StopIteration as stop:
                            results.append(stop.value)
                if results:
                    if requests:
                        raise ScheduleError(
                            f"{len(results)} of {self.p} ranks returned "
                            f"while {len(requests)} yield "
                            f"{requests[0].kind}")
                    return results
                with span("repro_torch.mesh.collective"):
                    replies = self._perform(requests)
                self.rendezvous += 1
        finally:
            for g in gens:
                g.close()

    def _perform(self, requests: list) -> list:
        first = requests[0]
        for me, req in enumerate(requests):
            if not isinstance(req, Collective) or req.kind not in KINDS:
                raise TypeError(f"rank {me} yielded {req!r}, not a "
                                f"collective")
            if req.signature() != first.signature():
                raise ScheduleError(
                    f"divergent collective schedule: rank {me} yields "
                    f"{req.signature()} where rank 0 yields "
                    f"{first.signature()}")
            if req.x.device != self.devices[me]:
                raise ValueError(f"rank {me} sends a tensor on "
                                 f"{req.x.device}, its rank lives on "
                                 f"{self.devices[me]}")
        xs = [req.x for req in requests]
        if first.kind == "ppermute":
            src_of = {}
            for s, d in first.perm:
                if not (0 <= s < self.p and 0 <= d < self.p) or d in src_of:
                    raise ValueError(f"bad ppermute pairs {first.perm}")
                src_of[d] = s
            return [xs[src_of[r]].to(dev, copy=True) if r in src_of
                    else torch.zeros_like(xs[r])
                    for r, dev in enumerate(self.devices)]
        if first.kind == "all_gather":
            return [torch.stack([x.to(dev) for x in xs])
                    for dev in self.devices]
        if first.x.dim() == 0 or first.x.shape[0] != self.p:
            raise ValueError(f"all_to_all needs a leading axis of {self.p}, "
                             f"got shape {tuple(first.x.shape)}")
        return [torch.stack([x[r].to(dev) for x in xs])
                for r, dev in enumerate(self.devices)]


def visible_devices(device="cuda") -> list[torch.device]:
    """The devices of `device`'s kind that this process sees: every CUDA
    card, or the one CPU. Raises without a card when CUDA is asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if dev.type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"no mesh over {dev.type} devices")


def make_sa_mesh(p: int | None = None, axis: str = "bsp",
                 device="cuda") -> LocalMesh:
    """1-D mesh for the BSP suffix-array pipeline (the paper's p). Rank r
    runs on ``devices[r % len(devices)]`` of `visible_devices(device)`:
    p ranks share one card, or take one card each, or share the CPU.
    ``p=None`` takes one rank a device, as the reference does."""
    devs = visible_devices(device)
    p = p or len(devs)
    return LocalMesh([devs[r % len(devs)] for r in range(p)], axis)


def production_mesh_shape(*, multi_pod: bool = False) -> dict:
    """The axis sizes of the JAX package's production meshes
    (`repro.launch.mesh.make_production_mesh`): one pod is (data=16,
    model=16) = 256 chips; two pods are (pod=2, data=16, model=16) = 512
    chips, the ``pod`` axis pure extra data parallelism. No device is
    made: one card has no such mesh, and the dry run
    (`repro_torch.launch.dryrun`) needs only the sizes."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def mesh_num_devices(mesh) -> int:
    """The number of ranks of a mesh (the product of its axis sizes): a
    `LocalMesh`, or a dict of axis sizes (`production_mesh_shape`)."""
    sizes = mesh.values() if isinstance(mesh, dict) else \
        [mesh.shape[a] for a in mesh.axis_names]
    n = 1
    for size in sizes:
        n *= size
    return n
