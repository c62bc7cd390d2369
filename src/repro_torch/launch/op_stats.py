"""Operation statistics of a step, counted op by op as it runs: the
counterpart of `repro.launch.hlo_stats`.

The JAX package parses the optimised HLO of a compiled step: dot FLOPs
(2 · prod(result) · contracted size), convolution FLOPs, the operand and
result bytes of every top-level (unfused) op, collective bytes, and
while-loop bodies scaled by their known trip counts. The port has no HLO,
so `OpCounter` (a `TorchDispatchMode`) sees each aten op as it is
dispatched, on any device (``meta`` included, where nothing is
allocated):

* ``flops``: dot FLOPs (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
  ``dot``: 2 · prod(result) · contracted size) and convolution FLOPs
  (PyTorch's own formulas); elementwise FLOPs are not counted, as there.
  A product whose contracted size is 1 is an outer product in a dot's
  dress (the backward of ``einsum("bcd,bcd->bc")``); XLA emits it as an
  elementwise multiply and `hlo_stats` does not count it, so neither does
  this.
* ``bytes``: the operand and result bytes of every op that is not a
  view. Eager PyTorch fuses nothing, so every op is "top-level" and this
  sits well above XLA's fused traffic; it is reported, not held to the
  reference.
* ``peak_bytes``: the most bytes that the ops' results held live at once
  (storages are counted from their making to their release), i.e. the
  step's working set above its arguments; ``saved_bytes`` and
  ``grads_bytes``, those live when the backward starts (what the forward
  saved for it) and when it ends (the gradients), 0 without a backward.

There are no collectives on one card.

Trip counts (`scaled_count`): a step of L layers runs the same pattern
period ⌊L/P⌋ times, so from one period on its counts are affine in the
number of periods (and in the encoder's depth); an RWKV6-only step is
affine in its length too (the per-position time-mix loop, the 512-token
loss chunks). The step is counted whole at two depths (one period and
two, the L mod P tail kept, and the encoder at one layer and two) and,
where it applies, at two
lengths (512 and 1,024), and the counts are extrapolated to the real
depth and length: exact, as
`hlo_stats.aggregate`'s ``known_trip_count`` scaling is, because every
period (every position) dispatches the same ops. The peak is not affine
in depth (under remat a period's working set lives only while that
period runs), so its prediction is the peak at the second depth sample
(at the real length) plus what more the deeper step holds at once:
the larger of its extra saved bytes and its extra gradient bytes, both
extrapolated as the counts are.
"""
from __future__ import annotations

import itertools
import weakref
from fractions import Fraction

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

#: the loss's and the attention's chunk: an RWKV6-only step's counts are
#: polynomials in its length over multiples of it.
SEQ_UNIT = 512


def _dot_flops(func, args, out) -> int:
    """2 · prod(result) · contracted size of a dot op; 0 for an outer
    product (contracted size 1)."""
    if func in (aten.mm.default, aten.bmm.default):
        k = args[0].shape[-1]
    elif func in (aten.addmm.default, aten.baddbmm.default):
        k = args[1].shape[-1]
    elif func in (aten.mv.default, aten.dot.default):
        k = args[0].shape[-1]
    else:
        return -1
    return 0 if k == 1 else 2 * out.numel() * int(k)


_CONV = ("convolution", "_convolution", "convolution_backward",
         "cudnn_convolution", "convolution_overrideable")


def _conv_flops(func, args, kwargs, out) -> int:
    from torch.utils.flop_counter import flop_registry
    formula = flop_registry.get(func._overloadpacket)
    return int(formula(*args, **kwargs, out_val=out)) if formula else 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the dot and convolution FLOPs, the op bytes and the peak of
    the live result bytes of everything dispatched inside it (see the
    module's docstring). Holds no reference to any tensor."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak_bytes = 0
        self.saved_bytes = None
        self.grads_bytes = 0
        self.ops = 0
        self._held: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        backward = torch._C._current_autograd_node() is not None
        if backward and self.saved_bytes is None:
            self.saved_bytes = self.live
        out = func(*args, **kwargs)
        self.ops += 1
        try:
            return self._count(func, args, kwargs, out)
        finally:
            if backward:
                self.grads_bytes = self.live

    def _count(self, func, args, kwargs, out):
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns):
            return out                          # a view: no data moves
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        flops = _dot_flops(func, args, out)
        if flops < 0:
            flops = _conv_flops(func, args, kwargs, out) \
                if func._overloadpacket.__name__ in _CONV else 0
        self.flops += flops
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if not any(r.alias_info is not None for r in func._schema.returns):
            for t in outs:
                self._hold(t.untyped_storage())
        return out

    def _hold(self, storage) -> None:
        key = storage._cdata
        if key in self._held:
            return
        n = storage.nbytes()
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)

        def release(_, key=key, n=n):
            self.live -= n
            self._held.pop(key, None)
        self._held[key] = weakref.ref(storage, release)

    def stats(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "peak_bytes": self.peak_bytes,
                "saved_bytes": self.saved_bytes or 0,
                "grads_bytes": self.grads_bytes, "ops": self.ops}


def count(fn, *args, **kwargs) -> dict:
    """`OpCounter.stats` of one call ``fn(*args, **kwargs)``."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
        del out
    return counter.stats()


def _points(cfg, seq_len: int, seq_unit: int) -> list:
    """The variables a step's counts are polynomial in, each as (name,
    samples, target): the decoder's periods and the encoder's layers
    (affine: two samples), and an RWKV6-only step's length (quadratic:
    three samples; the backward of a position's slice of a [B, S, ...]
    tensor writes a whole [B, S, ...] gradient, so eager bytes grow as
    S², FLOPs only as S)."""
    P = len(cfg.pattern)
    n_full = cfg.n_layers // P
    out = []
    # affine from one period on: a stacked leaf's Adafactor update runs
    # once for all its periods and not at all at none, and an
    # encoder-decoder's encoder feeds the decoder's cross-attention only
    if n_full > 2:
        out.append(("periods", (1, 2), n_full))
    if cfg.encoder_layers > 2:
        out.append(("encoder_layers", (1, 2), cfg.encoder_layers))
    if set(cfg.pattern) == {"w"} and seq_len > 3 * seq_unit \
            and seq_len % seq_unit == 0:
        out.append(("seq_len", tuple(seq_unit * j for j in (1, 2, 3)),
                    seq_len))
    return out


def _weights(samples: tuple, target: int) -> list[int]:
    """The Lagrange weights of `samples` at `target` (integers here)."""
    out = []
    for j, xj in enumerate(samples):
        w = Fraction(1)
        for m, xm in enumerate(samples):
            if m != j:
                w *= Fraction(target - xm, xj - xm)
        assert w.denominator == 1, (samples, target)
        out.append(int(w))
    return out


def _extrapolate(runs: dict, points: list, key: str, pin=()) -> int:
    """``runs[corner][key]`` interpolated to the targets of `points` (a
    polynomial in each variable through its samples); the variables named
    in `pin` stay at their last sample."""
    total = 0
    for corner, st in runs.items():
        weight = 1
        for (name, samples, target), j in zip(points, corner):
            if name in pin:
                weight *= j == len(samples) - 1
            else:
                weight *= _weights(samples, target)[j]
        total += weight * st[key]
    return total


def scaled_count(build, cfg, seq_len: int, seq_unit: int = SEQ_UNIT
                 ) -> dict:
    """The counts of the step ``fn(*args)`` with ``fn, args = build(cfg,
    seq_len)``, taken at one period and two (and the encoder at one layer
    and two, for an encoder-decoder; an RWKV6-only step at
    1, 2 and 3 `seq_unit` s, which must keep the loss's 512-token chunks:
    a multiple of 512, or all three at most 512) and interpolated to
    `cfg`'s depth and `seq_len` (see the module's docstring). With no
    variable to scale, the step is counted whole. ``runs`` lists the
    counted corners."""
    P = len(cfg.pattern)
    rem = cfg.n_layers % P
    points = _points(cfg, seq_len, seq_unit)
    runs, listed = {}, []
    for corner in itertools.product(*(range(len(s)) for _, s, _ in points)):
        kw, S = {}, seq_len
        for (name, samples, _), j in zip(points, corner):
            if name == "periods":
                kw["n_layers"] = samples[j] * P + rem
            elif name == "encoder_layers":
                kw["encoder_layers"] = samples[j]
            else:
                S = samples[j]
        fn, args = build(cfg.replace(**kw) if kw else cfg, S)
        runs[corner] = count(fn, *args)
        del fn, args
        listed.append(dict(kw, seq_len=S, **runs[corner]))
    out = {k: _extrapolate(runs, points, k) for k in ("flops", "bytes")}
    depth = {name for name, *_ in points if name != "seq_len"}
    more = max(_extrapolate(runs, points, k)
               - _extrapolate(runs, points, k, pin=depth)
               for k in ("saved_bytes", "grads_bytes"))
    out["peak_bytes"] = _extrapolate(runs, points, "peak_bytes",
                                     pin=depth) + max(more, 0)
    return dict(out, runs=listed,
                scaled={name: target for name, _, target in points})


__all__ = ["OpCounter", "SEQ_UNIT", "count", "scaled_count"]
