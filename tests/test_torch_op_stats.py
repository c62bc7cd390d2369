"""`repro_torch.launch.op_stats`, the counterpart of `repro.launch.
hlo_stats`, on the CPU and the ``meta`` device.

* The counter on toy products: 2·M·N·K for ``mm``, ``bmm`` and an
  einsum, nothing for an outer product (contracted size 1) or a view, the
  operand and result bytes of each op, the peak of the live result bytes.
* Trip-count scaling: at ``smoke()`` widths, with the depth raised so
  that it scales (three periods and a tail, three encoder layers), the
  scaled count of the ``remat="full"`` train step equals the whole step's
  count exactly in FLOPs, for all ten configs, and its eager bytes within
  1e-5 relative (they are off by a few scalars' bytes where the step at
  no period differs in kind: an MoE's aux loss then takes no gradient;
  and autograd's accumulation of the per-position gradients of rwkv6's
  loop is not a polynomial in the length to the byte); the same for a
  prefill and a decode step. rwkv6 scales its length too (at 64-token
  units, below one loss chunk).
* The predicted peak beside the whole step's tracked peak.
"""
import pytest
import torch

from repro_torch.configs import get_config, model_archs
from repro_torch.launch import dryrun, op_stats
from repro_torch.models.config import ShapeConfig

MESH = {"data": 1, "model": 1}
BYTES_REL = 1e-5
B, S = 2, 64
RWKV_S, RWKV_UNIT = 256, 64


def test_counter_on_toy_products():
    a = torch.randn(8, 5, device="meta")
    b = torch.randn(5, 3, device="meta")
    st = op_stats.count(torch.matmul, a, b)
    assert st["flops"] == 2 * 8 * 3 * 5
    assert st["bytes"] == 4 * (8 * 5 + 5 * 3 + 8 * 3)
    x = torch.randn(4, 8, 5)
    y = torch.randn(4, 5, 3)
    assert op_stats.count(torch.bmm, x, y)["flops"] == 2 * 4 * 8 * 3 * 5
    assert op_stats.count(torch.einsum, "bmk,bkn->bmn", x, y)["flops"] == \
        2 * 4 * 8 * 3 * 5
    # an outer product is an elementwise multiply: not counted
    assert op_stats.count(torch.einsum, "i,j->ij", torch.randn(7),
                          torch.randn(9))["flops"] == 0
    # a view moves nothing; a copy moves its operand and its result
    st = op_stats.count(lambda t: t.view(-1).t().contiguous(), a)
    assert st["flops"] == 0 and st["bytes"] == 0
    st = op_stats.count(lambda t: t.t().contiguous(), a)
    assert st["bytes"] == 2 * 4 * 8 * 5
    # the working set: three [1000] float32 results live at once at most
    v = torch.randn(1000)

    def chain(t):
        u = t * 2
        w = u + 1
        del u
        return (w * 3).sum()
    st = op_stats.count(chain, v)
    assert st["peak_bytes"] == 2 * 4000 + 4 and st["saved_bytes"] == 0


def deep(arch):
    cfg = get_config(arch).smoke()
    P = len(cfg.pattern)
    return cfg.replace(n_layers=3 * P + (P > 1), remat="full",
                       encoder_layers=3 if cfg.is_encdec else 0)


def make_build(kind, batch=B):
    def build(cfg, seq_len):
        fn, args, _ = dryrun.step_cell(
            cfg, ShapeConfig("t", seq_len, batch, kind), MESH)
        return fn, args
    return build


def whole(build, cfg, seq_len):
    fn, args = build(cfg, seq_len)
    return op_stats.count(fn, *args)


@pytest.mark.parametrize("arch", model_archs())
def test_scaled_train_step_equals_whole(arch):
    cfg = deep(arch)
    seq_len = RWKV_S if arch.startswith("rwkv") else S
    build = make_build("train")
    got = op_stats.scaled_count(build, cfg, seq_len, seq_unit=RWKV_UNIT)
    want = whole(build, cfg, seq_len)
    assert got["scaled"]["periods"] == 3
    if cfg.is_encdec:
        assert got["scaled"]["encoder_layers"] == 3
    if arch.startswith("rwkv"):
        assert got["scaled"]["seq_len"] == RWKV_S
    assert got["flops"] == want["flops"] > 0
    assert abs(got["bytes"] - want["bytes"]) <= BYTES_REL * want["bytes"]
    # the prediction of the peak beside the tracked whole step's
    assert 0.5 * want["peak_bytes"] <= got["peak_bytes"] <= \
        2 * want["peak_bytes"], (got["peak_bytes"], want["peak_bytes"])


@pytest.mark.parametrize("arch", ["gemma3-1b", "whisper-small",
                                  "recurrentgemma-2b", "rwkv6-1.6b"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_scaled_serving_steps_equal_whole(arch, kind):
    cfg = deep(arch).replace(remat="none")
    seq_len = RWKV_S if arch.startswith("rwkv") and kind == "prefill" else S
    build = make_build(kind)
    got = op_stats.scaled_count(build, cfg, seq_len, seq_unit=RWKV_UNIT)
    want = whole(build, cfg, seq_len)
    assert got["flops"] == want["flops"] > 0
    assert abs(got["bytes"] - want["bytes"]) <= BYTES_REL * want["bytes"]
    assert got["peak_bytes"] == pytest.approx(want["peak_bytes"], rel=0.5)

