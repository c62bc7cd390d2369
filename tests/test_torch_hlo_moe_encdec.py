"""Counted train-step FLOPs of the port (`repro_torch.launch.op_stats` on
``meta``) against `repro.launch.hlo_stats` of the JAX package's compiled
step, at ``smoke()`` widths with ``remat="full"``: phi3.5-moe (the MoE)
and whisper-small (the encoder-decoder). See `tests/torch_hlo_ref.py`
for what is compared and why twice: here XLA keeps some of the flash
attention's own recompute (phi3.5-moe: one attention's score and value
products, 1.1% of the step; whisper-small: every encoder and
cross-attention forward, 3.7%), which the port does not run.
"""
import pytest

from torch_hlo_ref import (REL, port_attention_forward_flops, port_flops,
                           reference_flops)

ARCHS = ("phi3.5-moe-42b-a6.6b", "whisper-small")


@pytest.fixture(scope="module")
def counts():
    return {arch: (port_flops(arch), reference_flops(arch),
                   reference_flops(arch, flash_checkpoint=False),
                   port_attention_forward_flops(arch))
            for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_flops_match_hlo_stats(counts, arch):
    ours, ref, ref_no_flash_ckpt, attn = counts[arch]
    assert abs(ours - ref_no_flash_ckpt) <= REL * ref_no_flash_ckpt, \
        (ours, ref_no_flash_ckpt)
    assert 0 < ref - ours <= attn, (ours, ref, attn)
