"""Counted train-step FLOPs of the port (`repro_torch.launch.op_stats` on
``meta``) against `repro.launch.hlo_stats` of the JAX package's compiled
step, at ``smoke()`` widths with ``remat="full"``: gemma3-1b (attention,
global and local), recurrentgemma-2b (RG-LRU) and rwkv6-1.6b (RWKV6).
See `tests/torch_hlo_ref.py` for what is compared: for these kinds XLA
folds the flash attention's own recompute into the period's, so the step
is compared as it is.

The 32,768 FLOPs that a count of every ``mm``/``bmm`` would find above
`hlo_stats` on gemma3-1b are the backward of the loss's target logit
(``einsum("bcd,bcd->bc")``): two products of contracted size 1, which XLA
emits as multiplies; `op_stats` counts them as `hlo_stats` does, not at
all.
"""
import pytest

from torch_hlo_ref import REL, port_flops, reference_flops

ARCHS = ("gemma3-1b", "recurrentgemma-2b", "rwkv6-1.6b")


@pytest.fixture(scope="module")
def counts():
    return {arch: (port_flops(arch), reference_flops(arch))
            for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_flops_match_hlo_stats(counts, arch):
    ours, ref = counts[arch]
    assert abs(ours - ref) <= REL * ref, (ours, ref)
