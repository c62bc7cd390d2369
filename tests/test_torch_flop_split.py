"""`repro_torch.launch.dryrun.flop_split`, a train step's dot FLOPs by
part (attention, recurrent, MLP, experts, unembedding), on the ``meta``
device: at ``smoke()`` widths with two periods and a tail (two encoder
layers), with and without remat, the parts add up to the whole step's
`op_stats` count exactly, for all ten configs, and each part is there
where the config has it."""
import pytest

from repro_torch.configs import get_config, model_archs
from repro_torch.launch import dryrun, op_stats
from repro_torch.models.config import ShapeConfig

B, S = 2, 64


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("arch", model_archs())
def test_flop_split_adds_up_to_the_count(arch, remat):
    cfg = get_config(arch).smoke()
    P = len(cfg.pattern)
    cfg = cfg.replace(n_layers=2 * P + (P > 1), remat=remat,
                      encoder_layers=2 if cfg.is_encdec else 0)
    split = dryrun.flop_split(cfg, B, S)
    fn, args, _ = dryrun.step_cell(cfg, ShapeConfig("t", S, B, "train"),
                                   {"data": 1, "model": 1})
    assert sum(split.values()) == op_stats.count(fn, *args)["flops"]
    assert split["unembedding"] > 0
    assert (split["experts"] > 0) == cfg.is_moe
    assert (split["attention"] > 0) == any(k in "glb" for k in cfg.pattern)
    assert (split["recurrent"] > 0) == any(k in "rw" for k in cfg.pattern)
