"""The port's LM (`repro_torch.models`) held against the JAX package's
(`repro.models`) on the CPU, with the same params.

The params come from `repro.models.lm.lm_init(PRNGKey(k), cfg)` and reach
the port through `params_from_jax`; tokens, masks and the encoder's frame
embeddings are made with numpy from a seed. For each of the ten
architectures at ``smoke()`` (and gemma3-1b at 8 layers, one period of 6
plus a tail of 2): the hidden states (through the encoder for
whisper-small), the logits, the MoE aux loss, and `lm_loss` with and
without a ``loss_mask`` (and through the ``embeds`` path of chameleon's
frontend stub). Also the conversion's round trip, the port's own init
against the reference's leaf set, shapes, dtypes and scales, and
`get_config` / `SAConfig` against `repro.configs`.

Tolerances: hidden states and logits within 0.05 of the largest magnitude
of the reference's (the bf16 rule of tests/models/test_decode.py); the
loss and the aux loss within 1e-2 absolute; an init leaf's std within 10%
of the reference leaf's, or within three standard errors of two sample
stds of n draws (3/√n) where n is too small for 10%, and a constant leaf
equal to the reference's.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import lm as jlm
from repro.models.layers import logits_from_embedding as jlogits
from repro_torch.configs import (MODEL_ARCHS, PORTED_ARCHS, SAConfig,
                                 get_config)
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.layers import logits_from_embedding

CPU = "cpu"
REL = 0.05
LOSS_ABS = 1e-2
B, S = 2, 24

CASES = [(a, None) for a in PORTED_ARCHS] + [("gemma3_1b", 8)]


def rel_err(got, want) -> float:
    got = torch.as_tensor(got).detach().float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def configs(arch, n_layers):
    jcfg = jconfigs.get_config(arch).smoke()
    cfg = get_config(arch).smoke()
    if n_layers:
        jcfg, cfg = jcfg.replace(n_layers=n_layers), \
            cfg.replace(n_layers=n_layers)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def batch_np(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.25).astype(np.float32)
    return toks, mask


def enc_embeds_np(cfg, seed):
    """The encoder's frame embeddings [B, enc_seq, d] (enc-dec only)."""
    if not cfg.is_encdec:
        return None
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (B, cfg.enc_seq, cfg.d_model))).astype(np.float32)


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-L{n}" if n else a for a, n in CASES])
def case(request):
    arch, n_layers = request.param
    jcfg, cfg = configs(arch, n_layers)
    jparams, _ = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, cfg, jparams, params_np, params_from_jax(params_np, cfg,
                                                          device=CPU)


def test_hidden_and_logits_match_jax(case):
    jcfg, cfg, jparams, _, model = case
    toks, _ = batch_np(cfg, 1)
    enc = enc_embeds_np(cfg, 5)
    jenc = tenc = None
    if enc is not None:
        jenc = jlm.encode(jparams, jcfg, jnp.asarray(enc))
        with torch.no_grad():
            tenc = lm.encode(model, cfg, torch.from_numpy(enc))
        assert rel_err(tenc, jenc) < REL
    jh, _, jaux = jlm.forward_hidden(jparams, jcfg,
                                     tokens=jnp.asarray(toks[:, :-1]),
                                     enc_out=jenc)
    with torch.no_grad():
        h, _, aux = lm.forward_hidden(model, cfg,
                                      torch.from_numpy(toks[:, :-1]),
                                      enc_out=tenc)
        logits = logits_from_embedding(h, model.embed, cfg.logit_softcap)
    assert h.dtype == torch.bfloat16 and h.shape == (B, S, cfg.d_model)
    assert abs(float(aux) - float(jaux)) < LOSS_ABS
    assert (float(aux) > 0) == cfg.is_moe
    assert rel_err(h, jh) < REL
    want = jlogits(jh, jparams["embed"], cap=cfg.logit_softcap)
    assert rel_err(logits, want) < REL


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_jax(case, masked):
    jcfg, cfg, jparams, _, model = case
    toks, mask = batch_np(cfg, 2)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks)}
    enc = enc_embeds_np(cfg, 6)
    if enc is not None:
        jb["enc_embeds"] = jnp.asarray(enc)
        tb["enc_embeds"] = torch.from_numpy(enc)
    if masked:
        jb["loss_mask"] = jnp.asarray(mask)
        tb["loss_mask"] = torch.from_numpy(mask)
    jl, jm = jlm.lm_loss(jparams, jcfg, jb)
    with torch.no_grad():
        loss, m = lm.lm_loss(model, cfg, tb)
    assert abs(float(loss) - float(jl)) < LOSS_ABS
    assert abs(float(m["xent"]) - float(jm["xent"])) < LOSS_ABS
    assert abs(float(m["aux"]) - float(jm["aux"])) < LOSS_ABS
    assert float(m["tokens"]) == float(jm["tokens"]) == \
        (mask.sum() if masked else B * S)
    assert float(m["xent"]) < np.log(cfg.vocab_size) + 3.0


def test_embeds_path_of_the_frontend_stub_matches_jax():
    jcfg, cfg = configs("chameleon_34b", None)
    assert cfg.frontend == "vision"
    jparams, _ = jlm.lm_init(jax.random.PRNGKey(3), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                            device=CPU)
    toks, mask = batch_np(cfg, 3)
    embeds = (0.5 * np.random.default_rng(4).normal(
        size=(B, S, cfg.d_model))).astype(np.float32)
    jl, _ = jlm.lm_loss(jparams, jcfg, {"tokens": jnp.asarray(toks),
                                         "embeds": jnp.asarray(embeds),
                                         "loss_mask": jnp.asarray(mask)})
    with torch.no_grad():
        loss, _ = lm.lm_loss(model, cfg, {
            "tokens": torch.from_numpy(toks),
            "embeds": torch.from_numpy(embeds),
            "loss_mask": torch.from_numpy(mask)})
        plain, _ = lm.lm_loss(model, cfg, {"tokens": torch.from_numpy(toks)})
    assert abs(float(loss) - float(jl)) < LOSS_ABS
    assert abs(float(loss) - float(plain)) > LOSS_ABS   # embeds were used


def test_params_from_jax_round_trip(case):
    _, cfg, _, params_np, model = case
    back = params_to_jax(model)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params_np)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params_np)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # and the other way: the port's params through the JAX layout and back
    again = params_from_jax(back, cfg, device=CPU)
    for (n, p), (m, q) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert n == m and p.equal(q)


def test_tail_layers_map_to_the_reference_layout():
    """gemma3-1b at full depth (26 = 4 periods of 6 + a tail of 2): layer
    p·6 + j is blocks.l{j}[p], layers 24 and 25 are tail.l0 and tail.l1."""
    cfg = get_config("gemma3_1b").smoke().replace(n_layers=26)
    model = lm.LM(cfg, device=CPU)
    with torch.no_grad():
        for i, blk in enumerate(model.blocks):
            blk.norm1.fill_(i)
    tree = params_to_jax(model)
    assert tree["blocks"]["l5"]["norm1"].shape == (4, cfg.d_model)
    assert tree["blocks"]["l3"]["norm1"][:, 0].tolist() == [3, 9, 15, 21]
    assert set(tree["tail"]) == {"l0", "l1"}
    assert tree["tail"]["l1"]["norm1"][0] == 25
    assert [b.kind for b in model.blocks][-3:] == ["g", "l", "l"]


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_port_init_matches_reference_leaves_and_scales(arch):
    jcfg, cfg = configs(arch, None)
    jparams, _ = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    ours = params_to_jax(lm.lm_init(cfg, seed=0, device=CPU))
    jflat = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    oflat = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    assert set(oflat) == set(jflat)
    for path, ref in jflat.items():
        got = oflat[path]
        assert got.shape == ref.shape and got.dtype == ref.dtype, path
        ref_std = float(np.std(np.asarray(ref)))
        if ref_std == 0.0:                  # zeros or ones where the same
            np.testing.assert_array_equal(got, np.asarray(ref), str(path))
        else:
            tol = max(0.1, 3.0 / np.sqrt(got.size))
            assert abs(float(np.std(got)) - ref_std) < tol * ref_std, path
            assert abs(float(np.mean(got))) < tol * ref_std, path


def test_lm_init_is_seeded():
    cfg = get_config("minicpm_2b").smoke()
    a = lm.lm_init(cfg, seed=1, device=CPU)
    b = lm.lm_init(cfg, seed=1, device=CPU)
    c = lm.lm_init(cfg, generator=torch.Generator().manual_seed(2),
                   device=CPU)
    assert all(p.equal(q) for p, q in zip(a.parameters(), b.parameters()))
    assert not a.embed.equal(c.embed)


def test_get_config_resolves_ported_and_raises_item_2b():
    """Every model architecture resolves, equal to the reference's (item
    2b is done); an unknown id raises `ValueError`."""
    assert set(PORTED_ARCHS) == set(MODEL_ARCHS) and len(PORTED_ARCHS) == 10
    for arch in PORTED_ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jconfigs.get_config(arch))
    for spelled in ("gemma3-1b", "minicpm-2b", "chameleon-34b",
                    "phi3.5-moe-42b-a6.6b", "rwkv6-1.6b", "whisper-small"):
        assert get_config(spelled).name == spelled
    with pytest.raises(ValueError, match="unknown --arch"):
        get_config("mamba-2.8b")


def test_unported_kinds_raise_item_2b():
    """The kinds "r", "w" and "b", the MoE, cross-attention and
    ``remat="full"`` build (item 2b is done); an unknown kind raises."""
    blocks = {}
    for arch in ("recurrentgemma_2b", "rwkv6_1_6b", "kimi_k2_1t_a32b",
                 "whisper_small"):
        model = lm.LM(get_config(arch).smoke(), device=CPU)
        blocks[arch] = model.blocks
    assert [b.kind for b in blocks["recurrentgemma_2b"]] == ["r", "r", "l"]
    assert hasattr(blocks["rwkv6_1_6b"][0], "cmix")
    assert hasattr(blocks["kimi_k2_1t_a32b"][0], "moe")
    assert hasattr(blocks["whisper_small"][0], "xattn")
    cfg = get_config("minicpm_2b").smoke()
    assert lm.LM(cfg.replace(remat="full"), device=CPU).cfg.remat == "full"
    with pytest.raises(ValueError, match="unknown layer kind"):
        lm.LM(cfg.replace(pattern=("m",)), device=CPU)


def test_sa_config_fields_and_defaults_equal_jax():
    from repro.configs.suffix_array import SAConfig as JSAConfig
    # the port drops `cache`: its builder cache and level padding bounded
    # the JAX package's compiled shapes, and the port compiles none
    ours = [(f.name, f.default) for f in dataclasses.fields(SAConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JSAConfig)]
    assert ("cache", True) in theirs
    assert ours == [f for f in theirs if f != ("cache", True)]
    assert SAConfig().shard_docs == 8


def test_import_lm_stack_loads_no_jax():
    code = ("import sys, repro_torch.models.lm, repro_torch.models.convert, "
            "repro_torch.train.train_step, repro_torch.launch.train, "
            "repro_torch.launch.serve, repro_torch.configs as c; "
            "[c.get_config(a) for a in c.PORTED_ARCHS]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    src = Path(__file__).resolve().parent.parent / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(src),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
