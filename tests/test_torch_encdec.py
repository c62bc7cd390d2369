"""The port's encoder-decoder (whisper-small at ``smoke()``) held against
the JAX package's on the CPU, with the same params (`lm_init` of the
reference through `params_from_jax`) and inputs (numpy, from a seed).

* `encode` over seeded frame embeddings, the sinusoids, and the
  cross-attention of one decoder block (`attention_layer` with the
  encoder's k, v and no RoPE): within 0.05 of the reference's largest
  magnitude (the bf16 rule of tests/models/test_decode.py).
* `decode_step` over seeded tokens with the encoder's output: each
  step's logits within 0.05 of the reference's decode step and of the
  port's own full forward.
* One `make_train_step` with ``enc_embeds`` in the batch: loss within
  1e-2 absolute, grad norm within 5% (the rule of tests/test_torch_train).
* `launch.train.main` on whisper-small: each step draws its frame
  embeddings (`default_rng(step)`, as the reference's launcher does) and
  the memorization probe is skipped.

(`lm_loss` and the forward of whisper-small are among the ten cases of
tests/test_torch_models.py.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.train.optim as joptim
import repro.train.train_step as jtrain
from repro.models import attention as jattention
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.launch import train as train_launch
from repro_torch.models import attention, lm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import logits_from_embedding
from repro_torch.train import optim
from repro_torch.train.train_step import (TrainConfig, make_train_state,
                                          make_train_step)

CPU = "cpu"
REL = 0.05
LOSS_ABS = 1e-2
B, S = 2, 10


def rel_err(got, want) -> float:
    got = torch.as_tensor(got).detach().float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module")
def whisper():
    jcfg = jconfigs.get_config("whisper_small").smoke()
    cfg = get_config("whisper_small").smoke()
    assert cfg.is_encdec and cfg.rope_base == 0.0
    jparams, _ = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            cfg, device=CPU)
    rng = np.random.default_rng(3)
    enc = (0.02 * rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
           ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jenc = jax.jit(lambda p, e: jlm.encode(p, jcfg, e))(jparams,
                                                        jnp.asarray(enc))
    with torch.no_grad():
        tenc = lm.encode(model, cfg, torch.from_numpy(enc))
    return jcfg, cfg, jparams, model, enc, toks, jenc, tenc


def test_encoder_sinusoids_and_cross_attention_match_jax(whisper):
    jcfg, cfg, jparams, model, enc, toks, jenc, tenc = whisper
    assert tenc.dtype == torch.bfloat16
    assert rel_err(tenc, jenc) < REL
    np.testing.assert_array_equal(
        lm._sinusoid(cfg.enc_seq, cfg.d_model).float().numpy(),
        np.asarray(jlm._sinusoid(cfg.enc_seq, cfg.d_model), np.float32))
    pos = np.array([0, 3, 447])
    assert rel_err(lm._sinusoid_at(torch.from_numpy(pos), cfg.d_model),
                   jlm._sinusoid_at(jnp.asarray(pos), cfg.d_model)) < REL
    # the first decoder block's cross-attention over the encoder output
    h = (0.5 * np.random.default_rng(4).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)
    jxp = jparams["blocks"]["l0"]["xattn"]
    jxp0 = jax.tree_util.tree_map(lambda a: a[0], jxp)
    want, _ = jattention.attention_layer(
        jxp0, jcfg, jnp.asarray(h, jnp.bfloat16), is_local=False,
        kv_override=jlm._cross_kv(jxp0, jenc), causal=False)
    xp = model.blocks[0].xattn
    with torch.no_grad():
        got, cache = attention.attention_layer(
            xp, cfg, torch.from_numpy(h).to(torch.bfloat16), is_local=False,
            kv_override=lm._cross_kv(xp, tenc), causal=False)
    assert cache is None and rel_err(got, want) < REL


def test_decode_matches_jax_and_the_forward(whisper):
    jcfg, cfg, jparams, model, enc, toks, jenc, tenc = whisper
    jstates = jlm.init_decode_states(jcfg, B, cache_len=S)
    jstep = jax.jit(lambda p, t, st, pos: jlm.decode_step(
        p, jcfg, t, st, pos, enc_out=jenc))
    states = lm.init_decode_states(cfg, B, cache_len=S, device=CPU)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        h, _, _ = lm.forward_hidden(model, cfg, tt, enc_out=tenc)
        full = logits_from_embedding(h, model.embed, cfg.logit_softcap)
        scale = float(full.abs().max())
        for t in range(S):
            want, jstates = jstep(jparams, jnp.asarray(toks[:, t:t + 1]),
                                  jstates, jnp.int32(t))
            got, states = lm.decode_step(model, cfg, tt[:, t:t + 1], states,
                                         t, enc_out=tenc)
            assert rel_err(got, want) < REL, t
            assert float((got[:, 0] - full[:, t]).abs().max()) / scale \
                < REL, t


def test_train_step_with_frame_embeddings_matches_jax(whisper):
    jcfg, cfg, jparams, _, _, _, _, _ = whisper
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, 13)).astype(
                 np.int32),
             "enc_embeds": (0.02 * rng.standard_normal(
                 (B, cfg.enc_seq, cfg.d_model))).astype(np.float32)}
    tcfg_j = jtrain.TrainConfig(opt=joptim.OptConfig(lr=1e-3), warmup=0,
                                total_steps=10)
    _, jm = jax.jit(jtrain.make_train_step(jcfg, tcfg_j))(
        jtrain.make_train_state(jparams, tcfg_j),
        jax.tree_util.tree_map(jnp.asarray, batch))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                            device=CPU)
    tcfg = TrainConfig(opt=optim.OptConfig(lr=1e-3), warmup=0,
                       total_steps=10)
    _, m = make_train_step(cfg, tcfg)(make_train_state(model, tcfg), batch)
    assert abs(float(m["loss"]) - float(jm["loss"])) < LOSS_ABS
    assert abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1) < 0.05


def test_train_launch_draws_frame_embeddings_and_skips_the_probe(capsys):
    seen = []
    step = train_launch.make_train_step

    def recording(cfg, tcfg):
        fn = step(cfg, tcfg)

        def run(state, batch):
            seen.append(batch["enc_embeds"])
            return fn(state, batch)
        return run

    argv = ["--arch", "whisper-small", "--smoke", "--steps", "2",
            "--seq-len", "16", "--batch", "2", "--corpus-chars", "20000",
            "--eval-gate", "--probe-every", "1", "--device", "cpu"]
    from unittest import mock
    with mock.patch.object(train_launch, "make_train_step", recording):
        report = train_launch.main(argv)
    cfg = get_config("whisper_small").smoke()
    assert report["probe"] == {} and np.isfinite(report["loss"])
    assert len(seen) == 2
    for i, e in enumerate(seen):
        want = 0.02 * np.random.default_rng(i).standard_normal(
            (2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        np.testing.assert_array_equal(np.asarray(e), want)
