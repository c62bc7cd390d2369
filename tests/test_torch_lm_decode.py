"""Greedy decoding of the port (`repro_torch.launch.serve.
prefill_then_decode`) held against the JAX package's on the CPU, past the
sliding window, with the same params.

gemma3-1b and gemma2-27b at ``smoke()`` have a window of 16; a prompt of
12 and 14 generated tokens make 26 positions, so every local layer's ring
buffer (16 slots) wraps. The generated tokens must equal `repro`'s. A
greedy token can legitimately differ only where the reference's top-2
logit margin is within twice the two packages' logit difference at that
position (the largest over the vocabulary, on the reference's tokens;
held within 0.05 of the largest logit). Each of the 8 rows is compared up
to the first such position, and at least half of them must be compared
past the window. The port's own stepwise decode logits must equal its
full forward's within 0.05 of the largest logit at every position (the
rule of tests/models/test_decode.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch.serve import prefill_then_decode as jprefill_then_decode
from repro.models import lm as jlm
from repro.models.layers import logits_from_embedding as jlogits
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import logits_from_embedding

CPU = "cpu"
REL = 0.05
PROMPT, GEN, BATCH = 12, 14, 8


@pytest.fixture(scope="module", params=["gemma3_1b", "gemma2_27b"])
def case(request):
    arch = request.param
    jcfg = jconfigs.get_config(arch).smoke()
    cfg = get_config(arch).smoke()
    assert PROMPT + GEN > cfg.window
    jparams, _ = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                            device=CPU)
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    return jcfg, cfg, jparams, model, prompts


def full_logits(model, cfg, toks):
    with torch.no_grad():
        h, _, _ = lm.forward_hidden(model, cfg,
                                    torch.as_tensor(np.array(toks)))
        return logits_from_embedding(h, model.embed, cfg.logit_softcap)


def test_greedy_tokens_equal_jax_past_the_window(case):
    jcfg, cfg, jparams, model, prompts = case
    want = np.asarray(jprefill_then_decode(jparams, jcfg,
                                           jnp.asarray(prompts), GEN))
    got = serve.prefill_then_decode(model, cfg, prompts, GEN)
    assert got.dtype == torch.int32 and got.shape == (BATCH, PROMPT + GEN)
    np.testing.assert_array_equal(got[:, :PROMPT].numpy(), prompts)

    # the reference's logits on its own tokens, and the port's on the same
    jh, _, _ = jlm.forward_hidden(jparams, jcfg, tokens=jnp.asarray(want))
    ref = np.asarray(jlogits(jh, jparams["embed"], cap=jcfg.logit_softcap))
    ours = full_logits(model, cfg, want).numpy()
    eps = np.max(np.abs(ours - ref), axis=-1)       # [B, P+G]
    assert float(eps.max()) / float(np.max(np.abs(ref))) < REL
    top2 = np.sort(ref, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    past_window = 0
    for b in range(BATCH):
        # token t is chosen from the logits at t - 1
        close = [t for t in range(PROMPT, PROMPT + GEN)
                 if margin[b, t - 1] <= 2 * eps[b, t - 1]]
        upto = close[0] if close else PROMPT + GEN
        np.testing.assert_array_equal(got[b, :upto].numpy(), want[b, :upto])
        past_window += upto > cfg.window
    assert past_window >= BATCH // 2, past_window


def test_decode_logits_match_forward_past_the_window(case):
    _, cfg, _, model, prompts = case
    toks = serve.prefill_then_decode(model, cfg, prompts, GEN)
    full = full_logits(model, cfg, toks)
    scale = float(full.abs().max())
    T = toks.shape[1]
    states = lm.init_decode_states(cfg, BATCH, cache_len=T, device=CPU)
    local = [st["t"]["k"].shape[1] for st, blk in zip(states, model.blocks)
             if blk.kind == "l"]
    assert local and max(local) == cfg.window < T      # the rings wrap
    with torch.no_grad():
        for t in range(T):
            lg, states = lm.decode_step(model, cfg, toks[:, t:t + 1], states,
                                        t)
            err = float((lg[:, 0] - full[:, t]).abs().max())
            assert err / scale < REL, (t, err, scale)


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "rwkv6_1_6b",
                                  "kimi_k2_1t_a32b", "whisper_small"])
def test_decode_matches_prefill_beyond_attention(arch):
    cfg = get_config(arch).smoke()
    model = lm.lm_init(cfg, seed=0, device=CPU)
    Bd, S = 2, 10
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (Bd, S)))
    enc_out = None
    with torch.no_grad():
        if cfg.is_encdec:
            enc = 0.02 * rng.standard_normal((Bd, cfg.enc_seq, cfg.d_model))
            enc_out = lm.encode(model, cfg, torch.from_numpy(enc).float())
        h, _, _ = lm.forward_hidden(model, cfg, toks, enc_out=enc_out)
        full = logits_from_embedding(h, model.embed, cfg.logit_softcap)
        scale = float(full.abs().max())
        states = lm.init_decode_states(cfg, Bd, cache_len=S, device=CPU)
        for t in range(S):
            lg, states = lm.decode_step(model, cfg, toks[:, t:t + 1], states,
                                        t, enc_out=enc_out)
            err = float((lg[:, 0] - full[:, t]).abs().max())
            assert err / scale < REL, (arch, t, err, scale)


def test_sampling_is_seeded(case):
    _, cfg, _, model, prompts = case
    a = serve.prefill_then_decode(model, cfg, prompts, 6, temperature=1.0,
                                  seed=3)
    b = serve.prefill_then_decode(model, cfg, prompts, 6, temperature=1.0,
                                  seed=3)
    c = serve.prefill_then_decode(model, cfg, prompts, 6, temperature=1.0,
                                  seed=4)
    assert a.equal(b) and not a.equal(c)


def test_serve_cli_lm_branch(capsys):
    toks = serve.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "5", "--gen", "20"])
    assert toks.shape == (2, 25) and toks.device.type == "cpu"
    out = capsys.readouterr().out
    assert "generated 40 tokens" in out and "sample:" in out
    # the recurrent kinds serve too (item 2b is done)
    toks = serve.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "4", "--gen", "6"])
    assert toks.shape == (2, 10)
    assert "generated 12 tokens" in capsys.readouterr().out


def test_serve_cli_lm_branch_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "gemma3-1b", "--smoke", "--gen", "2"])
