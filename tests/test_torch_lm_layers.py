"""The port's LM layers (`repro_torch.models.layers`, `.attention`) held
against the JAX package's (`repro.models.layers`, `.attention`) on the same
numpy inputs, on the CPU.

Attention: `flash_attention` on the cases of
tests/models/test_components.py (causal and not, windowed, softcapped,
GQA, S not a multiple of the chunk) and on windows wide enough apart from
the chunk to take the banded path; `decode_attention` with `update_cache`
decoding past the ring buffer's capacity. Layers: RoPE, `rms_norm`, the
tanh GELU, `embed`, `logits_from_embedding` and `chunked_softmax_xent`
with a remainder chunk, a mask and a softcap.

Tolerances, relative to the largest magnitude of the reference's output:
1e-5 where both sides compute the same float32 arithmetic (RoPE, the f32
norms, the loss); 1e-2 where a float32 value is rounded to bf16 on the way
(attention probabilities before the PV product, bf16 outputs), which is
one bf16 rounding step (2^-8) and well inside the 0.05 rule of
tests/models/test_decode.py.
"""
import math

import jax  # noqa: F401  -- both packages in one process, JAX on the CPU
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
import repro.models.layers as jlayers
from repro_torch.models import attention, layers

BF16_REL = 1e-2
F32_REL = 1e-5


def rel_err(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).float().detach().numpy(),
                     np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _qkv(seed, B, S, H, Hk, hd, T=None):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, T, Hk, hd)).astype(np.float32),
            rng.normal(size=(B, T, Hk, hd)).astype(np.float32))


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("S,H,Hk,causal,window,cap,chunk", [
    (64, 4, 2, True, None, None, 32),       # test_components' cases
    (64, 4, 4, True, 9, None, 32),
    (100, 4, 1, True, 16, 50.0, 32),        # banded, ragged, softcap, MQA
    (48, 2, 2, False, None, None, 32),
    (80, 4, 2, True, 20, None, 16),         # banded: back 3 of 5 chunks
    (37, 4, 2, True, None, 30.0, 16),       # ragged S, global, softcap
    (70, 2, 1, False, 24, None, 16),        # windowed, not causal, banded
])
def test_flash_attention_matches_jax(S, H, Hk, causal, window, cap, chunk):
    q, k, v = _qkv(S + H, 2, S, H, Hk, 16)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 window=window, attn_softcap=cap,
                                 q_chunk=chunk, kv_chunk=chunk)
    got = attention.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal,
                                    window=window, attn_softcap=cap,
                                    q_chunk=chunk, kv_chunk=chunk)
    assert got.dtype == torch.float32
    assert rel_err(got, want) < BF16_REL


def test_flash_attention_bf16_inputs_match_jax():
    q, k, v = _qkv(5, 2, 96, 4, 2, 32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    want = jattn.flash_attention(jq, jk, jv, window=20, q_chunk=16,
                                 kv_chunk=16)
    got = attention.flash_attention(tq, tk, tv, window=20, q_chunk=16,
                                    kv_chunk=16)
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) < BF16_REL


@pytest.mark.parametrize("window,cap", [(8, None), (None, 50.0), (5, 30.0)])
def test_decode_attention_ring_buffer_past_window_matches_jax(window, cap):
    rng = np.random.default_rng(1)
    B, C, Hk, H, hd, T = 2, 8, 2, 4, 8, 21        # decode past capacity C
    ks = rng.normal(size=(B, T, Hk, hd)).astype(np.float32)
    vs = rng.normal(size=(B, T, Hk, hd)).astype(np.float32)
    qs = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    jck = jcv = jnp.zeros((B, C, Hk, hd))
    ck, cv = torch.zeros(B, C, Hk, hd), torch.zeros(B, C, Hk, hd)
    for t in range(T):
        jck, jcv = jattn.update_cache(jck, jcv, jnp.asarray(ks[:, t:t + 1]),
                                      jnp.asarray(vs[:, t:t + 1]), t)
        ck2, cv2 = attention.update_cache(
            ck, cv, torch.from_numpy(ks[:, t:t + 1]),
            torch.from_numpy(vs[:, t:t + 1]), t)
        assert ck2 is ck and cv2 is cv              # written in place
        np.testing.assert_array_equal(ck.numpy(), np.asarray(jck))
        want = jattn.decode_attention(jnp.asarray(qs[:, t:t + 1]), jck, jcv,
                                      t, window=window, attn_softcap=cap)
        got = attention.decode_attention(torch.from_numpy(qs[:, t:t + 1]),
                                         ck, cv, t, window=window,
                                         attn_softcap=cap)
        assert rel_err(got, want) < BF16_REL, t


# ------------------------------------------------------------------ layers
def test_rope_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 12, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(12), np.arange(100, 112)]).astype(np.int32)
    for base in (10_000.0, 1_000_000.0):
        want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), base)
        got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                base)
        assert rel_err(got, want) < F32_REL
        # bf16 in, bf16 out: the float32 rotation rounded once
        want = jlayers.apply_rope(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(pos), base)
        got = layers.apply_rope(torch.from_numpy(x).to(torch.bfloat16),
                                torch.from_numpy(pos), base)
        assert got.dtype == torch.bfloat16
        assert rel_err(got, want) < BF16_REL
    np.testing.assert_array_equal(layers.rope_freqs(16, 10_000.0),
                                  jlayers.rope_freqs(16, 10_000.0))


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = (3.0 * rng.normal(size=(2, 5, 64))).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    assert rel_err(got, want) < F32_REL
    want = jlayers.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale))
    got = layers.rms_norm(torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) < BF16_REL


@pytest.mark.parametrize("name", ["gelu", "silu", "relu"])
def test_activation_matches_jax(name):
    x = np.linspace(-3, 3, 601).astype(np.float32)
    want = jlayers.activation(name)(jnp.asarray(x))
    got = layers.activation(name)(torch.from_numpy(x))
    assert rel_err(got, want) < F32_REL
    if name == "gelu":
        # the tanh approximation, not the exact erf GELU
        exact = torch.nn.functional.gelu(torch.from_numpy(x))
        assert rel_err(exact, want) > 10 * F32_REL


def test_softcap_matches_jax():
    x = np.linspace(-1000, 1000, 101).astype(np.float32)
    assert rel_err(layers.softcap(torch.from_numpy(x), 30.0),
                   jlayers.softcap(jnp.asarray(x), 30.0)) < F32_REL
    assert layers.softcap(torch.from_numpy(x), None).equal(
        torch.from_numpy(x))


def test_embed_and_logits_match_jax():
    rng = np.random.default_rng(4)
    table = (0.3 * rng.normal(size=(50, 24))).astype(np.float32)
    toks = rng.integers(0, 50, (2, 7)).astype(np.int32)
    jx = jlayers.embed(jnp.asarray(toks), jnp.asarray(table))
    x = layers.embed(torch.from_numpy(toks), torch.from_numpy(table))
    assert x.dtype == torch.bfloat16
    np.testing.assert_array_equal(x.float().numpy(),
                                  np.asarray(jx.astype(jnp.float32)))
    for cap in (None, 5.0):
        want = jlayers.logits_from_embedding(jx, jnp.asarray(table), cap)
        got = layers.logits_from_embedding(x, torch.from_numpy(table), cap)
        assert got.dtype == torch.float32
        assert rel_err(got, want) < F32_REL


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_softmax_xent_matches_jax(cap, masked):
    rng = np.random.default_rng(5)
    B, S, D, V = 2, 20, 16, 40                      # chunk 8: a rem of 4
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    table = (0.5 * rng.normal(size=(V, D))).astype(np.float32)
    tgt = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.3).astype(np.float32) if masked else None
    jx = jnp.asarray(x, jnp.bfloat16)
    want, wwt = jlayers.chunked_softmax_xent(
        jx, jnp.asarray(table), jnp.asarray(tgt),
        None if mask is None else jnp.asarray(mask), chunk=8, cap=cap)
    got, wt = layers.chunked_softmax_xent(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(table),
        torch.from_numpy(tgt),
        None if mask is None else torch.from_numpy(mask), chunk=8, cap=cap)
    assert float(wt) == float(wwt) == (mask.sum() if masked else B * S)
    assert math.isclose(float(got), float(want), rel_tol=F32_REL)
