"""Core layers: norms, activations, RoPE, embeddings, chunked cross-entropy.

The port of `repro.models.layers`, with its dtypes: activations in bf16
(`COMPUTE_DTYPE`), norms, RoPE angles and softmax statistics in float32.
A product that the JAX package takes of bf16 operands into a float32
result (``preferred_element_type=float32``) is taken here as a float32
product of the bf16-rounded operands: the operands' products are exact in
float32 and the sums are float32, as there. Float32 products run in full
float32 (PyTorch's default; TF32 stays off).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

COMPUTE_DTYPE = torch.bfloat16


def rms_norm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def softcap(x, cap: float | None):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def bf16_product_f32(equation: str, *operands):
    """`torch.einsum` of the operands rounded to bf16, summed in float32:
    the JAX package's bf16 einsum with ``preferred_element_type=float32``."""
    return torch.einsum(equation, *(t.to(COMPUTE_DTYPE).float()
                                    for t in operands))


def product_f32(equation: str, x, w):
    """The JAX package's ``einsum(x, w.astype(x.dtype),
    preferred_element_type=float32)``: `w` rounded to x's type, both
    operands' products summed in float32."""
    return torch.einsum(equation, x.float(), w.to(x.dtype).float())


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, base: float):
    return base ** (-np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)


def apply_rope(x, positions, base: float):
    """x [..., S, H, hd]; positions [..., S] integer. Rotates the two
    halves of each head (not interleaved pairs), with float32 angles."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, base)).to(x.device)   # [hd/2]
    angles = positions[..., None].float() * freqs         # [..., S, hd/2]
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Embedding / unembedding / loss
# --------------------------------------------------------------------------
def embed(tokens, table, scale_by_dim: bool = True):
    out = table[tokens]
    if scale_by_dim:
        # the scale is rounded to the rows' type, and the rows are scaled
        # before the cast to bf16
        out = out * torch.tensor(math.sqrt(table.shape[-1]), dtype=out.dtype,
                                 device=out.device)
    return out.to(COMPUTE_DTYPE)


def logits_from_embedding(x, table, cap: float | None = None):
    """x [..., S, d] (bf16) against the table rounded to x's type, into
    float32 logits [..., S, V]; then the softcap."""
    out = torch.matmul(x.float(), table.to(x.dtype).float().T)
    return softcap(out, cap)


def chunked_softmax_xent(x, table, targets, mask=None, *, chunk: int = 512,
                         cap: float | None = None):
    """Cross-entropy without materialising [B, S, V] for the full sequence.

    Loops over S in chunks; each chunk computes logits, log-sum-exp, and the
    target logit. Returns (mean_loss, total_weight)."""
    B, S, D = x.shape
    chunk = min(chunk, S)
    n_chunks = S // chunk
    rem = S - n_chunks * chunk
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    # the table rounded to x's type once for every chunk (the JAX package
    # rounds it in each chunk's product; the values are the same)
    table_c = table.to(x.dtype).float()

    def chunk_loss(xc, tc, mc):
        logits = softcap(torch.matmul(xc.float(), table_c.T), cap)
        lse = torch.logsumexp(logits, dim=-1)
        # the target logit from the float32 table ROWS, not from the
        # logits, with the softcap applied to it on its own
        tgt_emb = table[tc]                                 # [B, c, D]
        tgt = torch.einsum("bcd,bcd->bc", xc.float(), tgt_emb.float())
        tgt = softcap(tgt, cap)
        return torch.sum((lse - tgt) * mc), torch.sum(mc)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    wt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        l, w = chunk_loss(x[:, sl], targets[:, sl], mask[:, sl])
        tot, wt = tot + l, wt + w
    if rem:
        l, w = chunk_loss(x[:, -rem:], targets[:, -rem:], mask[:, -rem:])
        tot, wt = tot + l, wt + w
    return tot / torch.clamp(wt, min=1.0), wt


__all__ = ["COMPUTE_DTYPE", "activation", "apply_rope", "bf16_product_f32",
           "chunked_softmax_xent", "embed", "logits_from_embedding",
           "product_f32", "rms_norm", "rope_freqs", "softcap"]
