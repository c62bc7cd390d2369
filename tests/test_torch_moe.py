"""The port's MoE (`repro_torch.models.ffn`) and its BSP primitive
(`repro_torch.bsp.within_group_index`) held against the JAX package's on
the CPU, with the same params and inputs (numpy, from a seed).

* `within_group_index` on random groups and masks, m = 1, all-invalid,
  one group, an exchange hop's shape (2^18 over 9 ids), m = 0 and all ids
  distinct: equal element for element.
* The routing of `_moe_local` (``tp=1``): from the same float32 router
  logits, the expert ids, the arrival slots and their keep flags, the
  per-expert slots and theirs equal the reference's element for element
  (the reference's steps, `repro/models/ffn.py:98-135`, taken with its own
  `top_k` and `within_group_index`). The router logits themselves are a
  float32 product of bf16-rounded operands on both sides: within 1e-6 of
  the largest.
* `_moe_local`'s output within 0.05 of the reference's largest magnitude
  (bf16 expert products and outputs; the rule of
  tests/models/test_decode.py) and its aux loss within 1e-5 relative;
  `moe_layer` on [B, S, d] and the gradients of a loss of its output (each
  within 0.05 of the reference's largest); the reference's capacity-drop
  case (``capacity_factor=0.01``, all-ones input), where the second stage
  drops assignments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bsp.primitives import within_group_index as jwithin
from repro.models import ffn as jffn
from repro.models.config import ModelConfig as JModelConfig
from repro.models.sharding import ParamCollector
from repro_torch.bsp import within_group_index
from repro_torch.models import ffn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import product_f32

REL = 0.05
AUX_REL = 1e-5
LOGITS_REL = 1e-6


def rel_err(got, want) -> float:
    got = torch.as_tensor(got).detach().float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ----------------------------------------------------- within_group_index
def _groups(case):
    rng = np.random.default_rng(len(case))
    if case == "m=1":
        return np.array([3]), np.array([True])
    if case == "all-invalid":
        return rng.integers(0, 4, 37), np.zeros(37, bool)
    if case == "one group":
        return np.full(200, 5), rng.random(200) > 0.3
    if case == "negative ids":
        return rng.integers(-3, 3, 500), rng.random(500) > 0.2
    if case == "exchange hop":                 # p + 1 = 9 ids, 10% invalid
        return rng.integers(0, 9, 2 ** 18), rng.random(2 ** 18) > 0.1
    if case == "m=0":
        return np.zeros(0, np.int64), np.zeros(0, bool)
    if case == "all distinct":                 # every slot starts a run
        return rng.permutation(3000) - 1500, np.ones(3000, bool)
    return rng.integers(0, 16, 4096), rng.random(4096) > 0.1


@pytest.mark.parametrize("case", ["random", "m=1", "all-invalid",
                                  "one group", "negative ids",
                                  "exchange hop", "m=0", "all distinct"])
def test_within_group_index_equals_jax(case):
    group, valid = _groups(case)
    want = np.asarray(jwithin(jnp.asarray(group, jnp.int32),
                              jnp.asarray(valid)))
    got = within_group_index(torch.from_numpy(group),
                             torch.from_numpy(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------------------- MoE
def moe_cfgs(**kw):
    base = dict(name="m", family="moe", n_layers=2, d_model=16, n_heads=2,
                n_kv_heads=2, d_ff=32, vocab_size=64, n_experts=4, top_k=2)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def moe_params(jcfg, cfg, seed=0):
    col = ParamCollector(jax.random.PRNGKey(seed))
    jffn.init_moe(col, "moe", jcfg)
    jp = col.params["moe"]
    mod = ffn.MoE(cfg, device="cpu")
    with torch.no_grad():
        for name, p in mod.named_parameters():
            p.copy_(torch.from_numpy(np.array(jp[name])))
    return jp, mod


def jax_routing(logits, jcfg):
    """The reference's routing steps (`repro/models/ffn.py:98-135`,
    tp = 1) from router logits."""
    T = logits.shape[0]
    E, k = jcfg.n_experts, jcfg.top_k
    probs = jax.nn.softmax(logits, axis=-1)
    gate, ids = jax.lax.top_k(probs, k)
    ids_f = ids.reshape(-1)
    owner = ids_f // E
    valid = jnp.ones_like(ids_f, dtype=bool)
    cap = int(jcfg.capacity_factor * T * k / 1) + 8
    slot = jwithin(owner, valid)
    keep = slot < cap
    meta = jnp.full((1, cap, 1), -1, jnp.int32)
    ow = jnp.where(keep, owner, 1)
    meta = meta.at[ow, slot, 0].set(ids_f % E, mode="drop")
    eid = meta.reshape(cap)
    ev = eid >= 0
    cap_e = int(jcfg.capacity_factor * T * k * 1 / E) + 8
    eslot = jwithin(eid, ev)
    ekeep = ev & (eslot < cap_e)
    return {"ids": ids, "slot": slot, "keep": keep, "eid": eid,
            "eslot": eslot, "ekeep": ekeep}, (cap, cap_e)


def tokens(T, d, seed, *, ones=False):
    if ones:
        return np.ones((T, d), np.float32)
    return np.random.default_rng(seed).normal(size=(T, d)).astype(
        np.float32)


CASES = {"random": dict(T=48, kw={}),
         "capacity drop": dict(T=64, kw=dict(capacity_factor=0.01),
                               ones=True),
         "top-8 of 16": dict(T=40, kw=dict(n_experts=16, top_k=8))}


@pytest.mark.parametrize("name", list(CASES))
def test_routing_equals_jax(name):
    case = CASES[name]
    jcfg, cfg = moe_cfgs(**case["kw"])
    jp, mod = moe_params(jcfg, cfg)
    x = tokens(case["T"], cfg.d_model, 1, ones=case.get("ones", False))
    xb = jnp.asarray(x, jnp.bfloat16)
    jlogits = jnp.einsum("td,de->te", xb, jp["router"].astype(xb.dtype),
                         preferred_element_type=jnp.float32)
    logits = product_f32("td,de->te",
                         torch.from_numpy(x).to(torch.bfloat16), mod.router)
    assert rel_err(logits, jlogits) < LOGITS_REL
    want, caps = jax.jit(jax_routing, static_argnums=1)(jlogits, jcfg)
    rt = ffn.moe_route(torch.from_numpy(np.array(jlogits)), cfg)
    assert (rt.cap, rt.cap_e) == caps
    for key in ("ids", "slot", "keep", "eid", "eslot", "ekeep"):
        np.testing.assert_array_equal(getattr(rt, key).numpy(),
                                      np.asarray(want[key]), key)
    if name == "capacity drop":
        # every token routes alike: the experts' slots overflow
        assert int(rt.ekeep.sum()) < case["T"] * cfg.top_k


@pytest.mark.parametrize("name", list(CASES))
def test_moe_local_matches_jax(name):
    case = CASES[name]
    jcfg, cfg = moe_cfgs(**case["kw"])
    jp, mod = moe_params(jcfg, cfg)
    x = tokens(case["T"], cfg.d_model, 2, ones=case.get("ones", False))
    xb = jnp.asarray(x, jnp.bfloat16)
    want, jaux = jax.jit(lambda xb, p: jffn._moe_local(
        xb, p["router"], p["wg"], p["wu"], p["wd"], cfg=jcfg, tp=1,
        axis=None))(xb, jp)
    with torch.no_grad():
        got, aux = ffn._moe_local(torch.from_numpy(x).to(torch.bfloat16),
                                  mod.router, mod.wg, mod.wu, mod.wd,
                                  cfg=cfg)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert bool(torch.isfinite(got.float()).all())
    assert rel_err(got, want) < REL
    assert abs(float(aux) / float(jaux) - 1) < AUX_REL


def test_moe_layer_and_its_gradients_match_jax():
    jcfg, cfg = moe_cfgs(n_experts=8, top_k=2, capacity_factor=1.0)
    jp, mod = moe_params(jcfg, cfg, seed=3)
    x = np.random.default_rng(4).normal(size=(2, 24, cfg.d_model)).astype(
        np.float32)

    def jloss(p):
        out, aux = jffn.moe_layer(p, jcfg, jnp.asarray(x, jnp.bfloat16))
        return jnp.sum(jnp.square(out.astype(jnp.float32))) + aux, out

    (jl, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jp)
    out, aux = ffn.moe_layer(mod, cfg, torch.from_numpy(x).to(torch.bfloat16))
    loss = torch.sum(torch.square(out.float())) + aux
    loss.backward()
    assert out.shape == (2, 24, cfg.d_model)
    assert rel_err(out, jout) < REL
    assert abs(float(loss.detach()) / float(jl) - 1) < REL
    for name, p in mod.named_parameters():
        assert rel_err(p.grad, jgrads[name]) < REL, name
