"""The port's recurrent layers (`repro_torch.models.rglru`,
`repro_torch.models.rwkv6`) held against the JAX package's on the CPU,
with the same params (the reference's `ParamCollector` draws) and inputs
(numpy, from a seed).

* `rglru_layer`, `rwkv_time_mix` and `rwkv_channel_mix` over a whole
  sequence and step by step through their decode states: outputs within
  0.05 of the reference's largest magnitude (bf16 projections and
  outputs; the rule of tests/models/test_decode.py), the carried states
  within 1e-2 of theirs: float32 recurrences fed by bf16 projections and
  a bf16 convolution, which the reference's compiler may fuse without
  rounding in between (one bf16 step is 2^-8 = 3.9e-3).
* The gradients of a loss of each layer's output, within 0.05 of the
  reference's largest.
* The reference's own scan-against-stepwise checks
  (tests/models/test_components.py:130-168) repeated on the port, with
  their bound (3e-2 absolute).
* `linear_scan` (the log-depth form of the RG-LRU recurrence) against
  the sequential recurrence in float32, 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv
from repro.models.config import ModelConfig as JModelConfig
from repro.models.sharding import ParamCollector
from repro_torch.models import rglru, rwkv6
from repro_torch.models.config import ModelConfig

CPU = "cpu"
REL = 0.05
STATE_REL = 1e-2
STEP_ABS = 3e-2
F32_REL = 1e-6


def rel_err(got, want) -> float:
    got = torch.as_tensor(got).detach().float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def cfgs(kind):
    if kind == "r":
        kw = dict(name="g", family="hybrid", n_layers=2, d_model=16,
                  n_heads=2, n_kv_heads=1, d_ff=32, vocab_size=64,
                  lru_dim=24, conv_width=4)
    else:
        kw = dict(name="w", family="ssm", n_layers=2, d_model=16, n_heads=2,
                  n_kv_heads=2, head_dim=8, d_ff=32, vocab_size=64)
    return JModelConfig(**kw), ModelConfig(**kw)


#: (reference init, reference layer, port module, port layer)
LAYERS = {
    "rglru": (jrglru.init_rglru, jrglru.rglru_layer, rglru.RGLRU,
              rglru.rglru_layer, "r"),
    "time_mix": (jrwkv.init_rwkv_time_mix, jrwkv.rwkv_time_mix,
                 rwkv6.TimeMix, rwkv6.rwkv_time_mix, "w"),
    "channel_mix": (jrwkv.init_rwkv_channel_mix, jrwkv.rwkv_channel_mix,
                    rwkv6.ChannelMix, rwkv6.rwkv_channel_mix, "w"),
}


def layer_pair(name, seed=2):
    jinit, jfn, Mod, fn, kind = LAYERS[name]
    jcfg, cfg = cfgs(kind)
    col = ParamCollector(jax.random.PRNGKey(seed))
    jinit(col, "p", jcfg)
    jp = col.params["p"]
    mod = Mod(cfg, device=CPU)
    with torch.no_grad():
        for pname, p in mod.named_parameters():
            p.copy_(torch.from_numpy(np.array(jp[pname])))
        # the reference's zero-init mixes and decay base make the token
        # shift and w0 vanish; give them values so both paths are used
        rng = np.random.default_rng(seed)
        for pname, p in mod.named_parameters():
            if pname.startswith("mu_") or pname in ("w0", "ln_x"):
                val = (0.3 * rng.standard_normal(p.shape)).astype(np.float32)
                jp[pname] = jnp.asarray(val)
                p.copy_(torch.from_numpy(val))
    return jcfg, cfg, jp, mod, jfn, fn


def initial_state(name, cfg, jcfg, B):
    if name == "rglru":
        return (jrglru.init_rglru_state(jcfg, B),
                rglru.init_rglru_state(cfg, B, device=CPU))
    key = "tm" if name == "time_mix" else "cm"
    return (jrwkv.init_rwkv_state(jcfg, B)[key],
            rwkv6.init_rwkv_state(cfg, B, device=CPU)[key])


def inputs(cfg, B=2, S=11, seed=0):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)


@pytest.mark.parametrize("name", list(LAYERS))
def test_full_sequence_and_state_match_jax(name):
    jcfg, cfg, jp, mod, jfn, fn = layer_pair(name)
    x = inputs(cfg)
    want, jstate = jax.jit(lambda p, x: jfn(p, jcfg, x))(
        jp, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got, state = fn(mod, cfg, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) < REL
    for key, val in state.items():
        assert val.dtype == getattr(torch, str(jstate[key].dtype))
        assert rel_err(val, jstate[key]) < STATE_REL, key


@pytest.mark.parametrize("name", list(LAYERS))
def test_stepwise_decode_matches_jax(name):
    jcfg, cfg, jp, mod, jfn, fn = layer_pair(name)
    x = inputs(cfg, S=7, seed=1)
    jst, st = initial_state(name, cfg, jcfg, x.shape[0])
    jstep = jax.jit(lambda p, x, s: jfn(p, jcfg, x, state=s))
    for t in range(x.shape[1]):
        xt = x[:, t:t + 1]
        want, jst = jstep(jp, jnp.asarray(xt, jnp.bfloat16), jst)
        with torch.no_grad():
            got, st = fn(mod, cfg, torch.from_numpy(xt).to(torch.bfloat16),
                         state=st)
        assert rel_err(got, want) < REL, t
    for key in st:
        assert rel_err(st[key], jst[key]) < STATE_REL, key


@pytest.mark.parametrize("name", list(LAYERS))
def test_gradients_match_jax(name):
    jcfg, cfg, jp, mod, jfn, fn = layer_pair(name, seed=5)
    x = inputs(cfg, seed=6)

    def jloss(p):
        out, _ = jfn(p, jcfg, jnp.asarray(x, jnp.bfloat16))
        return jnp.sum(jnp.square(out.astype(jnp.float32)))

    jgrads = jax.jit(jax.grad(jloss))(jp)
    out, _ = fn(mod, cfg, torch.from_numpy(x).to(torch.bfloat16))
    torch.sum(torch.square(out.float())).backward()
    for pname, p in mod.named_parameters():
        assert rel_err(p.grad, jgrads[pname]) < REL, pname


def test_rglru_scan_matches_stepwise():
    """tests/models/test_components.py::test_rglru_scan_matches_stepwise
    on the port."""
    _, cfg = cfgs("r")
    cfg = cfg.replace(lru_dim=16)
    p = rglru.RGLRU(cfg, device=CPU)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for pname, t in p.named_parameters():
            t.copy_(torch.ones_like(t) if pname == "lam"
                    else 0.02 * torch.randn(t.shape, generator=gen))
    x = torch.from_numpy(0.3 * np.random.default_rng(0).normal(
        size=(1, 10, 16)).astype(np.float32))
    with torch.no_grad():
        full, _ = rglru.rglru_layer(p, cfg, x)
        st = rglru.init_rglru_state(cfg, 1, device=CPU)
        outs = []
        for t in range(10):
            o, st = rglru.rglru_layer(p, cfg, x[:, t:t + 1], state=st)
            outs.append(o)
    step = torch.cat(outs, dim=1)
    assert float((full.float() - step.float()).abs().max()) < STEP_ABS


def test_rwkv_scan_matches_stepwise():
    """tests/models/test_components.py::test_rwkv_scan_matches_stepwise
    on the port."""
    _, cfg = cfgs("w")
    p = rwkv6.TimeMix(cfg, device=CPU)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for pname, t in p.named_parameters():
            init, scale = t.init_rule
            t.copy_(torch.zeros_like(t) if init == "zeros"
                    else scale * torch.randn(t.shape, generator=gen))
    x = torch.from_numpy(0.3 * np.random.default_rng(1).normal(
        size=(1, 8, 16)).astype(np.float32))
    with torch.no_grad():
        full, _ = rwkv6.rwkv_time_mix(p, cfg, x)
        st = rwkv6.init_rwkv_state(cfg, 1, device=CPU)["tm"]
        outs = []
        for t in range(8):
            o, st = rwkv6.rwkv_time_mix(p, cfg, x[:, t:t + 1], state=st)
            outs.append(o)
    step = torch.cat(outs, dim=1)
    assert float((full.float() - step.float()).abs().max()) < STEP_ABS


@pytest.mark.parametrize("S", [1, 2, 7, 64, 100])
def test_linear_scan_equals_the_recurrence(S):
    rng = np.random.default_rng(S)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (3, S, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, S, 5)).astype(np.float32))
    want = torch.empty_like(b)
    h = torch.zeros_like(b[:, 0])
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    got = rglru.linear_scan(a, b)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= F32_REL * scale
