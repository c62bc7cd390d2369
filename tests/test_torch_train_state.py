"""The port's train state (`repro_torch.train.train_step`, `repro_torch.
models.convert`, `repro_torch.ckpt`) held against the JAX package's
(`repro.train.train_step`, `repro.ckpt`) on the CPU.

* Layout: `state_tree` of every config at ``smoke()``, for AdamW,
  Adafactor, SGD+momentum and AdamW with int8 error feedback, has the
  flatten order, paths, shapes and dtypes of ``jax.eval_shape`` of the
  reference's ``make_train_state(lm_init(...))`` (exact).
* The conversion round trip: `train_state_to_jax` then
  `load_train_state_from_jax` is bit-exact (gemma3 with a tail, whisper's
  encoder stack, kimi-k2's bf16 embedding and Adafactor).
* Adafactor over the stacked leaves: 4 steps of the port against 4 of the
  reference's jitted `train_step`. With the model's loss, each step's loss
  within 1e-2 and the params within 2.1·lr (the rule of
  tests/test_torch_train.py); with a linear loss, whose gradient is the
  same seeded tree in both packages, and no clipping, the params within
  2.1·lr, every optimizer leaf within 1e-6 of its largest magnitude and
  every error-feedback residual within 1e-6 of its gradient's (float32;
  the reference fuses ``g − q·s`` into one multiply-add). The int8 error
  feedback takes one scale per stacked leaf there too.
* bf16 checkpoints: the port writes the reference's on-disk form byte for
  byte (``|V2`` arrays, manifest ``"bfloat16"``) and restores it
  bit-exact, also in a process where ``ml_dtypes`` cannot be imported.

The launchers' resume across packages is tests/test_torch_train_resume.py.

Inputs come from numpy seeds; the reference's params come from its
`lm_init` and reach the port through `params_from_jax`.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.ckpt.checkpoint as jckpt
import repro.configs as jconfigs
import repro.train.optim as joptim
import repro.train.train_step as jtrain
from repro.models import lm as jlm
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config, model_archs
from repro_torch.models import lm
from repro_torch.models.convert import (load_train_state_from_jax,
                                        param_groups, params_from_jax,
                                        params_to_jax, train_state_to_jax)
from repro_torch.train import optim
from repro_torch.train import train_step as train_step_mod
from repro_torch.train.train_step import (TrainConfig, load_state_tree,
                                          make_train_state, make_train_step,
                                          state_tree)

CPU = "cpu"
REPO = Path(__file__).resolve().parent.parent
LOSS_ABS = 1e-2
F32_REL = 1e-6
LR = 1e-3
OPTS = [("adamw", False), ("adafactor", False), ("sgdm", False),
        ("adamw", True)]


def _bits(a) -> np.ndarray:
    """A leaf as comparable bits (bf16 as uint16)."""
    a = np.asarray(a)
    if a.dtype == ckpt.BF16_BITS or a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16)
    return a


def _state_tensors(state) -> dict:
    """Every tensor of a port state by a name: params, optimizer, errors."""
    out = {f"params.{n}": p.detach()
           for n, p in state["params"].named_parameters()}
    stack = [("opt", state["opt"])] + \
        ([("ef_error", state["ef_error"])] if "ef_error" in state else [])
    while stack:
        prefix, node = stack.pop()
        for k, v in node.items():
            if isinstance(v, dict):
                stack.append((f"{prefix}.{k}", v))
            else:
                out[f"{prefix}.{k}"] = v
    return out


def _randomize(state, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in sorted(_state_tensors(state).items()):
            if t.dim() == 0:
                t.fill_(int(rng.integers(1, 100)))
            else:
                vals = np.abs(rng.standard_normal(tuple(t.shape)))
                t.copy_(torch.from_numpy(vals.astype(np.float32)))


# ------------------------------------------------------------------ layout
def _ref_layouts(arch):
    """{(optimizer, compress): the reference's (path, shape, dtype) list}
    of `arch` at smoke, from one abstract `lm_init`."""
    jcfg = jconfigs.get_config(arch).smoke()
    params = jax.eval_shape(
        lambda: jlm.lm_init(jax.random.PRNGKey(0), jcfg)[0])
    out = {}
    for opt, compress in OPTS:
        jtcfg = jtrain.TrainConfig(opt=joptim.OptConfig(name=opt,
                                                        compress=compress))
        st = jax.eval_shape(
            lambda p, t=jtcfg: jtrain.make_train_state(p, t), params)
        out[opt, compress] = [
            (str(p), tuple(leaf.shape), str(leaf.dtype))
            for p, leaf in jax.tree_util.tree_flatten_with_path(st)[0]]
    return out


@pytest.mark.parametrize("arch", model_archs())
def test_state_tree_has_the_reference_layout(arch):
    cfg = get_config(arch).smoke()
    model = lm.lm_init(cfg, seed=0, device=CPU)
    want = _ref_layouts(arch)
    for opt, compress in OPTS:
        tcfg = TrainConfig(opt=optim.OptConfig(name=opt, compress=compress))
        tree = state_tree(make_train_state(model, tcfg))
        ours = [(ckpt._path_str(p), tuple(leaf.shape),
                 ckpt.dtype_name(leaf.dtype))
                for p, leaf in ckpt._flatten(tree)]
        assert ours == want[opt, compress], (opt, compress)


# -------------------------------------------------------------- round trip
@pytest.mark.parametrize("arch,n_layers,opt,compress", [
    ("gemma3_1b", 14, "adamw", True),     # 2 periods of 6 and a tail of 2
    ("whisper_small", None, "sgdm", False),
    ("kimi_k2_1t_a32b", None, "adafactor", True)])
def test_train_state_round_trip_is_bit_exact(arch, n_layers, opt, compress):
    cfg = get_config(arch).smoke()
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    tcfg = TrainConfig(opt=optim.OptConfig(name=opt, compress=compress))
    a = make_train_state(lm.lm_init(cfg, seed=1, device=CPU), tcfg)
    _randomize(a, 1)
    tree = train_state_to_jax(a)
    b = make_train_state(lm.lm_init(cfg, seed=2, device=CPU), tcfg)
    assert load_train_state_from_jax(b, tree) is b
    got, want = _state_tensors(b), _state_tensors(a)
    assert set(got) == set(want)
    for name, t in want.items():
        assert t.dtype == got[name].dtype and t.equal(got[name]), name
    # the layout: a pattern position's layers stacked, the tail apart
    groups = param_groups(a["params"])
    params = dict(a["params"].named_parameters())
    flat = dict((ckpt._path_str(p), leaf)
                for p, leaf in ckpt._flatten(tree["params"]))
    for ref, (names, stacked) in groups.items():
        leaf = flat[ckpt._path_str(tuple(f"DictKey(key={k!r})"
                                         for k in ref.split(".")))]
        for p, name in enumerate(names):
            want_bits = _bits(ckpt.to_host(params[name]))
            np.testing.assert_array_equal(
                _bits(leaf)[p] if stacked else _bits(leaf), want_bits)
    if n_layers:
        assert groups["blocks.l0.norm1"] == (["blocks.0.norm1",
                                              "blocks.6.norm1"], True)
        assert groups["tail.l1.norm1"] == (["blocks.13.norm1"], False)
    if cfg.is_encdec:
        assert tree["params"]["enc"]["l0"]["norm1"].shape == \
            (cfg.encoder_layers, cfg.d_model)
    if opt == "adafactor":                  # a 1-D layer leaf, factored
        f = tree["opt"]["f"]["blocks"]["l0"]["norm1"]
        assert f["vr"].shape == (cfg.n_layers,) and \
            f["vc"].shape == (cfg.d_model,)
        assert tree["params"]["embed"].dtype == ckpt.BF16_BITS


# ----------------------------------------------------- Adafactor updates
def _batches(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab_size, (2, 17)).astype(
        np.int32)} for _ in range(n)]


def _pair(arch):
    jcfg = jconfigs.get_config(arch).smoke()
    cfg = get_config(arch).smoke()
    jparams, _ = jlm.lm_init(jax.random.PRNGKey(4), jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, cfg, jparams, params_from_jax(params_np, cfg, device=CPU)


def _run_both(arch, opt, compress, steps=4, clip_norm=1.0):
    jcfg, cfg, jparams, model = _pair(arch)
    kw = dict(warmup=0, total_steps=10)
    okw = dict(name=opt, lr=LR, compress=compress, clip_norm=clip_norm)
    jtcfg = jtrain.TrainConfig(opt=joptim.OptConfig(**okw), **kw)
    tcfg = TrainConfig(opt=optim.OptConfig(**okw), **kw)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtcfg))
    jstate = jtrain.make_train_state(jparams, jtcfg)
    step = make_train_step(cfg, tcfg)
    state = make_train_state(model, tcfg)
    losses = []
    for batch in _batches(cfg, steps, 5):
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                          batch))
        state, m = step(state, batch)
        losses.append((float(m["loss"]), float(jm["loss"])))
    return state, jstate, losses


def _params_within(state, jstate, tol):
    ours = params_to_jax(state["params"])
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(ours)[0],
                            jax.tree_util.tree_leaves(jstate["params"])):
        diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        assert float(np.max(diff)) <= tol, path


@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "minicpm_2b"])
def test_adafactor_steps_match_jax(arch):
    state, jstate, losses = _run_both(arch, "adafactor", False)
    for ours, theirs in losses:
        assert abs(ours - theirs) < LOSS_ABS, losses
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 4
    _params_within(state, jstate, 2.1 * LR)


def _linear_loss_patches(jparams, model, seed):
    """Both packages' `lm_loss` replaced by ``Σ <p, G>`` over one seeded
    tree G (in each parameter's dtype), so both steps see the same
    gradients."""
    rng = np.random.default_rng(seed)
    g_np = jax.tree_util.tree_map(
        lambda p: (0.05 * rng.standard_normal(p.shape)).astype(p.dtype),
        jax.tree_util.tree_map(np.asarray, jparams))
    g_port = params_from_jax(g_np, model.cfg, device=CPU)
    g_named = {n: p.detach() for n, p in g_port.named_parameters()}
    g_leaves = [jnp.asarray(g) for g in jax.tree_util.tree_leaves(g_np)]

    def jloss(params, cfg, batch, mesh=None):
        loss = sum(jnp.vdot(p.astype(jnp.float32), g.astype(jnp.float32))
                   for p, g in zip(jax.tree_util.tree_leaves(params),
                                   g_leaves))
        return loss, {"xent": loss}

    def tloss(params, cfg, batch):
        loss = sum(torch.sum(p.float() * g_named[n].float())
                   for n, p in params.named_parameters())
        return loss, {"xent": loss.detach()}
    return (mock.patch.object(jtrain, "lm_loss", jloss),
            mock.patch.object(train_step_mod, "lm_loss", tloss)), g_np


@pytest.mark.parametrize("arch,opt,compress", [
    ("kimi_k2_1t_a32b", "adafactor", False),
    ("minicpm_2b", "adafactor", True),
    ("minicpm_2b", "adamw", True)])
def test_stacked_updates_match_jax_on_the_same_gradients(arch, opt,
                                                         compress):
    _, _, jparams, model = _pair(arch)
    (jpatch, tpatch), g_np = _linear_loss_patches(jparams, model, 6)
    with jpatch, tpatch:
        # no clipping: the scale is exactly 1 in both, so the int8
        # rounding sees the same values
        state, jstate, _ = _run_both(arch, opt, compress, clip_norm=1e9)
    _params_within(state, jstate, 2.1 * LR)
    ours = state_tree(state)
    grads = jax.tree_util.tree_leaves(g_np)
    parts = ["opt"] + (["ef_error"] if compress else [])
    for part in parts:
        got = jax.tree_util.tree_flatten_with_path(ours[part])[0]
        want = jax.tree_util.tree_flatten_with_path(jstate[part])[0]
        assert [p for p, _ in got] == [p for p, _ in want]
        for i, ((path, a), (_, b)) in enumerate(zip(got, want)):
            a = np.asarray(a, np.float64)
            b = np.asarray(b, np.float64)
            assert a.shape == b.shape, path
            # a residual g - q·s is held to the gradient's magnitude: the
            # reference's XLA computes it as one fused multiply-add
            ref = grads[i] if part == "ef_error" else b
            scale = max(float(np.max(np.abs(np.asarray(ref, np.float64)))),
                        1e-30)
            assert float(np.max(np.abs(a - b))) <= F32_REL * scale, path


# ----------------------------------------------------------- bf16 on disk
def _kimi_state(seed):
    cfg = get_config("kimi_k2_1t_a32b").smoke()
    tcfg = TrainConfig(opt=optim.OptConfig(name="adafactor"))
    state = make_train_state(lm.lm_init(cfg, seed=seed, device=CPU), tcfg)
    _randomize(state, seed)
    return state


def test_bf16_checkpoint_is_the_references_on_disk_form(tmp_path):
    a = _kimi_state(1)
    tree = state_tree(a)
    ckpt.save_checkpoint(str(tmp_path / "port"), 3, tree)
    jtree = jax.tree_util.tree_map(
        lambda x: x.view(ml_dtypes.bfloat16) if x.dtype == ckpt.BF16_BITS
        else x, tree)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 3, jtree)
    manifests, arrays = [], []
    for side in ("port", "ref"):
        d = tmp_path / side / "step_00000003"
        manifests.append(__import__("json").loads(
            (d / "manifest.json").read_text()))
        with np.load(d / "arrays.npz") as data:
            arrays.append({k: (data[k].dtype.str, data[k].tobytes())
                           for k in data.files})
    for key in ("paths", "shapes", "dtypes", "step"):
        assert manifests[0][key] == manifests[1][key], key
    assert arrays[0] == arrays[1]
    i = manifests[0]["paths"].index(
        "(DictKey(key='params'), DictKey(key='embed'))")
    assert manifests[0]["dtypes"][i] == "bfloat16"
    assert arrays[0][str(i)][0] == "|V2"
    # the port restores it bit-exact
    b = _kimi_state(2)
    restored, _ = ckpt.restore_checkpoint(str(tmp_path / "ref"), 3,
                                          state_tree(b))
    load_state_tree(b, restored)
    for name, t in _state_tensors(a).items():
        assert t.equal(_state_tensors(b)[name]), name


def test_bf16_leaf_checks_stay_strict(tmp_path):
    """A ``|V2`` array is bf16 only where the manifest says so and the
    like-tree holds bf16; every other dtype keeps the strict check."""
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.ones(3, dtype=
                                                           torch.bfloat16)})
    tree, _ = ckpt.restore_checkpoint(str(tmp_path), 1,
                                      {"w": torch.zeros(3, dtype=
                                                        torch.bfloat16)})
    assert tree["w"].dtype == ckpt.BF16_BITS
    with pytest.raises(ValueError, match="stored dtype"):
        ckpt.restore_checkpoint(str(tmp_path), 1,
                                {"w": np.zeros(3, np.int16)})
    with pytest.raises(ValueError, match="stored dtype"):
        ckpt.restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros(3)})
    mpath = tmp_path / "step_00000001" / "manifest.json"
    manifest = mpath.read_text().replace('"bfloat16"', '"|V2"')
    mpath.write_text(manifest)
    with pytest.raises(ValueError, match="stored dtype"):
        ckpt.restore_checkpoint(str(tmp_path), 1,
                                {"w": torch.zeros(3, dtype=torch.bfloat16)})


_NO_ML_DTYPES = textwrap.dedent("""
    import sys, tempfile
    sys.modules["ml_dtypes"] = None          # `import ml_dtypes` now fails
    import numpy as np
    try:
        np.dtype("bfloat16")
        raise SystemExit("bfloat16 is registered with numpy")
    except TypeError:
        pass
    import torch
    from repro_torch.configs import get_config
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.models import lm
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.train_step import (TrainConfig, load_state_tree,
                                              make_train_state, state_tree)
    cfg = get_config("kimi_k2_1t_a32b").smoke()
    tcfg = TrainConfig(opt=OptConfig(name="adafactor"))
    a = make_train_state(lm.lm_init(cfg, seed=1, device="cpu"), tcfg)
    b = make_train_state(lm.lm_init(cfg, seed=2, device="cpu"), tcfg)
    assert a["params"].embed.dtype == torch.bfloat16
    assert not a["params"].embed.equal(b["params"].embed)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, state_tree(a))
        tree, _ = restore_checkpoint(d, 1, state_tree(b))
        load_state_tree(b, tree)
    for (n, p), (_, q) in zip(a["params"].named_parameters(),
                              b["params"].named_parameters()):
        assert p.dtype == q.dtype and p.equal(q), n
    assert "jax" not in sys.modules and "ml_dtypes" not in [
        m for m, v in sys.modules.items() if v is not None]
    print("ok")
""")


def test_bf16_checkpoint_needs_no_ml_dtypes():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

