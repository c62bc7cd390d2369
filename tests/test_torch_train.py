"""The port's training stack (`repro_torch.train`, `repro_torch.launch.
train`) held against the JAX package's (`repro.train`,
`repro.launch.train`) on the CPU.

* One `make_train_step` of minicpm-2b at ``smoke()`` with the same params
  and batch: loss, grad norm, lr, ``masked_frac`` and the gradient tree
  (bf16 paths: loss within 1e-2 absolute, grad norm within 5%, each
  gradient leaf within 0.05 of its largest magnitude), and the params
  after the step (an AdamW step moves a parameter by at most about lr;
  within 2.1·lr of the reference's, which allows a sign flip of a
  gradient entry near zero); with two microbatches too.
* Schedules, clipping, int8 error feedback and the three optimizers on
  the same numpy trees: float32 paths, 1e-6 relative.
* The counterparts of tests/train/test_train.py's `test_loss_decreases`
  and `test_checkpoint_resume_bitexact` (bit-exact on the CPU), and of
  tests/train/test_data_plane.py's two cases that need a train step: the
  gate's mask feeding the loss, and the train smoke run (in-process with
  ``--device cpu``), whose dedup, gate and probe numbers must equal
  `repro.launch.train.main`'s and whose loss, with the reference's init
  patched in, its loss within 1e-2.
"""
import dataclasses
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.launch.train as jtrain_launch
import repro.train.optim as joptim
import repro.train.schedule as jschedule
import repro.train.train_step as jtrain
from repro.models import lm as jlm
from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.pipeline import (PipelineConfig, TokenPipeline,
                                       synthetic_corpus)
from repro_torch.launch import train as train_launch
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.train import optim, schedule
from repro_torch.train.train_step import (TrainConfig, load_state_tree,
                                          make_loss_fn, make_train_state,
                                          make_train_step, state_tree)

CPU = "cpu"
REL = 0.05
LOSS_ABS = 1e-2
F32_REL = 1e-6


def t(x):
    return torch.from_numpy(np.array(x))


def close_f32(got, want, rel=F32_REL):
    got = np.asarray(torch.as_tensor(got).detach().numpy(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= rel * scale, \
        (float(np.max(np.abs(got - want))), scale)


def jtree_to_torch(tree):
    return jax.tree_util.tree_map(lambda a: t(np.asarray(a)), tree)


def torch_tree_to_np(tree):
    return optim.tree_map(lambda a: a.detach().numpy(), tree)


# ------------------------------------------------------------- one step
def minicpm(seed=0, vocab=None):
    jcfg = jconfigs.get_config("minicpm_2b").smoke()
    cfg = get_config("minicpm_2b").smoke()
    if vocab:
        jcfg, cfg = jcfg.replace(vocab_size=vocab), cfg.replace(
            vocab_size=vocab)
    jparams, _ = jlm.lm_init(jax.random.PRNGKey(seed), jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, cfg, jparams, params_np


def grads_as_jax_layout(model, grads: dict) -> dict:
    """The port's gradients (keyed by parameter name) in the JAX layout."""
    with torch.no_grad():
        saved = {n: p.clone() for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.copy_(grads[n])
        tree = params_to_jax(model)
        for n, p in model.named_parameters():
            p.copy_(saved[n])
    return tree


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    jcfg, cfg, jparams, params_np = minicpm()
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    mask = (rng.random((4, 16)) > 0.3).astype(np.float32)
    batch = {"tokens": toks, "loss_mask": mask}
    if microbatches > 1:
        batch = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in batch.items()}
    lr = 1e-3
    tcfg_j = jtrain.TrainConfig(opt=joptim.OptConfig(lr=lr), warmup=0,
                                total_steps=10, microbatches=microbatches)
    tcfg = TrainConfig(opt=optim.OptConfig(lr=lr), warmup=0, total_steps=10,
                       microbatches=microbatches)
    jstate, jm = jax.jit(jtrain.make_train_step(jcfg, tcfg_j))(
        jtrain.make_train_state(jparams, tcfg_j),
        jax.tree_util.tree_map(jnp.asarray, batch))

    model = params_from_jax(params_np, cfg, device=CPU)
    state, m = make_train_step(cfg, tcfg)(make_train_state(model, tcfg),
                                          batch)
    assert abs(float(m["loss"]) - float(jm["loss"])) < LOSS_ABS
    assert abs(float(m["xent"]) - float(jm["xent"])) < LOSS_ABS
    assert float(m["tokens"]) == float(jm["tokens"])
    assert abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1) < 0.05
    assert math.isclose(float(m["lr"]), float(jm["lr"]), rel_tol=F32_REL)
    assert math.isclose(float(m["masked_frac"]), float(jm["masked_frac"]),
                        rel_tol=F32_REL)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 1
    assert state["params"] is model               # trained in place
    new = params_to_jax(model)
    for a, b in zip(jax.tree_util.tree_leaves(new),
                    jax.tree_util.tree_leaves(jstate["params"])):
        assert float(np.max(np.abs(a - np.asarray(b)))) <= 2.1 * lr


def _gradient_trees_match(jcfg, cfg, jparams, params_np, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 25)).astype(np.int32)
    mask = (rng.random((2, 24)) > 0.3).astype(np.float32)
    jgrads = jax.jit(jax.grad(lambda p: jlm.lm_loss(p, jcfg, {
        "tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)})[0]))(
            jparams)
    model = params_from_jax(params_np, cfg, device=CPU)
    loss, _ = lm.lm_loss(model, cfg, {"tokens": t(toks),
                                      "loss_mask": t(mask)})
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    ours = grads_as_jax_layout(model, grads)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    flat_o = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    assert set(flat_o) == set(flat_j)
    for path, g in flat_j.items():
        g = np.asarray(g, np.float64)
        err = np.max(np.abs(flat_o[path] - g)) / np.max(np.abs(g))
        assert err < REL, (path, err)


def test_gradient_tree_matches_jax():
    _gradient_trees_match(*minicpm(seed=1), seed=1)


@pytest.mark.parametrize("arch", ["phi35_moe_42b_a6_6b", "recurrentgemma_2b",
                                  "rwkv6_1_6b"])
def test_gradient_tree_of_the_other_kinds_matches_jax(arch):
    """The MoE (router, experts), the RG-LRU block and RWKV6's time-mix
    and channel-mix, each leaf's gradient within 0.05 of the
    reference's largest."""
    jcfg = jconfigs.get_config(arch).smoke()
    cfg = get_config(arch).smoke()
    jparams, _ = jlm.lm_init(jax.random.PRNGKey(2), jcfg)
    _gradient_trees_match(jcfg, cfg, jparams,
                          jax.tree_util.tree_map(np.asarray, jparams), seed=2)


#: (architecture, where remat is asked for): the config's per-period
#: remat, or `TrainConfig.remat` around the whole loss.
REMATS = [("recurrentgemma_2b", "cfg:full"), ("kimi_k2_1t_a32b", "cfg:full"),
          ("phi35_moe_42b_a6_6b", "full"), ("rwkv6_1_6b", "save_dots"),
          ("whisper_small", "save_dots")]


@pytest.mark.parametrize("arch,remat", REMATS)
def test_remat_keeps_the_loss_and_gradients(arch, remat):
    """Remat is a memory policy: the loss and every gradient equal the
    run without it (float32, 1e-6 relative), and the forward keeps fewer
    tensors for the backward."""
    cfg = get_config(arch).smoke().replace(remat="none")
    model = lm.lm_init(cfg, seed=3, device=CPU)
    rng = np.random.default_rng(3)
    batch = {"tokens": t(rng.integers(0, cfg.vocab_size, (2, 17)))}
    if cfg.is_encdec:
        batch["enc_embeds"] = t((0.02 * rng.standard_normal(
            (2, cfg.enc_seq, cfg.d_model))).astype(np.float32))
    names, leaves = zip(*model.named_parameters())

    def run(cfg_, tremat):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda x: saved.append(x.numel()) or x, lambda x: x):
            loss, _ = make_loss_fn(cfg_, remat=tremat)(model, batch)
        return loss, torch.autograd.grad(loss, leaves), sum(saved)

    base_loss, base_grads, base_saved = run(cfg, "none")
    if remat.startswith("cfg:"):
        loss, grads, saved = run(cfg.replace(remat="full"), "none")
    else:
        loss, grads, saved = run(cfg, remat)
    close_f32(loss, base_loss.detach().numpy())
    for name, g, want in zip(names, grads, base_grads):
        close_f32(g.float(), want.float().numpy())
    assert saved < base_saved, (saved, base_saved)


def test_step_zero_has_lr_zero():
    _, cfg, _, params_np = minicpm()
    tcfg = TrainConfig(opt=optim.OptConfig(lr=1e-3), warmup=5,
                       total_steps=50)
    model = params_from_jax(params_np, cfg, device=CPU)
    before = [p.detach().clone() for p in model.parameters()]
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9))
    _, m = make_train_step(cfg, tcfg)(make_train_state(model, tcfg),
                                      {"tokens": toks.astype(np.int32)})
    assert float(m["lr"]) == 0.0
    assert all(p.equal(q) for p, q in zip(model.parameters(), before))


# --------------------------------------------------- schedules, optimizers
@pytest.mark.parametrize("name,kw", [
    ("cosine", dict(base_lr=3e-4, warmup=10, total=100)),
    ("cosine", dict(base_lr=1.0, warmup=0, total=37, min_ratio=0.2)),
    ("wsd", dict(base_lr=1e-3, warmup=5, total=120)),
    ("wsd", dict(base_lr=2.0, warmup=1, total=40, decay_frac=0.3,
                 min_ratio=0.05)),
])
def test_schedules_match_jax(name, kw):
    ours = schedule.make_schedule(name, **kw)
    theirs = jschedule.make_schedule(name, **kw)
    steps = np.arange(0, kw["total"] + 10, dtype=np.int32)
    got = ours(torch.from_numpy(steps))
    want = np.asarray(theirs(jnp.asarray(steps)))
    close_f32(got, want)
    for s in (0, 3, kw["total"]):                 # 0-d int32 steps
        close_f32(ours(torch.tensor(s, dtype=torch.int32)),
                  np.asarray(theirs(jnp.int32(s))))


def random_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "blk": {"k": rng.normal(size=(3, 4, 2)).astype(np.float32),
                    "n": (3 * rng.normal(size=(4,))).astype(np.float32)}}


def test_global_norm_and_clip_match_jax():
    g = random_tree(0)
    close_f32(optim.global_norm(jtree_to_torch(g)),
              np.asarray(joptim.global_norm(g)))
    for max_norm in (0.5, 100.0):
        ours, n = optim.clip_by_global_norm(jtree_to_torch(g), max_norm)
        theirs, jn = joptim.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, g), max_norm)
        close_f32(n, np.asarray(jn))
        for a, b in zip(jax.tree_util.tree_leaves(torch_tree_to_np(ours)),
                        jax.tree_util.tree_leaves(theirs)):
            close_f32(a, np.asarray(b))
    clipped, _ = optim.clip_by_global_norm({"a": torch.full((4,), 100.0)},
                                           1.0)
    assert abs(float(optim.global_norm(clipped)) - 1.0) < 1e-4


def test_int8_error_feedback_matches_jax():
    err = optim.tree_map(torch.zeros_like, jtree_to_torch(random_tree(0)))
    jerr = jax.tree_util.tree_map(jnp.zeros_like, random_tree(0))
    for k in range(5):
        g = random_tree(10 + k)
        q, err = optim.compressed_grads_with_feedback(jtree_to_torch(g), err)
        jq, jerr = joptim.compressed_grads_with_feedback(
            jax.tree_util.tree_map(jnp.asarray, g), jerr)
        for a, b in zip(jax.tree_util.tree_leaves(torch_tree_to_np(q)),
                        jax.tree_util.tree_leaves(jq)):
            close_f32(a, np.asarray(b))
        for a, b in zip(jax.tree_util.tree_leaves(torch_tree_to_np(err)),
                        jax.tree_util.tree_leaves(jerr)):
            close_f32(a, np.asarray(b))
    qq, s = optim.compress_int8(torch.tensor([0.5, -1.0, 0.25]))
    assert qq.dtype == torch.int8 and qq.tolist() == [64, -127, 32]


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_optimizers_match_jax(name):
    cfg = optim.OptConfig(name=name, lr=1e-2, weight_decay=0.1)
    jcfg = joptim.OptConfig(name=name, lr=1e-2, weight_decay=0.1)
    init, update = optim.make_optimizer(cfg)
    jinit, jupdate = joptim.make_optimizer(jcfg)
    params = random_tree(0)
    ours_p = jtree_to_torch(params)
    ours_s = init(ours_p)
    theirs_p = jax.tree_util.tree_map(jnp.asarray, params)
    theirs_s = jinit(theirs_p)
    for k in range(4):
        g = random_tree(100 + k)
        lr = 1e-2 * (k + 1) / 4
        ours_p, ours_s = update(ours_p, jtree_to_torch(g), ours_s,
                                lr=torch.tensor(lr, dtype=torch.float32))
        theirs_p, theirs_s = jupdate(theirs_p, jax.tree_util.tree_map(
            jnp.asarray, g), theirs_s, lr=jnp.float32(lr))
        for a, b in zip(jax.tree_util.tree_leaves(torch_tree_to_np(ours_p)),
                        jax.tree_util.tree_leaves(theirs_p)):
            close_f32(a, np.asarray(b))
        ours_leaves = jax.tree_util.tree_leaves(
            optim.tree_map(lambda a: a.numpy(), ours_s))
        theirs_leaves = jax.tree_util.tree_leaves(theirs_s)
        assert len(ours_leaves) == len(theirs_leaves)
        for a, b in zip(ours_leaves, theirs_leaves):
            close_f32(a, np.asarray(b))


# ---------------------------------------------- test_train.py counterparts
def _setup(vocab=64, opt="adamw", lr=3e-3, **tkw):
    cfg = get_config("minicpm_2b").smoke().replace(vocab_size=vocab)
    model = lm.lm_init(cfg, seed=0, device=CPU)
    tcfg = TrainConfig(opt=optim.OptConfig(name=opt, lr=lr), warmup=5,
                       total_steps=60, **tkw)
    state = make_train_state(model, tcfg)
    step = make_train_step(cfg, tcfg)
    pipe = TokenPipeline(synthetic_corpus(16000, vocab=vocab, seed=1),
                         PipelineConfig(seq_len=32, global_batch=8),
                         device=CPU)
    return cfg, tcfg, state, step, pipe


def test_loss_decreases():
    _, _, state, step, pipe = _setup()
    losses = []
    for i in range(40):
        state, m = step(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.8 * losses[0]
    assert all(np.isfinite(losses))


def test_checkpoint_resume_bitexact(tmp_path):
    """Train 10, save, restore into a fresh state, continue 10 == train
    20 (on the CPU; on the card the embedding backward's atomics make the
    sums' order vary)."""
    cfg, tcfg, s, step, pipe = _setup()
    for i in range(10):
        s, _ = step(s, pipe.batch_at(i))
    save_checkpoint(str(tmp_path), 10, state_tree(s))
    assert latest_step(str(tmp_path)) == 10
    b = make_train_state(lm.lm_init(cfg, seed=5, device=CPU), tcfg)
    tree, _ = restore_checkpoint(str(tmp_path), 10, state_tree(b))
    b = load_state_tree(b, tree)
    a = s
    for i in range(10, 20):
        a, _ = step(a, pipe.batch_at(i))
        b, _ = step(b, pipe.batch_at(i))
    la = jax.tree_util.tree_leaves(state_tree(a))
    lb = jax.tree_util.tree_leaves(state_tree(b))
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert np.array_equal(x, y)


# ------------------------------------- test_data_plane.py counterparts
def test_gate_mask_feeds_loss_and_masked_frac_metric():
    """loss_mask flows batch → lm_loss → chunked xent; masked targets
    change the loss and surface as the masked_frac metric."""
    cfg = get_config("minicpm_2b").smoke()
    model = lm.lm_init(cfg, seed=0, device=CPU)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    full = {"tokens": t(toks), "loss_mask": torch.ones((2, 16))}
    half_mask = np.ones((2, 16), np.float32)
    half_mask[:, 8:] = 0.0
    half = {"tokens": toks, "loss_mask": half_mask}
    with torch.no_grad():
        l_full, m_full = lm.lm_loss(model, cfg, full)
        l_half, m_half = lm.lm_loss(model, cfg, {k: t(v)
                                                 for k, v in half.items()})
    assert float(m_full["tokens"]) == 32 and float(m_half["tokens"]) == 16
    assert not np.isclose(float(l_full), float(l_half))
    tcfg = TrainConfig(opt=optim.OptConfig())
    _, metrics = make_train_step(cfg, tcfg)(make_train_state(model, tcfg),
                                            half)
    assert np.isclose(float(metrics["masked_frac"]), 0.5)
    assert np.isfinite(float(metrics["loss"]))


SMOKE_ARGV = ["--arch", "minicpm-2b", "--smoke", "--steps", "4",
              "--seq-len", "48", "--batch", "4", "--corpus-chars", "30000",
              "--doc-len", "1500", "--shard-docs", "5", "--dedup",
              "--dedup-min-len", "24", "--eval-gate", "--gate-min-len", "24",
              "--plant-contamination", "40", "--probe-every", "2",
              "--probe-len", "8", "--log-every", "2"]


def test_train_smoke_subprocess_gate_and_probe_in_report(capsys):
    """The train smoke run, in-process on the CPU: planted contamination
    surfaces as rejected windows, the probe logs copy metrics, the loss
    stays finite; the dedup, gate and probe numbers equal the JAX
    package's run, and with its init patched in, so does the loss."""
    want = jtrain_launch.main(SMOKE_ARGV)
    jparams, _ = jlm.lm_init(jax.random.PRNGKey(0),
                             jconfigs.get_config("minicpm-2b").smoke())
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    capsys.readouterr()

    def reference_init(cfg, *, seed=0, generator=None, device="cuda"):
        assert seed == 0
        return params_from_jax(params_np, cfg, device=device)

    with mock.patch.object(train_launch, "lm_init", reference_init):
        m = train_launch.main(SMOKE_ARGV + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert m["gate"]["rejected_windows"] > 0, m
    assert m["probe"]["samples"] > 0, m
    assert math.isfinite(m["loss"]), m
    assert m["dedup"]["builds"] == m["dedup"]["shards"] > 1, m
    assert "gate[rej" in out and "copy[max" in out
    assert m["dedup"] == want["dedup"] and m["gate"] == want["gate"]
    assert m["probe"]["samples"] == want["probe"]["samples"]
    assert abs(m["loss"] - want["loss"]) < LOSS_ABS
    assert [s["loss"] for s in m["steps"]][-1] == m["loss"]
    assert len(m["steps"]) == 4 and all(s["s"] > 0 for s in m["steps"])


def test_train_mask_policy_reports_masked_frac(capsys):
    m = train_launch.main(SMOKE_ARGV + ["--gate-policy", "mask",
                                        "--device", "cpu"])
    assert m["gate"]["masked_windows"] > 0 and \
        m["gate"]["rejected_windows"] == 0
    assert max(s["masked_frac"] for s in m["steps"]) > 0
    assert "masked" in capsys.readouterr().out


def test_train_resume_restores_the_ports_checkpoint(tmp_path, capsys):
    argv = ["--arch", "gemma3-1b", "--smoke", "--seq-len", "24", "--batch",
            "2", "--corpus-chars", "6000", "--doc-len", "1000",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--device",
            "cpu"]
    full = train_launch.main(argv + ["--steps", "4"])
    assert latest_step(str(tmp_path)) == 4
    resumed = train_launch.main(argv + ["--steps", "6", "--resume"])
    assert "resumed from step 4" in capsys.readouterr().out
    assert len(resumed["steps"]) == 2 and math.isfinite(resumed["loss"])
    assert latest_step(str(tmp_path)) == 6
    assert full["loss"] != resumed["loss"]


def test_train_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_launch.main(["--arch", "minicpm-2b", "--smoke", "--steps",
                           "1"])


def test_train_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(TrainConfig)] == \
        [f.name for f in dataclasses.fields(jtrain.TrainConfig)]
    assert dataclasses.asdict(optim.OptConfig()) == \
        dataclasses.asdict(joptim.OptConfig())
