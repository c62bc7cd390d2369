"""The port's dry run (`repro_torch.launch.dryrun`, `.specs`,
`repro_torch.models.sharding`, `repro_torch.launch.mesh.
production_mesh_shape`) held against the JAX package's
(`repro.launch.dryrun`, `.specs`, `repro.models.sharding`) on the CPU.

* The cell set, the parameter counts (total and embedding equal, active
  within 1e-12 relative: the same float sums in another order) and the
  model FLOPs (equal) of all ten configs.
* The per-device shapes of the parameters, the optimizer state and the
  decode states on both production meshes: the port's arithmetic over the
  meshes' axis sizes against ``NamedSharding(AbstractMesh(...), spec).
  shard_shape`` of the JAX package's shardings (no device is needed),
  leaf by leaf through `repro_torch.models.convert`'s names (the JAX
  package's stacked leaves lead with the layer axis, which the port's
  per-layer tensors drop).
* One `run_cell` record and the CLI's files, at ``smoke()`` widths.
"""
import json
import os
from unittest import mock

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
import repro.launch.specs as jspecs
from repro.models.config import SHAPES as JSHAPES
from repro.models.sharding import ShardingRules as JRules
from repro_torch.configs import get_config, model_archs
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import mesh_num_devices, production_mesh_shape
from repro_torch.models.config import SHAPES
from repro_torch.models.convert import _layer_source
from repro_torch.models.sharding import ShardingRules, logical_to_shard_shape

with mock.patch.dict(os.environ):   # the reference sets XLA_FLAGS on import
    import repro.launch.dryrun as jdryrun

ARCHS = model_archs()
MESHES = ("single", "multi")


def abstract_mesh(kind):
    shape = production_mesh_shape(multi_pod=kind == "multi")
    return AbstractMesh(tuple(shape.values()), tuple(shape)), shape


def jflat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(jflat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def ref_name(cfg, name):
    """(the JAX package's name of the port's parameter `name`, whether it
    is stacked)."""
    if not name.startswith(("blocks.", "enc.")):
        return name, False
    stack, i, rest = name.split(".", 2)
    src, p = _layer_source(cfg, stack, int(i))
    return f"{src}.{rest}", p is not None


def ref_shard(sharding, leaf, stacked):
    shape = tuple(sharding.shard_shape(tuple(leaf.shape)))
    return shape[1:] if stacked else shape


def test_production_mesh_shape():
    assert production_mesh_shape() == {"data": 16, "model": 16}
    assert list(production_mesh_shape(multi_pod=True)) == \
        ["pod", "data", "model"]
    assert mesh_num_devices(production_mesh_shape()) == 256
    assert mesh_num_devices(production_mesh_shape(multi_pod=True)) == 512


def test_cell_runs_is_the_reference_set():
    ours = {(a, s) for a in ARCHS for s in SHAPES
            if specs.cell_runs(get_config(a), s)}
    ref = {(a, s) for a in jconfigs.model_archs() for s in JSHAPES
           if jspecs.cell_runs(jconfigs.get_config(a), s)}
    assert ours == ref and len(ours) == 35


def test_sharding_rules_spec():
    for axes in (("vocab", "embed"), ("embed_fsdp", "heads", "head_dim"),
                 ("experts", "embed_fsdp", "expert_mlp"), ("mlp", None),
                 ("batch", "embed_fsdp"), ("heads", "mlp")):
        assert ShardingRules().spec(axes) == tuple(JRules().spec(axes))
    r = ShardingRules().with_overrides(embed="model")
    assert r.spec(("embed", "heads")) == \
        tuple(JRules().with_overrides(embed="model").spec(("embed", "heads")))
    # gemma3-1b's embedding: the vocab over "model"
    assert logical_to_shard_shape((262144, 1152), ("vocab", "embed"),
                                  production_mesh_shape()) == \
        ((16384, 1152), ("model", None))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_breakdown_and_model_flops(arch):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    total, active, emb = dryrun.model_params_breakdown(cfg)
    j_total, j_active, j_emb = jdryrun.model_params_breakdown(jcfg)
    assert (total, emb) == (j_total, j_emb)
    assert abs(active - j_active) <= 1e-12 * j_active
    for name, shape in SHAPES.items():
        assert dryrun.model_flops_estimate(cfg, shape) == \
            jdryrun.model_flops_estimate(jcfg, JSHAPES[name])


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_shards_match_reference(arch, mesh_kind):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    mesh, mesh_shape = abstract_mesh(mesh_kind)
    rules = JRules()
    tcfg, jtcfg = specs.default_train_config(cfg), \
        jspecs.default_train_config(jcfg)
    state = specs.abstract_train_state(cfg, tcfg)
    ours = specs.train_state_shardings(tcfg, state, mesh_shape)
    jstate, axes = jspecs.abstract_train_state(jcfg, jtcfg)
    jsh = jspecs.train_state_shardings(jcfg, jtcfg, jstate, axes, mesh,
                                       rules)
    jparams, jp_sh = jflat(jstate["params"]), jflat(jsh["params"])
    names = [ref_name(cfg, n) for n in ours["params"]]
    assert {n for n, _ in names} == set(jparams)
    opt = tcfg.opt.name
    assert opt == cfg.optimizer
    for (name, spec), (jname, stacked) in zip(ours["params"].items(),
                                              names):
        want = ref_shard(jp_sh[jname], jparams[jname], stacked)
        assert spec.shard == want, (name, spec.spec, want)
        if opt in ("adamw", "sgdm"):
            for k in ("m", "v") if opt == "adamw" else ("m",):
                got = ours["opt"][k][name]
                jleaf = jflat(jstate["opt"][k])[jname]
                assert got.shard == ref_shard(
                    jflat(jsh["opt"][k])[jname], jleaf, stacked), (k, name)
                assert got.tensor.shape == jleaf.shape[1 if stacked else 0:]
        else:
            jf = jstate["opt"]["f"]
            jfs = jsh["opt"]["f"]
            for part in jname.split("."):
                jf, jfs = jf[part], jfs[part]
            mine = ours["opt"]["f"][name]
            if stacked and spec.tensor.dim() == 1:
                # the JAX package factors the stacked [L, d] leaf of a
                # layer's 1-D parameter; the port's per-layer Adafactor
                # keeps its unfactored second moment, laid out as the
                # parameter (a divergence of the port's optimizer, in
                # ROADMAP)
                assert sorted(jf) == ["vc", "vr"] and list(mine) == ["v"]
                assert mine["v"].shard == spec.shard
                continue
            assert sorted(mine) == sorted(jf)
            for k, got in mine.items():
                assert got.shard == ref_shard(jfs[k], jf[k], stacked), \
                    (k, name)
    assert ours["opt"]["step"].shard == ()


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_shards_match_reference(arch, mesh_kind):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    mesh, mesh_shape = abstract_mesh(mesh_kind)
    for shape_name in ("decode_32k", "long_500k"):
        if not specs.cell_runs(cfg, shape_name):
            continue
        _, ours = specs.decode_state_specs(cfg, SHAPES[shape_name],
                                           mesh_shape)
        jstates, jsh = jspecs.decode_state_specs(jcfg, JSHAPES[shape_name],
                                                 mesh)
        jflat_st, jflat_sh = jflat(jstates), jflat(jsh)
        seen = set()
        for i, layer in enumerate(ours):
            src, p = _layer_source(cfg, "blocks", i)
            for part, leaves in layer.items():
                for k, got in leaves.items():
                    jname = f"{src}.{part}.{k}"
                    seen.add(jname)
                    want = ref_shard(jflat_sh[jname], jflat_st[jname],
                                     p is not None)
                    assert got.shard == want, (shape_name, i, part, k)
        assert seen == set(jflat_st)
        batch = specs.decode_batch_specs(cfg, SHAPES[shape_name],
                                         mesh_shape)
        jbatch = jspecs.decode_batch_specs(jcfg, JSHAPES[shape_name], mesh)
        for k, got in batch.items():
            assert got.shard == tuple(jbatch[k].sharding.shard_shape(
                jbatch[k].shape)), (shape_name, k)


@pytest.mark.parametrize("mesh_kind", MESHES)
def test_batch_specs_match_reference(mesh_kind):
    mesh, mesh_shape = abstract_mesh(mesh_kind)
    for arch in ("gemma3-1b", "whisper-small"):
        cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
        for fn, jfn, shape in (
                (specs.train_batch_specs, jspecs.train_batch_specs,
                 "train_4k"),
                (specs.prefill_specs, jspecs.prefill_specs, "prefill_32k")):
            ours = fn(cfg, SHAPES[shape], mesh_shape)
            ref = jfn(jcfg, JSHAPES[shape], mesh)
            assert sorted(ours) == sorted(ref)
            for k, got in ours.items():
                assert tuple(got.tensor.shape) == ref[k].shape
                assert str(got.tensor.dtype).split(".")[1] == \
                    str(ref[k].dtype)
                assert got.shard == tuple(
                    ref[k].sharding.shard_shape(ref[k].shape)), (shape, k)


def smoke_configs():
    return mock.patch.object(dryrun, "get_config",
                             lambda arch: get_config(arch).smoke())


def test_run_cell_record_at_smoke():
    with smoke_configs():
        rec = dryrun.run_cell("gemma3-1b", "train_4k", "single", "")
    assert rec["status"] == "ok", rec.get("traceback")
    cfg = get_config("gemma3-1b").smoke().replace(remat="full")
    assert rec["chips"] == 256
    assert rec["flops"] == rec["flops_corrected"] > 0
    assert rec["bytes"] == rec["bytes_corrected"] > 0
    assert rec["model_flops"] == dryrun.model_flops_estimate(
        cfg, SHAPES["train_4k"])
    n = sum(p.numel() for p in specs.abstract_params(cfg).parameters())
    parts = rec["argument_bytes_one_card_by_part"]
    # float32 params, AdamW's two float32 moments and its int32 step,
    # the [256, 4097] int32 tokens
    assert parts == {"params": 4 * n, "opt": 8 * n + 4,
                     "batch": 4 * 256 * 4097}
    assert rec["argument_size_in_bytes_one_card"] == sum(parts.values())
    assert 0 < rec["argument_size_in_bytes"] < \
        rec["argument_size_in_bytes_one_card"]
    assert rec["alias_size_in_bytes"] < rec["argument_size_in_bytes"]
    assert rec["output_size_in_bytes"] == 6 * 4
    assert rec["temp_size_in_bytes"] > 0
    assert rec["count"]["scaled"] == {}     # two layers: counted whole
    for gone in ("lower_s", "compile_s", "hlo_lines", "collectives"):
        assert gone not in rec


def test_cli_writes_records(tmp_path):
    with smoke_configs():
        rc = dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "decode_32k",
                          "--mesh", "both", "--out", str(tmp_path)])
        assert rc == 0
        names = sorted(os.listdir(tmp_path))
        assert names == ["rwkv6-1.6b__decode_32k__multi.json",
                         "rwkv6-1.6b__decode_32k__single.json"]
        recs = {n: json.loads((tmp_path / n).read_text()) for n in names}
        multi, single = recs[names[0]], recs[names[1]]
        assert single["status"] == multi["status"] == "ok"
        assert (single["chips"], multi["chips"]) == (256, 512)
        # one count, two layouts
        assert single["flops"] == multi["flops"] > 0
        assert multi["argument_size_in_bytes"] <= \
            single["argument_size_in_bytes"]
        assert dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "decode_32k",
                            "--mesh", "single", "--out", str(tmp_path),
                            "--skip-existing"]) == 0
    cfg = get_config("rwkv6-1.6b").smoke()
    # the decode step returns the logits and the new recurrent states
    B = SHAPES["decode_32k"].global_batch
    assert single["output_size_in_bytes"] > 4 * B * cfg.vocab_size // 16
    np.testing.assert_equal(single["alias_size_in_bytes"], 0)
