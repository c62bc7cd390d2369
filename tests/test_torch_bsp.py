"""Algorithm 3 on the port's single-controller mesh
(`repro_torch.launch.mesh`, `repro_torch.bsp`) held against the JAX
package on the CPU.

Live reference output: ONE subprocess with 8 fake CPU devices (the main
pytest process keeps JAX's 1-device view) runs `repro.bsp` on inputs the
parent wrote, under its own timeout, and writes an .npz. The port must
equal it element for element: the two-hop `exchange` per rank, `run_psort`
in key and comparator modes, SM1 at level 0 in every sort impl, SM2 with
the comparator network, and whole ``sort_impl="bitonic"`` builds (SA and
the full `BSPCounters` log). The keyed SM2 ("radix", "torch") does not run
on this JAX (a scan-carry `TypeError` under `shard_map`), so there the port
is held to the oracle on meshes of 2 to 8 ranks. Then the superstep
contract, the hard errors, the facade and the serving route.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from repro.core.oracle import suffix_array_doubling
from repro_torch.api import SAOptions, SuffixArrayIndex, build_suffix_array
from repro_torch.bsp import exchange as texchange
from repro_torch.bsp import psort
from repro_torch.bsp import suffix_array as tsa
from repro_torch.bsp.counters import BSPCounters
from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.serve import serve_sa_queries

from test_torch_bsp_primitives import FAMILIES, REF_IMPL, SEED

SRC = Path(__file__).resolve().parent.parent / "src"
P = 8
#: base_threshold of the whole bitonic builds of the two SM texts: 5 rounds
#: and a base gather (S = 101), and 2 rounds and a base gather (S = 41).
WHOLE_BASE = (64, 350)
#: the reference run's own limit (it takes about 45 s on 8 CPU cores).
LIVE_TIMEOUT_S = 600

# The reference side: reads in.npz, writes out.npz.
LIVE = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.bsp import suffix_array as bsa
    from repro.bsp.counters import BSPCounters
    from repro.bsp.exchange import exchange
    from repro.bsp.psort import lex_lt_full, make_local_sort_bitonic, run_psort
    from repro.core.compat import shard_map
    from repro.core.dcv_jax import suffix_array_jax

    inp = dict(np.load(sys.argv[1]))
    out = {}
    p = 8
    mesh = Mesh(np.array(jax.devices()).reshape(p), ("bsp",))
    holder = bsa._MeshHolder(mesh)
    # laid out as suffix_array_bsp lays them out, so its level 0 reuses the
    # stages compiled here
    shard = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("bsp")))

    for case in ("skew", "overflow", "random"):
        rows, dest = inp[f"ex_{case}_rows"], inp[f"ex_{case}_dest"]
        m, cap = len(rows) // p, int(inp[f"ex_{case}_cap"])
        def f(r, d, cap=cap, m=m):
            o, valid, over = exchange(r, d[:, 0], jnp.ones(m, bool), p=p,
                                      cap_out=cap, axis="bsp")
            return o, valid[:, None], over[None]
        fn = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("bsp"), P("bsp")),
                               out_specs=(P("bsp"), P("bsp"), P("bsp"))))
        o, valid, over = fn(jnp.asarray(rows), jnp.asarray(dest[:, None]))
        out[f"ex_{case}"] = np.asarray(o)
        out[f"ex_{case}_valid"] = np.asarray(valid)[:, 0]
        out[f"ex_{case}_over"] = np.asarray(over)

    for k in range(3):
        o, over = run_psort(mesh, "bsp", jnp.asarray(inp[f"ps_key{k}"]))
        out[f"ps_key{k}"], out[f"ps_key{k}_over"] = np.asarray(o), np.asarray(over)
    o, over = run_psort(mesh, "bsp", jnp.asarray(inp["ps_cmp"]),
                        lt_fn=lex_lt_full,
                        local_sort=make_local_sort_bitonic(lex_lt_full))
    out["ps_cmp"], out["ps_cmp_over"] = np.asarray(o), np.asarray(over)

    for t in range(2):
        x = inp[f"sm_text{t}"]
        n, v = len(x), 3
        n_pv, n_loc, m_loc, m_tot, tabs = bsa.round_geometry(n, p, v)
        xp = np.full(n_pv, -1, np.int32)
        xp[:n] = x
        sigma = bsa.quantize_sigma(int(x.max()) + 1)
        for impl in ("radix", "lax", "bitonic"):
            s1 = bsa._sm_widths(v, sigma, impl, True)[0]
            xprime, distinct, over = bsa._sm1(
                shard(xp), p=p, v=v, n_loc=n_loc, m_loc=m_loc, vkey=v,
                axis="bsp", mesh_holder=holder, sigma=s1)
            key = f"sm1_{t}_{impl}"
            out[key] = np.asarray(xprime)
            out[key + "_distinct"] = np.asarray(distinct)
            out[key + "_over"] = np.asarray(over)
        sa_sub = np.asarray(suffix_array_jax(out[f"sm1_{t}_radix"], v=3))
        sa_rank = np.empty(m_tot, np.int32)
        sa_rank[sa_sub] = np.arange(m_tot, dtype=np.int32)
        sa, over = bsa._sm2(shard(xp), shard(sa_rank), p=p, v=v,
                            n_loc=n_loc, m_loc=m_loc, vkey=v, axis="bsp",
                            mesh_holder=holder, impl="bitonic", sigma=None)
        out[f"sm2_{t}_rank"] = sa_rank
        out[f"sm2_{t}"], out[f"sm2_{t}_over"] = np.asarray(sa), np.asarray(over)

    for t in range(2):
        ct = BSPCounters()
        out[f"whole{t}"] = bsa.suffix_array_bsp(
            inp[f"sm_text{t}"], mesh, base_threshold=int(inp["whole_base"][t]),
            counters=ct, sort_impl="bitonic")
        out[f"whole{t}_log"] = np.asarray(json.dumps(ct.log))
    np.savez(sys.argv[2], **out)
""")


def _rows_of(vals):
    vals = np.asarray(vals)
    return np.stack([np.zeros(len(vals)), vals, np.arange(len(vals))],
                    axis=1).astype(np.int32)


def _inputs() -> dict:
    rng = np.random.default_rng(SEED)
    m = 32
    inp = {}
    for case, dest, cap in [("skew", np.full(P * m, 3), P * m),
                            ("overflow", np.zeros(P * m), 4),
                            ("random", rng.integers(0, P, P * m),
                             2 * m + 2 * P + 4)]:
        inp[f"ex_{case}_rows"] = np.stack(
            [np.arange(P * m), rng.integers(0, 99, P * m)],
            axis=1).astype(np.int32)
        inp[f"ex_{case}_dest"] = dest.astype(np.int32)
        inp[f"ex_{case}_cap"] = np.asarray(cap)
    for k, vals in enumerate([rng.integers(0, 50, 256), np.zeros(512),
                              np.arange(512)[::-1]]):
        inp[f"ps_key{k}"] = _rows_of(vals)
    inp["ps_cmp"] = _rows_of(rng.integers(0, 9, 256))
    inp["sm_text0"] = np.random.default_rng(2).integers(0, 30, 1500)
    inp["sm_text1"] = np.tile([1, 0, 2, 1, 0], 120)
    inp["whole_base"] = np.asarray(WHOLE_BASE)
    return inp


@pytest.fixture(scope="module", autouse=True)
def _live_run(tmp_path_factory):
    """Starts `LIVE` with the module's first test, so that the reference
    runs beside the tests that do not need it (they come first); `live`
    waits for it. Killed at the end if nothing waited."""
    d = tmp_path_factory.mktemp("bsp_live")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", LIVE, str(d / "in.npz"),
                             str(d / "out.npz")], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    yield inp, d, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def live(_live_run):
    """(inputs, the reference's outputs), within the run's own timeout."""
    inp, d, proc = _live_run
    try:
        out, err = proc.communicate(timeout=LIVE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
    return inp, dict(np.load(d / "out.npz"))


def _mesh(p: int = P):
    return tmesh.make_sa_mesh(p, device="cpu")


def _split(a, p: int = P):
    a = torch.from_numpy(np.asarray(a))
    return list(a.reshape(p, -1, *a.shape[1:]))


def _mesh_steps(ct: BSPCounters) -> int:
    """The supersteps of a log that are mesh rendezvous: all but the base
    gathers, which the controller does alone."""
    return ct.supersteps - sum(e["label"] == "base/gather" for e in ct.log)


def _eq(got, want) -> None:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


# ------------------------------------------- keyed SM2 against the oracle
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("p", [2, 3, 5, 6, 8])
@pytest.mark.parametrize("impl", ["radix", "torch"])
def test_keyed_bsp_matches_oracle(family, p, impl):
    rng = np.random.default_rng([SEED, p, sorted(FAMILIES).index(family)])
    x = np.asarray(FAMILIES[family](rng, 300, int(rng.integers(2, 64))),
                   np.int64)
    ct = BSPCounters()
    mesh = _mesh(p)
    sa = tsa.suffix_array_bsp(x, mesh, base_threshold=32, counters=ct,
                              sort_impl=impl)
    _eq(sa, suffix_array_doubling(x))
    assert ct.rounds >= 1 and mesh.rendezvous == _mesh_steps(ct)


# ----------------------------------------------------------- the contract
def test_all_equal_text_superstep_contract():
    x = np.zeros(3000, np.int64)
    ct = BSPCounters()
    mesh = _mesh()
    sa = tsa.suffix_array_bsp(x, mesh, base_threshold=64, counters=ct)
    _eq(sa, np.arange(3000)[::-1])
    labels = [e["label"] for e in ct.log]
    est = tsa.estimate_costs(3000, P, base_threshold=64, sigma=1)
    assert labels == [e["label"] for e in est.log]
    assert ct.supersteps == est.supersteps == 20 * ct.rounds + 1
    assert ct.rounds >= 2 and labels.count("base/gather") == 1
    assert sum(lb.startswith("SM1/") for lb in labels) == 11 * ct.rounds
    assert sum(lb.startswith("SM2/") for lb in labels) == 9 * ct.rounds
    assert mesh.rendezvous == ct.supersteps - 1


def test_divergent_collective_raises():
    mesh = _mesh(4)

    def body(me, x):
        if me == 2:
            yield tmesh.ppermute(x, [(0, 1)])
        else:
            yield tmesh.all_gather(x)

    with pytest.raises(tmesh.ScheduleError, match="divergent"):
        mesh.run(body, [(torch.zeros(3),)] * 4)

    def early(me, x):
        if me:
            yield tmesh.all_gather(x)
        return x

    with pytest.raises(tmesh.ScheduleError, match="returned"):
        mesh.run(early, [(torch.zeros(3),)] * 4)

    def ragged(me, x):
        return (yield tmesh.all_gather(x[:me + 1]))

    with pytest.raises(tmesh.ScheduleError):
        mesh.run(ragged, [(torch.zeros(4),)] * 4)
    assert mesh.rendezvous == 0


def test_collective_semantics():
    mesh = _mesh(3)

    def body(me, x):
        a = yield tmesh.ppermute(x, [(0, 1), (1, 2)])
        b = yield tmesh.all_gather(x)
        c = yield tmesh.all_to_all(torch.stack([x * 10 + d
                                                for d in range(3)]))
        return a, b, c

    xs = [torch.full((2,), r) for r in range(3)]
    out = mesh.run(body, [(x,) for x in xs])
    _eq(out[0][0], [0, 0])                       # rank 0 receives nothing
    _eq(out[2][0], [1, 1])
    for r in range(3):
        _eq(out[r][1], [[0, 0], [1, 1], [2, 2]])
        _eq(out[r][2], [[10 * s + r] * 2 for s in range(3)])
    assert mesh.rendezvous == 3


def _forcing(orig):
    """`orig` (an exchange) with every rank's overflow flag set."""
    def forced(rows, dest, valid, *, p, cap_out):
        out, val, over = yield from orig(rows, dest, valid, p=p,
                                         cap_out=cap_out)
        return out, val, torch.ones_like(over)
    return forced


def test_overflow_is_a_hard_error_naming_the_stage(monkeypatch):
    # the stages' own exchanges: SM1's rank routing, SM2's un-routing
    monkeypatch.setattr(tsa, "exchange", _forcing(texchange.exchange))
    x = np.random.default_rng(1).integers(0, 4, 600)
    with pytest.raises(RuntimeError, match="overflow in SM1"):
        tsa.suffix_array_bsp(x, _mesh(), base_threshold=64)
    n_pv, n_loc, m_loc, m_tot, _ = tsa.round_geometry(len(x), P, 3)
    xp = np.full(n_pv, -1, np.int32)
    xp[:len(x)] = x
    _, over = tsa._sm2(_mesh(), _split(xp),
                       _split(np.arange(m_tot, dtype=np.int32)), p=P, v=3,
                       n_loc=n_loc, m_loc=m_loc, impl="torch")
    assert bool(over.all())
    with pytest.raises(RuntimeError, match="overflow in SM2"):
        tsa._check_overflow(over, "SM2")
    tsa._check_overflow(torch.zeros(P, dtype=torch.bool), "SM1")


def test_psort_overflow_is_a_hard_error(monkeypatch):
    monkeypatch.setattr(psort, "exchange", _forcing(texchange.exchange))
    rows = torch.from_numpy(_rows_of(np.arange(512) % 7))
    with pytest.raises(RuntimeError, match="overflow"):
        psort.run_psort(_mesh(), "bsp", rows)
    _, over = psort.run_psort(_mesh(), "bsp", rows, check=False)
    assert bool(over.all())


def test_p1_is_one_base_superstep_and_kernel_is_rejected():
    x = np.random.default_rng(3).integers(0, 5, 600)
    ct = BSPCounters()
    mesh = _mesh(1)
    _eq(tsa.suffix_array_bsp(x, mesh, counters=ct), suffix_array_doubling(x))
    assert ct.log == [{"label": "base/gather", "h": 600, "w": 2400}]
    assert ct.rounds == 0 and mesh.rendezvous == 0
    assert tsa.estimate_costs(600, 1).supersteps == 1
    with pytest.raises(ValueError, match="kernel"):
        tsa.suffix_array_bsp(x, _mesh(), sort_impl="kernel")
    with pytest.raises(ValueError, match="kernel"):
        build_suffix_array(x, SAOptions(mesh=_mesh(), sort_impl="kernel"),
                           device="cpu")
    with pytest.raises(ValueError, match="axis"):
        tsa.suffix_array_bsp(x, _mesh(), axis="data")


def test_cuda_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.make_sa_mesh(8)
    assert tmesh.make_sa_mesh(device="cpu").p == 1


# ----------------------------------------------------- facade and serving
def test_mesh_auto_selects_bsp_through_the_facade():
    rng = np.random.default_rng(SEED)
    docs = [rng.integers(0, 40, int(rng.integers(200, 900)))
            for _ in range(5)]
    ct = BSPCounters()
    mesh = _mesh()
    opts = SAOptions(mesh=mesh, counters=ct)
    assert opts.resolve_backend() == "bsp"
    idx = SuffixArrayIndex.from_docs(docs, opts, device="cpu")
    _eq(idx.sa, suffix_array_doubling(idx.text.numpy()))
    assert ct.rounds >= 1 and mesh.rendezvous == _mesh_steps(ct)
    pats = [d[50:60] for d in docs]
    dense = SuffixArrayIndex.from_docs(docs, SAOptions(), device="cpu")
    _eq(torch.as_tensor(idx.count_batch(pats)), dense.count_batch(pats))


def test_serve_takes_the_mesh_route_on_several_devices(monkeypatch):
    monkeypatch.setattr(tmesh, "visible_devices",
                        lambda device="cuda": [torch.device("cpu")] * P)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run = serve_sa_queries(get_config("suffix-array"), n_chars=20_000,
                               n_docs=4, n_queries=16, device="cpu")
    text = out.getvalue()
    assert "backend=bsp" in text, text
    line = next(ln for ln in text.splitlines() if ln.startswith("bsp costs"))
    assert "sort_impl=radix" in line and "S=" in line, line
    _eq(run.index.sa, suffix_array_doubling(run.index.text.numpy()))


# ------------------------------- against live repro (last: see _live_run)
@pytest.mark.parametrize("case", ["skew", "overflow", "random"])
def test_exchange_per_rank_matches_live_jax(live, case):
    inp, want = live
    rows, dest = inp[f"ex_{case}_rows"], inp[f"ex_{case}_dest"]
    m, cap = len(rows) // P, int(inp[f"ex_{case}_cap"])
    out = _mesh().run(
        lambda me, r, d: texchange.exchange(r, d, torch.ones(m, dtype=bool),
                                            p=P, cap_out=cap),
        list(zip(_split(rows), _split(dest))))
    _eq(torch.cat([o for o, _, _ in out]), want[f"ex_{case}"])
    _eq(torch.cat([v for _, v, _ in out]), want[f"ex_{case}_valid"])
    _eq(torch.stack([f for _, _, f in out]), want[f"ex_{case}_over"])
    assert want[f"ex_{case}_over"].any() == (case == "overflow")


def test_run_psort_matches_live_jax(live):
    inp, want = live
    for key in ("ps_key0", "ps_key1", "ps_key2", "ps_cmp"):
        kw = {}
        if key == "ps_cmp":
            kw = {"lt_fn": psort.lex_lt_full,
                  "local_sort": psort.make_local_sort_bitonic(
                      psort.lex_lt_full)}
        out, over = psort.run_psort(_mesh(), "bsp",
                                    torch.from_numpy(inp[key]), **kw)
        _eq(out, want[key])
        _eq(over, want[key + "_over"])


@pytest.mark.parametrize("t", [0, 1])
@pytest.mark.parametrize("impl", ["radix", "torch", "bitonic"])
def test_sm1_level0_matches_live_jax(live, t, impl):
    inp, want = live
    x = inp[f"sm_text{t}"]
    n, v = len(x), 3
    n_pv, n_loc, m_loc, _, _ = tsa.round_geometry(n, P, v)
    xp = np.full(n_pv, -1, np.int32)
    xp[:n] = x
    sigma = psort.quantize_sigma(int(x.max()) + 1)
    mesh = _mesh()
    xprime, distinct, over = tsa._sm1(
        mesh, _split(xp), p=P, v=v, n_loc=n_loc, m_loc=m_loc,
        sigma=tsa._sm_widths(v, sigma, impl, True)[0],
        key_sort=psort.key_sort_of(impl))
    key = f"sm1_{t}_{REF_IMPL.get(impl, impl)}"
    _eq(torch.cat(xprime), want[key])
    _eq(distinct, want[key + "_distinct"])
    _eq(over, want[key + "_over"])
    assert mesh.rendezvous == 11


@pytest.mark.parametrize("t", [0, 1])
def test_sm2_bitonic_matches_live_jax(live, t):
    inp, want = live
    x = inp[f"sm_text{t}"]
    n, v = len(x), 3
    n_pv, n_loc, m_loc, _, _ = tsa.round_geometry(n, P, v)
    xp = np.full(n_pv, -1, np.int32)
    xp[:n] = x
    mesh = _mesh()
    sa, over = tsa._sm2(mesh, _split(xp), _split(want[f"sm2_{t}_rank"]),
                        p=P, v=v, n_loc=n_loc, m_loc=m_loc, impl="bitonic")
    _eq(torch.cat(sa), want[f"sm2_{t}"])
    _eq(over, want[f"sm2_{t}_over"])
    assert mesh.rendezvous == 9


@pytest.mark.parametrize("t", [0, 1])
def test_whole_bitonic_build_and_counters_match_live_jax(live, t):
    inp, want = live
    ct = BSPCounters()
    mesh = _mesh()
    x = inp[f"sm_text{t}"]
    sa = tsa.suffix_array_bsp(x, mesh, base_threshold=WHOLE_BASE[t],
                              counters=ct, sort_impl="bitonic")
    _eq(sa, want[f"whole{t}"])
    _eq(sa, suffix_array_doubling(x))
    assert ct.log == json.loads(str(want[f"whole{t}_log"]))
    assert ct.rounds >= 2
    assert mesh.rendezvous == _mesh_steps(ct)
