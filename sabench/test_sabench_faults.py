"""The judge of `correct`, held to its purpose on the CPU at tiny sizes:
sound runs of each cell read correct, and the control in the
program's place, or the timed path broken underneath, reads not correct.

Each run skips the harness's look for a card and drives the rest of a
run (`harness.run_cell` on the CPU) over the tiny cells of `sabench.tiny`.
"""
import pytest
import torch

from repro_torch.api import SuffixArrayIndex
from repro_torch.launch import mesh as mesh_mod
from sabench import harness, tiny

SEED = 2 ** 31 + 11


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def run(root, cell, **kw):
    return harness.run_cell(cell, SEED, 0.1, False, "cpu", root=root, **kw)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_run_is_correct(root, cell):
    result = run(root, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_in_the_programs_place_is_not_correct(root, cell):
    result = run(root, cell, use_control=True)
    assert not result["correct"], result["checks"]


def stale_build(monkeypatch):
    """A build that hands back the index it made first, unchanged."""
    real = SuffixArrayIndex.from_docs.__func__
    first = []

    def from_docs(cls, docs, *a, **kw):
        if not first:
            first.append(real(cls, docs, *a, **kw))
        return first[0]
    monkeypatch.setattr(SuffixArrayIndex, "from_docs",
                        classmethod(from_docs))


def altered_build(monkeypatch):
    """A suffix array with two entries swapped where it is produced."""
    real = SuffixArrayIndex.from_docs.__func__

    def from_docs(cls, docs, *a, **kw):
        index = real(cls, docs, *a, **kw)
        index.sa[[0, 1]] = index.sa[[1, 0]]
        return index
    monkeypatch.setattr(SuffixArrayIndex, "from_docs",
                        classmethod(from_docs))


def no_exchange(monkeypatch):
    """The ranks' point-to-point exchange left out: every `ppermute`
    delivers nothing, as to a rank that receives nothing."""
    real = mesh_mod.LocalMesh._perform

    def perform(self, requests):
        if requests[0].kind == "ppermute":
            return [torch.zeros_like(req.x) for req in requests]
        return real(self, requests)
    monkeypatch.setattr(mesh_mod.LocalMesh, "_perform", perform)


@pytest.mark.parametrize("cell,fault", [
    ("tiny-tokens.build", stale_build),
    ("tiny-tokens.build", altered_build),
    ("tiny-bsp.build", altered_build),
    ("tiny-bsp.build", no_exchange),
], ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    result = run(root, cell)
    assert not result["correct"], result["checks"]
