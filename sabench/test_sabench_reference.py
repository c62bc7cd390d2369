"""The plain reference against brute force on small seeded corpora, and
the program's layout against the reference."""
import numpy as np
import pytest
import torch

from repro_torch.api import SuffixArrayIndex
from sabench import corpus, reference


def small(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 40, size=int(rng.integers(1, 9)))
    data = rng.integers(0, 3, size=int(lengths.sum()))
    return rng, torch.as_tensor(data), torch.as_tensor(lengths)


def brute_sa(text):
    t = text.tolist()
    return sorted(range(len(t)), key=lambda i: t[i:])


@pytest.mark.parametrize("seed", range(8))
def test_suffix_array_equals_a_brute_force_sort(seed):
    rng, data, lengths = small(seed)
    order = rng.permutation(len(lengths))
    for separators in reference.SEPARATORS:
        text = reference.encode(data, lengths, order, separators=separators)
        assert reference.suffix_array(text).tolist() == brute_sa(text)


def test_layout_matches_the_programs_from_docs():
    config = {"tokens": 600,
              "corpus": {"vocab": 5, "zipf_exponent": 1.0,
                         "doc_length": {"dist": "lognormal", "mean": 20,
                                        "sigma": 1.0},
                         "copy_share": 0.2, "passage": [4, 10]}}
    data = corpus.make_corpus(config, 3, "cpu")
    assert data.tokens == 600 and data.n_docs == 30
    order = corpus.build_order(3, 5, data.n_docs)
    index = SuffixArrayIndex.from_docs(data.docs[order], device="cpu")
    text = reference.encode(data.data, data.lengths, order)
    assert torch.equal(index.text.cpu(), text)
    assert torch.equal(index.sa.long().cpu(), reference.suffix_array(text))


def test_control_breaks_the_document_guarantee():
    # docs "0 1" and "0 1": with unique separators the suffix at doc 0's
    # end sorts before doc 1's; shared, the comparison runs on
    data, lengths = torch.tensor([0, 1, 1, 0, 1, 0]), torch.tensor([2, 2, 2])
    true = reference.suffix_array(reference.encode(data, lengths))
    shared = reference.suffix_array(
        reference.encode(data, lengths, separators="shared"))
    assert not torch.equal(true, shared)
