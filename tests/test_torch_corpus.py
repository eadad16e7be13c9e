"""The port's copies of the reference-scale and family-diverse corpus
generators (``gcc_tpu_torch/graph/corpus.py``) against gcc_tpu's: the
same files, byte for byte, and the same manifest. The reference-scale
corpus (~150M edges) is never built here: both packages' shape tables
are patched to a few tiny graphs."""

import filecmp
import json
import os

import pytest

from gcc_tpu.graph import corpus as jx_corpus
from gcc_tpu_torch.graph import corpus

TINY_SHAPES = (("dblp-netrep", 900, 30), ("dblp-snap", 700, 7),
               ("livejournal", 2_500, 17))


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert len(names) > 1
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    with open(os.path.join(a, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("sort_rows", [True, False])
def test_reference_scale_corpus_equals_reference(tmp_path, monkeypatch,
                                                 sort_rows):
    """synthetic_corpus_reference_scale on patched tiny shapes writes the
    reference's files byte for byte, with or without sorted rows (the
    manifest's rows_sorted flag with them)."""
    monkeypatch.setattr(corpus, "REFERENCE_SCALE_SHAPES", TINY_SHAPES)
    monkeypatch.setattr(jx_corpus, "REFERENCE_SCALE_SHAPES", TINY_SHAPES)
    store = corpus.synthetic_corpus_reference_scale(
        str(tmp_path / "port"), seed=3, sort_rows=sort_rows)
    want = jx_corpus.synthetic_corpus_reference_scale(
        str(tmp_path / "ref"), seed=3, sort_rows=sort_rows)
    manifest = _same_files(tmp_path / "port", tmp_path / "ref")
    assert manifest == store.manifest == want.manifest
    assert [g["name"] for g in manifest["graphs"]] == [
        s[0] for s in TINY_SHAPES]
    assert manifest.get("rows_sorted", False) == sort_rows
    assert store.load(2).rows_sorted == sort_rows


def test_reference_scale_shapes_equal_reference():
    """The shape table itself is the reference's."""
    assert corpus.REFERENCE_SCALE_SHAPES == jx_corpus.REFERENCE_SCALE_SHAPES


@pytest.mark.parametrize("seed", [0, 5])
def test_diverse_corpus_equals_reference(tmp_path, seed):
    """synthetic_corpus_diverse at 2,000 nodes a graph writes the
    reference's six graphs byte for byte, manifest included."""
    store = corpus.synthetic_corpus_diverse(str(tmp_path / "port"),
                                            nodes_per_graph=2000, seed=seed)
    want = jx_corpus.synthetic_corpus_diverse(str(tmp_path / "ref"),
                                              nodes_per_graph=2000,
                                              seed=seed)
    manifest = _same_files(tmp_path / "port", tmp_path / "ref")
    assert manifest == store.manifest == want.manifest
    assert store.num_graphs == 6 and store.graph_sizes == [2000] * 6
