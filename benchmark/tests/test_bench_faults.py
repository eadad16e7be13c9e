"""``correct`` comes out false when the timed path is broken underneath:
a run on the CPU (no look for a card) with the program patched, once for
each fault a cell can have. One chip, so no exchange between chips."""

from __future__ import annotations

import pytest
import torch

import gcc_tpu_torch.features.featurize as featurize_mod
import gcc_tpu_torch.generate as generate_mod
import gcc_tpu_torch.training.pretrain as pretrain_mod
from benchmark.tests.tiny import run_cell

TRAIN = ["moco-pretrain", "e2e-pretrain"]


def _unchanged(monkeypatch):
    """Every step runs, and hands its state back as it found it."""
    orig = pretrain_mod.optimizer_update

    def step(state, loss, clip_mode="norm"):
        saved = [p.detach().clone() for p in state.model.parameters()]
        norm = orig(state, loss, clip_mode)
        with torch.no_grad():
            for p, s in zip(state.model.parameters(), saved):
                p.copy_(s)
        return norm

    monkeypatch.setattr(pretrain_mod, "optimizer_update", step)


def _half_batch(monkeypatch):
    """The loss of the first half of the batch, the rest left out."""
    orig_moco = pretrain_mod.nce_softmax_loss
    orig_e2e = pretrain_mod.in_batch_loss

    def moco(logits, labels):
        h = logits.shape[0] // 2
        return orig_moco(logits[:h], labels[:h])

    def e2e(q, k, t):
        h = q.shape[0] // 2
        return orig_e2e(q[:h], k[:h], t)

    monkeypatch.setattr(pretrain_mod, "nce_softmax_loss", moco)
    monkeypatch.setattr(pretrain_mod, "in_batch_loss", e2e)


def _altered_pe(monkeypatch):
    """Every eighth graph's PE with its rows shifted, where it is made."""
    for mod in (featurize_mod, pretrain_mod):
        orig = mod.laplacian_positional_embedding

        def pe(*a, _orig=orig, **k):
            out = _orig(*a, **k).clone()
            out[::8] = out[::8].roll(1, dims=1)
            return out

        monkeypatch.setattr(mod, "laplacian_positional_embedding", pe)


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_pe])
def test_training_fault_is_not_correct(capsys, monkeypatch, workload, fault):
    fault(monkeypatch)
    line = run_cell(capsys, workload, seconds=0.1)
    assert line["correct"] is False, line["checks"]


def _embed_half(monkeypatch):
    """Each call's second half of graphs given the first half's rows."""
    orig = generate_mod._encode_chunks

    def chunks(*a, **k):
        for emb, keep in orig(*a, **k):
            h = emb.shape[0] // 2
            yield torch.cat([emb[:h], emb[:emb.shape[0] - h]]), keep

    monkeypatch.setattr(generate_mod, "_encode_chunks", chunks)


def _embed_altered(monkeypatch):
    """One embedding of each call moved where it is made."""
    orig = generate_mod._encode_chunks

    def chunks(*a, **k):
        for emb, keep in orig(*a, **k):
            emb = emb.clone()
            emb[0] += 0.1
            yield emb, keep

    monkeypatch.setattr(generate_mod, "_encode_chunks", chunks)


@pytest.mark.parametrize("fault", [_embed_half, _embed_altered])
def test_embed_fault_is_not_correct(capsys, monkeypatch, fault):
    fault(monkeypatch)
    line = run_cell(capsys, "moco-embed", seconds=0.1)
    assert line["correct"] is False, line["checks"]
