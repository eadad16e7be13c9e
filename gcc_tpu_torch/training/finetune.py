"""Supervised finetuning (reference train_finetune, train.py:175-337).

Counterpart of ``gcc_tpu/training/finetune.py``: the encoder plus a
linear classification head trained with cross-entropy, gradients clipped
by value 1 (train.py:227-228), the warmup-linear rate of pre-training,
and 10-fold stratified cross-validation (train.py:800-815). The reference's
two Adam optimizers of identical settings (encoder, head) are one
optimizer over both here, as in ``gcc_tpu``. BatchNorm running
statistics are reset when pretrained weights are loaded (reference
clear_bn, train.py:652-657).

Every batch is featurized with the eval PE profile (16 guard columns;
on the card one launch of Kernel 2 and two of Kernel 3 per step). Node
datasets resample each node's RWR subgraph every epoch (reference
graph_dataset.py:388-433); graph datasets are encoded whole and fixed
(graph_dataset.py:362).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from gcc_tpu_torch.config import TrainConfig
from gcc_tpu_torch.device import resolve_device
from gcc_tpu_torch.features.featurize import featurize_batch
from gcc_tpu_torch.generate import _guarded_batch_size
from gcc_tpu_torch.graph.batch import (
    PaddedSubgraphBatch,
    Subgraph,
    batch_subgraphs,
)
from gcc_tpu_torch.graph.csr import CSRGraph
from gcc_tpu_torch.models import GraphEncoder
from gcc_tpu_torch.models.layers import MaskedBatchNorm, init_linear_
from gcc_tpu_torch.training.optim import build_optimizer
from gcc_tpu_torch.training.pretrain import optimizer_update


class ClassifierHead(nn.Module):
    def __init__(self, in_dim: int, num_classes: int):
        super().__init__()
        self.linear = nn.Linear(in_dim, num_classes)

    def reset_parameters(self, gen: torch.Generator | None) -> None:
        init_linear_(self.linear, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)


@dataclasses.dataclass
class FinetuneState:
    cfg: TrainConfig
    model: GraphEncoder
    head: ClassifierHead
    optimizer: torch.optim.Optimizer   # over the encoder and the head
    dropout_gen: torch.Generator
    total_steps: int
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.head.parameters()).device


@torch.no_grad()
def reset_batch_stats(model: nn.Module) -> None:
    """Zero running means, unit running variances — the reference's BN
    reset on finetune load — in every MaskedBatchNorm of ``model``."""
    for m in model.modules():
        if isinstance(m, MaskedBatchNorm):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


def create_finetune_state(cfg: TrainConfig, num_classes: int,
                          total_steps: int, pretrained: dict | None = None,
                          seed: int = 0, device="cuda") -> FinetuneState:
    """Encoder (torch-default init from a seeded generator, or the
    ``pretrained`` encoder state_dict with its BatchNorm statistics
    reset), a fresh head, and the optimizer with value clipping."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = GraphEncoder(cfg.encoder)
    model.reset_parameters(gen)
    head = ClassifierHead(cfg.encoder.output_size, num_classes)
    head.reset_parameters(gen)
    if pretrained is not None:
        model.load_state_dict(pretrained)
        reset_batch_stats(model)
    model.to(device)
    head.to(device)
    return FinetuneState(
        cfg=cfg, model=model, head=head,
        optimizer=build_optimizer(
            list(model.parameters()) + list(head.parameters()), cfg.optim),
        dropout_gen=torch.Generator(device=device).manual_seed(seed + 1),
        total_steps=total_steps)


def _featurize(state: FinetuneState, batch: PaddedSubgraphBatch):
    enc = state.cfg.encoder
    return featurize_batch(batch, enc.positional_embedding_size,
                           pe_method=enc.pe_method, profile="eval",
                           device=state.device, adj_dtype=enc.adj_dtype,
                           v_dtype=enc.jacobi_v_dtype, guards=enc.pe_guards)


def finetune_step(state: FinetuneState, batch: PaddedSubgraphBatch,
                  labels: torch.Tensor, example_mask: torch.Tensor
                  ) -> dict[str, torch.Tensor]:
    """One supervised step: masked mean NLL and accuracy over the real
    examples (``example_mask``), clip by value 1, decay + optimizer at
    the warmup-linear rate. Returns device scalars {loss, acc}."""
    feats = _featurize(state, batch)
    labels = labels.to(state.device)
    example_mask = example_mask.to(state.device)
    state.model.train()
    logits = state.head(state.model(feats, gen=state.dropout_gen))
    nll = -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    denom = torch.clamp_min(example_mask.sum(), 1.0)
    loss = (nll * example_mask).sum() / denom
    acc = ((logits.argmax(-1) == labels) * example_mask).sum() / denom
    optimizer_update(state, loss, clip_mode="value")
    state.step += 1
    return {"loss": loss.detach(), "acc": acc.detach()}


@torch.no_grad()
def finetune_predict(state: FinetuneState, batch: PaddedSubgraphBatch
                     ) -> torch.Tensor:
    """Class predictions (argmax) of the encoder in eval mode and the
    head; the encoder's mode is restored."""
    feats = _featurize(state, batch)
    was_training = state.model.training
    state.model.eval()
    try:
        return state.head(state.model(feats)).argmax(-1)
    finally:
        state.model.train(was_training)


def micro_f1(labels: np.ndarray, preds: np.ndarray) -> float:
    """Micro-averaged F1 of single-label predictions: every example adds
    one prediction and one label, so micro precision = micro recall =
    F1 = the share of correct predictions (sklearn's f1_score with
    average="micro", computed here: the card's machine has no sklearn)."""
    labels, preds = np.asarray(labels), np.asarray(preds)
    return float((labels == preds).mean()) if len(labels) else 0.0


class LabeledSubgraphData:
    """Labeled examples as (subgraph source, labels)."""

    labels: np.ndarray
    num_classes: int
    n_max: int
    e_max: int

    def subgraphs_for(self, idx: np.ndarray, epoch_seed: int
                      ) -> list[Subgraph]:
        raise NotImplementedError


class NodeLabeledData(LabeledSubgraphData):
    """Per-node RWR subgraphs, resampled every epoch
    (NodeClassificationDatasetLabeled); ``y`` one-hot (N, C)."""

    def __init__(self, graph: CSRGraph, y: np.ndarray, cfg: TrainConfig,
                 n_max: int, e_max: int):
        self.labels = y.argmax(axis=1).astype(np.int64)
        self.graph = graph
        self.cfg = cfg
        self.n_max = n_max
        self.e_max = e_max
        self.num_classes = y.shape[1]

    def subgraphs_for(self, idx, epoch_seed):
        from gcc_tpu_torch.sampling import native
        from gcc_tpu_torch.sampling.sampler import rwr_budgets

        budgets = rwr_budgets(self.graph, idx, self.cfg.sampler,
                              degree_power=False)
        out = native.sample_subgraphs(
            self.graph, idx, budgets,
            restart_prob=self.cfg.sampler.restart_prob,
            aug=self.cfg.sampler.aug, expand=self.cfg.sampler.num_neighbors,
            hops=self.cfg.sampler.rw_hops, rng_seed=epoch_seed,
            sample_ids=idx, node_cap=self.n_max, e_cap=self.e_max,
            n_threads=2,
        )
        return [Subgraph(src=out.src[i, :out.e[i]].copy(),
                         dst=out.dst[i, :out.e[i]].copy(),
                         num_nodes=int(out.n[i]), seed=0)
                for i in range(len(idx))]


class GraphLabeledData(LabeledSubgraphData):
    """Entire graphs, fixed (GraphClassificationDatasetLabeled)."""

    def __init__(self, graphs: list[CSRGraph], labels: np.ndarray,
                 n_max: int, e_max: int):
        from gcc_tpu_torch.sampling.sampler import entire_graph_subgraph

        self.labels = np.asarray(labels, np.int64)
        self.subs = [entire_graph_subgraph(g) for g in graphs]
        self.num_classes = int(self.labels.max()) + 1
        self.n_max = n_max
        self.e_max = e_max

    def subgraphs_for(self, idx, epoch_seed):
        return [self.subs[i] for i in idx]


def pad_batch(subs: list[Subgraph], bsz: int, n_max: int, e_max: int
              ) -> tuple[PaddedSubgraphBatch, np.ndarray]:
    """A batch of ``bsz`` (the last subgraph repeated) and its (bsz,)
    example mask."""
    mask = np.zeros(bsz, np.float32)
    mask[:len(subs)] = 1.0
    if len(subs) < bsz:
        subs = subs + [subs[-1]] * (bsz - len(subs))
    return batch_subgraphs(subs, n_max=n_max, e_max=e_max), mask


def run_finetune_fold(cfg: TrainConfig, data: LabeledSubgraphData,
                      train_idx: np.ndarray, test_idx: np.ndarray,
                      pretrained: dict | None = None, log_fn=print,
                      device="cuda") -> float:
    """Train one fold for ``cfg.epochs``; returns the test micro-F1
    (reference train.py:300-337). ``pretrained``: an encoder state_dict
    (a checkpoint's ``"model"``)."""
    n_max, e_max = data.n_max, data.e_max
    # Dense adjacency memory guard for big entire-graph buckets.
    bsz = _guarded_batch_size(cfg.batch_size, n_max)
    steps_per_epoch = max(1, int(np.ceil(len(train_idx) / bsz)))
    state = create_finetune_state(cfg, data.num_classes,
                                  steps_per_epoch * cfg.epochs, pretrained,
                                  seed=cfg.seed, device=device)
    rng = np.random.default_rng(cfg.seed)
    for epoch in range(cfg.epochs):
        order = rng.permutation(train_idx)
        losses = []
        for s in range(steps_per_epoch):
            idx = order[s * bsz:(s + 1) * bsz]
            batch, mask = pad_batch(
                data.subgraphs_for(idx, epoch_seed=1000 + epoch), bsz, n_max,
                e_max)
            labels = np.zeros(bsz, np.int64)
            labels[:len(idx)] = data.labels[idx]
            losses.append(finetune_step(state, batch, torch.from_numpy(labels),
                                        torch.from_numpy(mask))["loss"])
        log_fn(f"finetune epoch {epoch + 1}/{cfg.epochs}: loss "
               f"{torch.stack(losses).mean().item():.4f}")
    preds = []
    for s in range(0, len(test_idx), bsz):
        idx = test_idx[s:s + bsz]
        batch, _ = pad_batch(data.subgraphs_for(idx, epoch_seed=999_999), bsz,
                             n_max, e_max)
        preds.append(finetune_predict(state, batch)[:len(idx)])
    preds = torch.cat(preds).cpu().numpy() if preds else np.zeros(0, np.int64)
    return micro_f1(data.labels[test_idx], preds)


def stratified_kfold(labels: np.ndarray, n_splits: int, seed: int
                     ) -> list[tuple[np.ndarray, np.ndarray]]:
    """(train_idx, test_idx) of each fold, as scikit-learn's
    ``StratifiedKFold(n_splits, shuffle=True, random_state=seed).split``
    gives them (its algorithm since 0.22; the card's machine has no
    scikit-learn). Classes are numbered in order of first appearance;
    each class's fold sizes are dealt round robin over the sorted labels;
    each class's block of fold numbers is shuffled by one
    ``RandomState(seed)`` in class order."""
    _, first, inverse = np.unique(np.asarray(labels), return_index=True,
                                  return_inverse=True)
    _, by_appearance = np.unique(first, return_inverse=True)
    encoded = by_appearance[inverse.reshape(-1)]
    n_classes = len(first)
    if np.all(n_splits > np.bincount(encoded)):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the "
                         "number of members in each class.")
    ordered = np.sort(encoded)
    allocation = np.asarray([np.bincount(ordered[i::n_splits],
                                         minlength=n_classes)
                             for i in range(n_splits)])
    rng = np.random.RandomState(seed)
    test_folds = np.empty(len(encoded), dtype="i")
    for c in range(n_classes):
        folds = np.arange(n_splits).repeat(allocation[:, c])
        rng.shuffle(folds)
        test_folds[encoded == c] = folds
    idx = np.arange(len(encoded))
    return [(idx[test_folds != f], idx[test_folds == f])
            for f in range(n_splits)]


def run_finetune_cv(cfg: TrainConfig, data: LabeledSubgraphData,
                    pretrained: dict | None = None, folds=range(10),
                    log_fn=print, device="cuda") -> dict:
    """10-fold stratified cross-validation (reference train.py:800-815)."""
    idx_list = stratified_kfold(data.labels, 10, cfg.seed)
    scores = []
    for fold in folds:
        train_idx, test_idx = idx_list[fold]
        f1 = run_finetune_fold(cfg, data, train_idx, test_idx, pretrained,
                               log_fn, device=device)
        log_fn(f"fold {fold}: micro-F1 {f1:.4f}")
        scores.append(f1)
    return {"mean": float(np.mean(scores)), "std": float(np.std(scores)),
            "folds": scores}
