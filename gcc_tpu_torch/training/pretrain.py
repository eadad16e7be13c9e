"""Contrastive pre-training: state, train step and K-step dispatch.

Counterpart of ``gcc_tpu/training/pretrain.py``
(``create_pretrain_state``, ``make_step_from_feats``,
``featurize_stacked``) and of the K-step dispatch of
``gcc_tpu/training/packed.py``. Per MoCo step (reference
train.py:350-478):

1. the key encoder — EMA parameters, BatchNorm in train mode with its own
   running buffers, no gradient — encodes the key views;
2. the query encoder encodes the query views, the (B, 1+K) MoCo logits
   put the positive first, and the InfoNCE loss is backpropagated;
3. clip-by-global-norm, L2 decay, Adam at the warmup-linear rate;
4. after the optimizer step, EMA of the key encoder's parameters
   (α = 0.999), then the keys are enqueued.

Query and key views always run separate BatchNorm forwards. A dispatch
featurizes all K steps' graphs in one batched call (one launch of each
kernel per dispatch), then runs the K steps.

With ``ContrastConfig.moco`` False the step is the plain E2E objective:
both views through the one trained encoder (the key forward continues
from the query forward's BatchNorm buffers), (B, B) in-batch logits with
the positives on the diagonal; no EMA update and no enqueue. With
``use_softmax`` False the MoCo logits pass through the reference's
legacy NCE normalization, whose constant Z is estimated from the first
batch and kept in the state (``nce_z``). The size-split E2E step of the
reference (``ContrastConfig.e2e_split``) is not ported: a dispatch the
reference would split raises ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from gcc_tpu_torch.config import TrainConfig
from gcc_tpu_torch.contrastive import (
    MoCoQueue,
    e2e_logits,
    enqueue,
    init_queue,
    legacy_nce_probs,
    moco_logits,
    nce_softmax_loss,
)
from gcc_tpu_torch.device import resolve_device
from gcc_tpu_torch.features.featurize import BatchFeatures, featurize_compact
from gcc_tpu_torch.graph.batch import CompactWireBatch
from gcc_tpu_torch.models import GraphEncoder
from gcc_tpu_torch.training.optim import build_optimizer, clip_by_global_norm_
from gcc_tpu_torch.training.schedules import lr_at
from gcc_tpu_torch.wire import wire_to_device


@dataclasses.dataclass
class PretrainState:
    cfg: TrainConfig
    model: GraphEncoder       # query encoder (trained)
    ema_model: GraphEncoder   # key encoder: EMA params, own BN buffers
    optimizer: torch.optim.Adam
    queue: MoCoQueue
    dropout_gen: torch.Generator
    total_steps: int
    step: int = 0
    # Legacy non-softmax NCE normalizer Z, a device scalar: < 0 (the
    # start value, -1) means "not yet estimated"; set from the first
    # batch and frozen. Passes through unused when use_softmax is True.
    nce_z: torch.Tensor | None = None

    def __post_init__(self):
        if self.nce_z is None:
            self.nce_z = torch.full((), -1.0, dtype=torch.float32,
                                    device=self.device)

    @property
    def device(self) -> torch.device:
        return self.queue.memory.device


def create_pretrain_state(cfg: TrainConfig, total_steps: int, seed: int = 0,
                          device="cuda") -> PretrainState:
    """Initialize the query encoder (torch-default init from a seeded
    generator), the key encoder as its exact copy (reference
    moment_update(m=0), train.py:623-624), the queue and Adam."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = GraphEncoder(cfg.encoder)
    model.reset_parameters(gen)
    host_queue = init_queue(cfg.contrast.nce_k, cfg.encoder.output_size, gen,
                            device="cpu")
    model.to(device)
    ema = copy.deepcopy(model)
    ema.requires_grad_(False)
    queue = MoCoQueue(memory=host_queue.memory.to(device),
                      index=host_queue.index.to(device))
    return PretrainState(
        cfg=cfg, model=model, ema_model=ema,
        optimizer=build_optimizer(model.parameters(), cfg.optim),
        queue=queue,
        dropout_gen=torch.Generator(device=device).manual_seed(seed + 1),
        total_steps=total_steps,
    )


def parse_e2e_split(spec: str, batch_size: int, n_max: int | None):
    """Parse ContrastConfig.e2e_split ("n0:cap0,n1:cap1") into the full
    class list ((n0, cap0), ..., (n_max, B − Σcap)), or None when the
    spec is empty or inapplicable (Σcap ≥ B, buckets not ascending, or a
    bucket ≥ n_max — small configurations disable the split this way;
    ``gcc_tpu/training/pretrain.py:321-338``)."""
    if not spec or n_max is None:
        return None
    classes = []
    for part in spec.split(","):
        nb, cap = part.split(":")
        classes.append((int(nb), int(cap)))
    caps = sum(c for _, c in classes)
    buckets = [nb for nb, _ in classes]
    if (caps >= batch_size or any(c <= 0 for _, c in classes)
            or buckets != sorted(buckets) or len(set(buckets)) != len(buckets)
            or buckets[-1] >= n_max):
        return None
    return tuple(classes) + ((n_max, batch_size - caps),)


def train_step(state: PretrainState, feats_q: BatchFeatures,
               feats_k: BatchFeatures) -> dict[str, torch.Tensor]:
    """One step (MoCo or E2E, by ``cfg.contrast.moco``) on pre-featurized
    query/key views. Updates ``state`` in place; returns device scalars
    {loss, prob, grad_norm} (grad_norm before clipping)."""
    cfg = state.cfg
    moco = cfg.contrast.moco
    model, ema = state.model, state.ema_model
    model.train()
    if moco:
        ema.train()
        with torch.no_grad():
            k_emb = ema(feats_k, gen=state.dropout_gen)
        q_emb = model(feats_q, gen=state.dropout_gen)
        logits = moco_logits(state.queue, q_emb, k_emb, cfg.contrast.nce_t)
        labels = torch.zeros(logits.shape[0], dtype=torch.int64,
                             device=logits.device)
        if cfg.contrast.use_softmax:
            loss = nce_softmax_loss(logits, labels)
            prob = logits[:, 0].mean()
        else:
            # n_data: the reference's MemoryMoCo outputSize = samples per
            # epoch across workers (num_workers = 0 counts as one).
            n_data = cfg.num_samples * max(1, cfg.num_workers)
            probs, state.nce_z = legacy_nce_probs(logits, n_data, state.nce_z)
            loss = nce_softmax_loss(probs, labels)
            prob = probs[:, 0].mean()
    else:
        q_emb = model(feats_q, gen=state.dropout_gen)
        k_emb = model(feats_k, gen=state.dropout_gen)
        logits = e2e_logits(q_emb, k_emb, cfg.contrast.nce_t)
        labels = torch.arange(logits.shape[0], device=logits.device)
        loss = nce_softmax_loss(logits, labels)
        prob = torch.diagonal(logits).mean()
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    params = list(model.parameters())
    grad_norm = clip_by_global_norm_(params, cfg.optim.clip_norm)
    lr = lr_at(state.step, cfg.optim.learning_rate, state.total_steps,
               cfg.optim.warmup)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    if moco:
        with torch.no_grad():
            alpha = cfg.contrast.alpha
            ema_params = list(ema.parameters())
            torch._foreach_mul_(ema_params, alpha)
            torch._foreach_add_(ema_params, params, alpha=1.0 - alpha)
        enqueue(state.queue, k_emb)
    state.step += 1
    return {"loss": loss.detach(), "prob": prob.detach(),
            "grad_norm": grad_norm}


def featurize_stacked(wires_q: CompactWireBatch, wires_k: CompactWireBatch,
                      pos_size: int, n_max: int | None = None,
                      device="cuda", pe_method: str = "subspace"
                      ) -> BatchFeatures:
    """Featurize a K-step dispatch — (K, E_tot) edges / (K, 3, B) meta per
    view, or one unstacked step — in one batched call. Returns
    BatchFeatures with (K, 2·B, ...) fields: per step, [:B] is the query
    half and [B:] the key half (pretrain.py:290-318)."""
    device = resolve_device(device)
    n_max = wires_q.n_max or n_max
    if n_max is None:
        raise ValueError("n_max required to featurize an unrouted wire batch")
    eq, mq = wire_to_device(wires_q, device)
    ek, mk = wire_to_device(wires_k, device)
    if mq.dim() == 2:
        eq, mq, ek, mk = eq[None], mq[None], ek[None], mk[None]
    k_steps, _, bsz = mq.shape
    e_tot = eq.shape[-1]
    # Segment order q0, k0, q1, k1, ... is graph order (step 0 queries,
    # step 0 keys, step 1 queries, ...), so the (K, 2B) split is a view.
    edges = torch.stack([eq, ek], dim=1).reshape(2 * k_steps, e_tot)
    meta = torch.stack([mq, mk], dim=1).reshape(2 * k_steps, 3, bsz)
    feats = featurize_compact(edges, meta, n_max, wires_q.id_bits, pos_size,
                              pe_method=pe_method)
    return feats.map(lambda x: x.reshape((k_steps, 2 * bsz) + x.shape[1:]))


def train_dispatch(state: PretrainState, wires_q: CompactWireBatch,
                   wires_k: CompactWireBatch, n_max: int | None = None
                   ) -> dict[str, torch.Tensor]:
    """K train steps over one stacked dispatch item (the port's
    counterpart of make_packed_multi_step): featurize all K steps once,
    then step through them. Returns (K,) device tensors per metric."""
    contrast = state.cfg.contrast
    if not contrast.moco and np.ndim(wires_q.meta) == 3 and parse_e2e_split(
            contrast.e2e_split, np.shape(wires_q.meta)[-1],
            wires_q.n_max or n_max):
        raise NotImplementedError(
            f"E2E with e2e_split={contrast.e2e_split!r} at batch "
            f"{np.shape(wires_q.meta)[-1]}, bucket {wires_q.n_max or n_max}: "
            "the size-split E2E step is not ported yet; set "
            "ContrastConfig.e2e_split='' for the plain E2E step")
    feats = featurize_stacked(wires_q, wires_k,
                              state.cfg.encoder.positional_embedding_size,
                              n_max=n_max, device=state.device,
                              pe_method=state.cfg.encoder.pe_method)
    bsz = feats.node_mask.shape[1] // 2
    per_step = []
    for t in range(feats.node_mask.shape[0]):
        f = feats.map(lambda x: x[t])
        per_step.append(train_step(state, f.map(lambda x: x[:bsz]),
                                   f.map(lambda x: x[bsz:])))
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}
