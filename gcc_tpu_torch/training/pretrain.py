"""Contrastive pre-training: state, train step and K-step dispatch.

Counterpart of ``gcc_tpu/training/pretrain.py``
(``create_pretrain_state``, ``make_step_from_feats``,
``featurize_pair``, ``featurize_stacked``) and of the K-step dispatch of
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
batch and kept in the state (``nce_z``).

Where ``ContrastConfig.e2e_split`` applies to an E2E dispatch (stacked
compact wire, a spec whose classes fit the batch and the bucket), the
dispatch is size-split as the reference splits it
(``gcc_tpu/training/pretrain.py:321-540``): :func:`featurize_e2e_split`
slots each step's pairs into ascending node buckets, one featurize per
bucket, and :func:`e2e_split_step` encodes each view's bucket in its own
BatchNorm forward before the in-batch loss on the concatenated
embeddings.

On the card, outside a data-parallel step, both steps replay CUDA graphs
of their encoder calls (``models/step_graphs.py``): the loss, the clip,
Adam, the EMA and the enqueue stay eager, with every hook they fire.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from gcc_tpu_torch.config import TrainConfig
from gcc_tpu_torch.contrastive import (
    MoCoQueue,
    batch_mean,
    enqueue,
    in_batch_loss,
    init_queue,
    legacy_nce_probs,
    moco_logits,
    nce_softmax_loss,
)
from gcc_tpu_torch.device import resolve_device
from gcc_tpu_torch.features.featurize import (
    BatchFeatures,
    featurize_batch,
    featurize_compact,
)
from gcc_tpu_torch.features.positional import laplacian_positional_embedding
from gcc_tpu_torch.graph.batch import (
    CompactWireBatch,
    WireBatch,
    concat_padded,
    expand_wire,
)
from gcc_tpu_torch.models import GraphEncoder, step_graphs
from gcc_tpu_torch.ops.aggregate import node_degrees
from gcc_tpu_torch.parallel import data_parallel
from gcc_tpu_torch.training.optim import build_optimizer, clip_gradients_
from gcc_tpu_torch.training.schedules import lr_at
from gcc_tpu_torch.utils.profiling import span
from gcc_tpu_torch.wire import wire_to_device


@dataclasses.dataclass
class PretrainState:
    cfg: TrainConfig
    model: GraphEncoder       # query encoder (trained)
    ema_model: GraphEncoder   # key encoder: EMA params, own BN buffers
    optimizer: torch.optim.Optimizer
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
    with span("gcc.train.step"), step_graphs.stepping():
        model.train()
        with span("gcc.train.forward"):
            if moco:
                ema.train()
                with torch.no_grad():
                    k_emb = ema(feats_k, gen=state.dropout_gen)
                q_emb = model(feats_q, gen=state.dropout_gen)
                logits = moco_logits(state.queue, q_emb, k_emb,
                                     cfg.contrast.nce_t)
                labels = torch.zeros(logits.shape[0], dtype=torch.int64,
                                     device=logits.device)
                if cfg.contrast.use_softmax:
                    loss = nce_softmax_loss(logits, labels)
                    prob = batch_mean(logits[:, 0])
                else:
                    # n_data: the reference's MemoryMoCo outputSize =
                    # samples per epoch across workers (num_workers = 0
                    # counts as one).
                    n_data = cfg.num_samples * max(1, cfg.num_workers)
                    probs, state.nce_z = legacy_nce_probs(logits, n_data,
                                                          state.nce_z)
                    loss = nce_softmax_loss(probs, labels)
                    prob = batch_mean(probs[:, 0])
            else:
                q_emb = model(feats_q, gen=state.dropout_gen)
                k_emb = model(feats_k, gen=state.dropout_gen)
                loss, prob = in_batch_loss(q_emb, k_emb, cfg.contrast.nce_t)
        grad_norm = optimizer_update(state, loss)
        if moco:
            with span("gcc.train.momentum"), torch.no_grad():
                alpha = cfg.contrast.alpha
                ema_params = list(ema.parameters())
                torch._foreach_mul_(ema_params, alpha)
                torch._foreach_add_(ema_params, list(model.parameters()),
                                    alpha=1.0 - alpha)
                enqueue(state.queue, k_emb)
        state.step += 1
        return _metrics(loss, prob, grad_norm)


def _metrics(loss: torch.Tensor, prob: torch.Tensor,
             grad_norm: torch.Tensor) -> dict[str, torch.Tensor]:
    """A step's metrics; inside a data-parallel step the ranks' shares
    of the loss and the positive logit are summed (one all-reduce), so
    every rank reports the global batch's."""
    pair = torch.stack([loss.detach(), prob.detach()])
    dp = data_parallel.current()
    if dp is not None:
        pair = data_parallel.all_reduce_sum(pair, dp.group)
    return {"loss": pair[0], "prob": pair[1], "grad_norm": grad_norm}


def optimizer_update(state, loss: torch.Tensor,
                     clip_mode: str = "norm") -> torch.Tensor:
    """Backpropagate ``loss`` into ``state.model`` (and a finetune
    state's head), then the chain: clip, L2 decay + optimizer at the
    warmup-linear rate of update ``state.step``. Returns the gradient's
    global norm before clipping (a device scalar)."""
    cfg = state.cfg
    with span("gcc.train.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with span("gcc.train.optimizer"):
        params = [p for group in state.optimizer.param_groups
                  for p in group["params"]]
        grad_norm = clip_gradients_(params, cfg.optim, clip_mode)
        lr = lr_at(state.step, cfg.optim.learning_rate, state.total_steps,
                   cfg.optim.warmup)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
    return grad_norm


def featurize_stacked(wires_q: CompactWireBatch, wires_k: CompactWireBatch,
                      pos_size: int, n_max: int | None = None,
                      device="cuda", pe_method: str = "subspace",
                      adj_dtype=torch.float32, v_dtype=torch.float32,
                      guards=None) -> BatchFeatures:
    """Featurize a K-step dispatch — (K, E_tot) edges / (K, 3, B) meta per
    view, or one unstacked step — in one batched call. Returns
    BatchFeatures with (K, 2·B, ...) fields: per step, [:B] is the query
    half and [B:] the key half (pretrain.py:290-318). ``guards``:
    ``EncoderConfig.pe_guards``, as in every featurize function here."""
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
                              pe_method=pe_method, adj_dtype=adj_dtype,
                              v_dtype=v_dtype, guards=guards)
    return feats.map(lambda x: x.reshape((k_steps, 2 * bsz) + x.shape[1:]))


def featurize_stacked_dp(wires_q: CompactWireBatch,
                         wires_k: CompactWireBatch, pos_size: int,
                         n_max: int | None = None, device="cuda",
                         pe_method: str = "subspace", adj_dtype=torch.float32,
                         v_dtype=torch.float32, guards=None
                         ) -> BatchFeatures:
    """Featurize a DP-stacked dispatch — (K, D, e_dev) edges / (K, D, 3,
    b) meta (``PipelineConfig.devices``; on a rank, its slice of the
    device axis) — in one batched call (``pretrain.py:543-579``).

    Returns BatchFeatures with (K, D·2·b, ...) fields, inner order
    (device, {query, key}, graph): split a step with
    :func:`split_feats_qk_dp`. The reference routes this past its fused
    featurize kernel (a vmapped ``pallas_call`` it does not validate);
    here ``featurize_compact`` computes the same function as for any
    stacked wire, Kernel 1 included."""
    device = resolve_device(device)
    n_max = wires_q.n_max or n_max
    if n_max is None:
        raise ValueError("n_max required to featurize an unrouted wire batch")
    eq, mq = wire_to_device(wires_q, device)
    ek, mk = wire_to_device(wires_k, device)
    k_steps, d, _, b = mq.shape
    e_dev = eq.shape[-1]
    # Segments in (step, device, {q, k}) order, b graphs each: the merge
    # keeps every device's graphs together.
    edges = torch.stack([eq, ek], dim=2).reshape(k_steps * d * 2, e_dev)
    meta = torch.stack([mq, mk], dim=2).reshape(k_steps * d * 2, 3, b)
    feats = featurize_compact(edges, meta, n_max, wires_q.id_bits, pos_size,
                              pe_method=pe_method, adj_dtype=adj_dtype,
                              v_dtype=v_dtype, guards=guards)
    return feats.map(lambda x: x.reshape((k_steps, d * 2 * b) + x.shape[1:]))


def split_feats_qk_dp(feats: BatchFeatures, d: int, b: int):
    """One step's (D·2·b, ...) features → the (D·b, ...) query and key
    halves, graphs in (device, graph) order (``pretrain.py:582-594``)."""
    def take(x, v):
        return x.reshape((d, 2, b) + x.shape[1:])[:, v].reshape(
            (d * b,) + x.shape[1:])

    return (feats.map(lambda x: take(x, 0)), feats.map(lambda x: take(x, 1)))


def featurize_pair(wire_q: WireBatch, wire_k: WireBatch, pos_size: int,
                   n_max: int, device="cuda", pe_method: str = "subspace",
                   adj_dtype=torch.float32, v_dtype=torch.float32,
                   guards=None) -> tuple[BatchFeatures, BatchFeatures]:
    """Featurize one step's padded query and key views (the
    ``compact_wire=False`` pipeline's ``WireBatch`` pair) in one call
    (``gcc_tpu/training/pretrain.py:597-616``): both expanded with
    ``n_max``, concatenated, one ``featurize_batch`` at the train
    profile. Returns (feats_q, feats_k) with (B, ...) fields."""
    if n_max is None:
        raise ValueError("n_max required to expand a WireBatch")
    f = featurize_batch(concat_padded(expand_wire(wire_q, n_max),
                                      expand_wire(wire_k, n_max)),
                        pos_size, pe_method=pe_method, profile="train",
                        device=device, adj_dtype=adj_dtype, v_dtype=v_dtype,
                        guards=guards)
    bsz = f.node_mask.shape[0] // 2
    return f.map(lambda x: x[:bsz]), f.map(lambda x: x[bsz:])


_DUMP_SLOTS = 1024


def e2e_split_slots(n_q: torch.Tensor, n_k: torch.Tensor, classes):
    """Slotting of the size split (``gcc_tpu/training/pretrain.py:395-
    410``): a pair's class is the first bucket that holds BOTH views
    (the larger of n_q, n_k); a stable sort by class gives the slot
    order, the first cap_0 slots going to bucket 0, the next cap_1 to
    bucket 1, and so on. Returns (order, rank, overflow): (K, B) slot →
    pair, (K, B) pair → slot, and (K,) int32 — the most pairs any class
    boundary has beyond the slots above it (those are forced into a
    smaller bucket, and their edges outside it are dropped)."""
    mx = torch.maximum(n_q, n_k)
    cls = torch.zeros_like(mx)
    for n_b, _ in classes[:-1]:
        cls = cls + (mx > n_b).to(mx.dtype)
    order = torch.argsort(cls, dim=1, stable=True)
    rank = torch.argsort(order, dim=1)
    b = mx.shape[1]
    overflow = torch.zeros(mx.shape[0], dtype=torch.int32, device=mx.device)
    above = b
    for k in range(1, len(classes)):
        above -= classes[k - 1][1]
        over = (cls >= k).sum(dim=1).to(torch.int32) - above
        overflow = torch.maximum(overflow, torch.clamp_min(over, 0))
    return order, rank, overflow


def featurize_e2e_split(wires_q: CompactWireBatch, wires_k: CompactWireBatch,
                        pos_size: int, pe_method: str, classes,
                        n_max: int | None = None, device="cuda",
                        v_dtype=torch.float32, guards=None):
    """Size-routed featurization of a stacked E2E dispatch
    (``gcc_tpu/training/pretrain.py:342-470``). Per step the pairs are
    slotted by :func:`e2e_split_slots` into the ascending ``classes``
    ((n_0, cap_0), ..., (n_max, cap_last)); each class's adjacency is one
    flat scatter-add over both views' packed edges, routed by slot rank,
    dropping edges outside the class's bucket, and its PE is one
    train-profile call (on the card: one launch each of Kernels 2 and 3).

    The adjacency is f32 whatever ``EncoderConfig.adj_dtype`` says, as the
    reference's split builds it (``pretrain.py:424``); ``v_dtype`` reaches
    its Jacobi finishes.

    Returns (feats_tuple, overflow): one BatchFeatures per class with
    (K, 2·cap, ...) leaves — per step [:cap] the query views, [cap:] the
    key views — and overflow (K,) int32."""
    device = resolve_device(device)
    n_max = wires_q.n_max or n_max
    if n_max is None:
        raise ValueError("n_max required to featurize an unrouted wire batch")
    eq, mq = wire_to_device(wires_q, device)
    ek, mk = wire_to_device(wires_k, device)
    k_steps, _, b = mq.shape
    if sum(c for _, c in classes) != b:
        raise ValueError(f"classes {classes} do not fill a batch of {b}")
    order, rank, overflow = e2e_split_slots(mq[:, 0], mk[:, 0], classes)
    mask_bits = (1 << wires_q.id_bits) - 1
    e_tot = eq.shape[-1]
    e_iota = torch.arange(e_tot, device=device, dtype=torch.int64)
    t_iota = torch.arange(k_steps, device=device, dtype=torch.int64)
    # Per side: every edge's graph (its slot rank), ids, and liveness.
    sides = []
    for edges, meta in ((eq, mq), (ek, mk)):
        cum = torch.cumsum(meta[:, 1].to(torch.int64), dim=1)
        gid = torch.searchsorted(cum, e_iota.expand(k_steps, e_tot)
                                 .contiguous(), right=True).clamp_(max=b - 1)
        packed = edges.to(torch.int64)
        sides.append((torch.gather(rank, 1, gid),
                      packed & mask_bits, (packed >> wires_q.id_bits)
                      & mask_bits, e_iota[None, :] < cum[:, -1:]))

    out = []
    lo = 0
    for n_b, c_b in classes:
        hi = lo + c_b
        sel = order[:, lo:hi]
        n_nodes = torch.cat([torch.gather(mq[:, 0], 1, sel),
                             torch.gather(mk[:, 0], 1, sel)], dim=1)
        seed = torch.cat([torch.gather(mq[:, 2], 1, sel),
                          torch.gather(mk[:, 2], 1, sel)], dim=1)
        iota_n = torch.arange(n_b, device=device, dtype=n_nodes.dtype)
        node_mask = (iota_n < n_nodes[..., None]).to(torch.float32)
        seed_flag = (iota_n == seed[..., None]).to(torch.float32) * node_mask
        rows = k_steps * 2 * c_b
        # Dropped edges land in a dump past the end, sliced off; spread
        # over _DUMP_SLOTS addresses so their atomic adds do not queue on
        # one.
        dump = rows * n_b * n_b
        flat = torch.zeros(dump + _DUMP_SLOTS, dtype=torch.float32,
                           device=device)
        for side, (r, src, dst, live) in enumerate(sides):
            keep = live & (r >= lo) & (r < hi) & (src < n_b) & (dst < n_b)
            row = t_iota[:, None] * (2 * c_b) + side * c_b + (r - lo)
            tgt = torch.where(keep, row * (n_b * n_b) + dst * n_b + src,
                              dump + e_iota % _DUMP_SLOTS)
            flat.index_add_(0, tgt.reshape(-1),
                            torch.ones(tgt.numel(), dtype=torch.float32,
                                       device=device))
        adj = flat[:dump].view(rows, n_b, n_b)
        nm_flat = node_mask.reshape(rows, n_b)
        pos = laplacian_positional_embedding(
            nm_flat, n_nodes.reshape(rows), pos_size, adj=adj,
            method=pe_method, profile="train", v_dtype=v_dtype,
            guards=guards)
        deg = node_degrees(adj).to(torch.int32)
        shape = lambda x: x.reshape((k_steps, 2 * c_b) + x.shape[1:])  # noqa: E731
        out.append(BatchFeatures(pos=shape(pos), degrees=shape(deg),
                                 seed_flag=seed_flag, node_mask=node_mask,
                                 adj=shape(adj)))
        lo = hi
    return tuple(out), overflow


def e2e_split_step(state: PretrainState, feats_tuple
                   ) -> dict[str, torch.Tensor]:
    """One E2E step over size-split features (one step's slice of
    :func:`featurize_e2e_split`; ``make_e2e_split_step``): 2·n_cls
    sub-forwards, all query classes then all key classes — q and k rows
    never share a BatchNorm forward — with the running buffers threaded
    through them in that order and one dropout draw each; the in-batch
    loss on the concatenated embeddings; the same update as
    :func:`train_step`."""
    model = state.model
    with span("gcc.train.step"), step_graphs.stepping():
        model.train()
        embs = ([], [])
        with span("gcc.train.forward"):
            for view in (0, 1):
                for f in feats_tuple:
                    c = f.node_mask.shape[0] // 2
                    embs[view].append(model(
                        f.map(lambda x: x[view * c:(view + 1) * c]),
                        gen=state.dropout_gen))
            loss, prob = in_batch_loss(torch.cat(embs[0]), torch.cat(embs[1]),
                                       state.cfg.contrast.nce_t)
        grad_norm = optimizer_update(state, loss)
        state.step += 1
        return _metrics(loss, prob, grad_norm)


def _stack_metrics(per_step: list[dict]) -> dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def train_dispatch(state: PretrainState, wires_q, wires_k,
                   n_max: int | None = None) -> dict[str, torch.Tensor]:
    """K train steps over one stacked dispatch item (the port's
    counterpart of make_packed_multi_step): featurize all K steps once,
    then step through them. Returns (K,) device tensors per metric. An
    E2E dispatch on a stacked wire whose batch and bucket the
    ``e2e_split`` spec applies to takes the size split and also returns
    ``e2e_split_overflow``. A padded ``WireBatch`` pair is one step
    through :func:`featurize_pair`. A DP-stacked wire (a device axis,
    4-dim meta) is featurized by :func:`featurize_stacked_dp` and its
    steps run on the D·b graphs of each step; inside a
    ``data_parallel`` context the wire is this rank's slice and the steps
    are those of the global batch."""
    with span("gcc.train.dispatch"):
        return _dispatch(state, wires_q, wires_k, n_max)


def _dispatch(state: PretrainState, wires_q, wires_k, n_max):
    cfg = state.cfg
    contrast = cfg.contrast
    enc = cfg.encoder
    levers = dict(adj_dtype=enc.adj_dtype, v_dtype=enc.jacobi_v_dtype,
                  guards=enc.pe_guards)
    if isinstance(wires_q, WireBatch):
        with span("gcc.train.featurize"):
            feats_q, feats_k = featurize_pair(
                wires_q, wires_k, cfg.encoder.positional_embedding_size,
                n_max=n_max, device=state.device,
                pe_method=cfg.encoder.pe_method, **levers)
        return _stack_metrics([train_step(state, feats_q, feats_k)])
    if np.ndim(wires_q.meta) == 4:
        # DP-stacked wire ((K, D, ...), packed.py:142-163): the steps of
        # the global batch in (device, graph) order; inside a
        # data_parallel context this rank's slice of it. The E2E size
        # split needs a 3-dim meta and does not apply, as in the
        # reference.
        d, b = wires_q.meta.shape[1], wires_q.meta.shape[3]
        with span("gcc.train.featurize"):
            feats = featurize_stacked_dp(
                wires_q, wires_k, cfg.encoder.positional_embedding_size,
                n_max=n_max, device=state.device,
                pe_method=cfg.encoder.pe_method, **levers)
        return _stack_metrics([
            train_step(state, *split_feats_qk_dp(feats.map(
                lambda x, t=t: x[t]), d, b))
            for t in range(feats.node_mask.shape[0])])
    classes = None
    if not contrast.moco and contrast.e2e_split and np.ndim(wires_q.meta) == 3:
        classes = parse_e2e_split(contrast.e2e_split,
                                  np.shape(wires_q.meta)[-1],
                                  wires_q.n_max or n_max)
    if classes:
        with span("gcc.train.featurize"):
            feats, overflow = featurize_e2e_split(
                wires_q, wires_k, cfg.encoder.positional_embedding_size,
                cfg.encoder.pe_method, classes, n_max=n_max,
                device=state.device, v_dtype=enc.jacobi_v_dtype,
                guards=enc.pe_guards)
        metrics = _stack_metrics([
            e2e_split_step(state, tuple(f.map(lambda x: x[t]) for f in feats))
            for t in range(overflow.shape[0])])
        metrics["e2e_split_overflow"] = overflow
        return metrics
    with span("gcc.train.featurize"):
        feats = featurize_stacked(wires_q, wires_k,
                                  cfg.encoder.positional_embedding_size,
                                  n_max=n_max, device=state.device,
                                  pe_method=cfg.encoder.pe_method, **levers)
    bsz = feats.node_mask.shape[1] // 2
    per_step = []
    for t in range(feats.node_mask.shape[0]):
        f = feats.map(lambda x: x[t])
        per_step.append(train_step(state, f.map(lambda x: x[:bsz]),
                                   f.map(lambda x: x[bsz:])))
    return _stack_metrics(per_step)
