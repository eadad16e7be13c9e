"""Plain GCC pre-training steps (reference train.py:350-478), MoCo and
E2E, followed for a few steps from given weights and features.

Per step: the key encoder (MoCo: EMA weights, its own BatchNorm buffers,
no gradient) encodes the key views, the query encoder the query views;
MoCo logits are [q·k, q·queue] / T with the positive first, E2E logits
k qᵀ / T with positives on the diagonal; softmax cross-entropy. Then the
gradient's global norm is clipped at ``clip_norm``, L2 decay is added to
it, and Adam (bias-corrected, eps 1e-8) steps at the warmup-linear rate
lr · min(t / (w·T), (T - t) / (T - w·T)) of update t = 0, 1, ... (update
0 at rate 0). MoCo then moves the key encoder's weights to
α·key + (1 - α)·query and writes the keys into the queue ring.

A step's views come as lists of feature groups; each group is one
BatchNorm forward (the E2E size split encodes each size class of each
view on its own, query classes first).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.encoder import encode
from benchmark.reference.precision import matmul


def lr_at(t: int, cfg: dict) -> float:
    progress = t / cfg["total_steps"]
    w = cfg["warmup"]
    frac = progress / w if progress < w else max((progress - 1.0) / (w - 1.0),
                                                 0.0)
    return cfg["learning_rate"] * frac


def _encode_groups(p, buffers, groups, cfg, training, gen, prec):
    return torch.cat([encode(p, buffers, *g, cfg=cfg, training=training,
                             gen=gen, prec=prec) for g in groups])


def follow(params: dict, buffers: dict, queue: torch.Tensor | None,
           steps: list, cfg: dict, dropout_seed: int, prec: str = "f32"):
    """Follow ``len(steps)`` steps. steps[t] = (query groups, key groups),
    a group being (pos, degrees, seed_flag, node_mask, adj). Returns a
    dict: losses (per step), grad0 (the first step's gradient as Adam
    takes it, per leaf: clipped, plus the L2 decay), params (after the
    steps), keys (MoCo: the keys enqueued, in order)."""
    device = next(iter(params.values())).device
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    ema = {k: v.detach().clone() for k, v in params.items()}
    buf_q = {k: v.clone() for k, v in buffers.items()}
    buf_k = {k: v.clone() for k, v in buffers.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = cfg["beta1"], cfg["beta2"], 1e-8
    moco = cfg["moco"]
    if moco:
        queue = queue.clone()
        index = 0
    out = {"losses": [], "keys": []}
    for t, (q_groups, k_groups) in enumerate(steps):
        if moco:
            with torch.no_grad():
                k_emb = _encode_groups(ema, buf_k, k_groups, cfg, True, gen,
                                       prec)
            q_emb = _encode_groups(p, buf_q, q_groups, cfg, True, gen, prec)
            l_pos = torch.sum(q_emb * k_emb, dim=-1, keepdim=True)
            l_neg = matmul(q_emb, queue.t(), prec)
            logits = torch.cat([l_pos, l_neg], dim=1) / cfg["nce_t"]
            labels = torch.zeros(logits.shape[0], dtype=torch.int64,
                                 device=device)
        else:
            q_emb = _encode_groups(p, buf_q, q_groups, cfg, True, gen, prec)
            k_emb = _encode_groups(p, buf_q, k_groups, cfg, True, gen, prec)
            logits = matmul(k_emb, q_emb.t(), prec) / cfg["nce_t"]
            labels = torch.arange(logits.shape[0], device=device)
        loss = F.cross_entropy(logits, labels)
        grads = torch.autograd.grad(loss, list(p.values()))
        out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.linalg.vector_norm(
                torch.cat([g.reshape(-1) for g in grads]))
            scale = 1.0 if norm < cfg["clip_norm"] else \
                cfg["clip_norm"] / norm
            lr = lr_at(t, cfg)
            step = t + 1
            g_eff = {}
            for (name, w), g in zip(p.items(), grads):
                g = g * scale + cfg["weight_decay"] * w
                g_eff[name] = g
                m[name] = b1 * m[name] + (1 - b1) * g
                v2[name] = b2 * v2[name] + (1 - b2) * g * g
                denom = (v2[name].sqrt() / (1 - b2 ** step) ** 0.5) + eps
                w -= lr / (1 - b1 ** step) * m[name] / denom
            if t == 0:
                out["grad0"] = {k: g.detach().clone() for k, g in
                                g_eff.items()}
            if moco:
                a = cfg["alpha"]
                for name in ema:
                    ema[name] = a * ema[name] + (1 - a) * p[name]
                b = k_emb.shape[0]
                rows = (index + torch.arange(b, device=device)) % \
                    queue.shape[0]
                queue[rows] = k_emb
                index = (index + b) % queue.shape[0]
                out["keys"].append(k_emb.detach().clone())
    out["params"] = {k: v.detach() for k, v in p.items()}
    return out
