"""Initial weights made on the device from the seed, in a few large draws.

The encoder's tensors are named as the program's encoder names them in its
state dict; the benchmark loads them there and hands the same tensors to
the reference. Linear layers: U(±1/sqrt(fan_in)) for weight and bias (the
PyTorch default GCC trains from); the degree embedding N(0, 1); BatchNorm
affine 1 and 0; BatchNorm running statistics (read in eval mode) mean
N(0, 0.1²), variance U(0.5, 2). The MoCo queue: U(±sqrt(3/dim)) (GCC's
memory_moco.py).
"""

from __future__ import annotations

import math

import torch


def _kind(name: str) -> str:
    if name.endswith("running_mean") or name.endswith("running_var"):
        return "stat"
    if name.endswith("num_batches_tracked"):
        return "skip"
    if name.startswith("degree_embedding"):
        return "embedding"
    if ".bn." in name or ".norms." in name:
        return "affine"
    return "linear"


def make_encoder_tensors(shapes: dict, gen: torch.Generator,
                         device) -> dict:
    """{name: tensor} for every entry of ``shapes`` (name -> shape, in
    state-dict order)."""
    out = {}
    lin = [(n, s) for n, s in shapes.items() if _kind(n) == "linear"]
    total = sum(math.prod(s) for _, s in lin)
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0,
                                                      generator=gen)
    fan_in = {}
    for n, s in lin:
        if n.endswith(".weight"):
            fan_in[n[:-len(".weight")]] = s[1]
    off = 0
    for n, s in lin:
        size = math.prod(s)
        layer = n.rsplit(".", 1)[0]
        bound = 1.0 / math.sqrt(fan_in[layer])
        out[n] = (flat[off:off + size] * bound).view(s)
        off += size
    emb = [(n, s) for n, s in shapes.items() if _kind(n) == "embedding"]
    for n, s in emb:
        out[n] = torch.empty(s, device=device).normal_(0.0, 1.0,
                                                       generator=gen)
    stats = [(n, s) for n, s in shapes.items() if _kind(n) == "stat"]
    total = sum(math.prod(s) for _, s in stats)
    flat = torch.empty(total, device=device).uniform_(0.0, 1.0,
                                                      generator=gen)
    off = 0
    for n, s in stats:
        size = math.prod(s)
        u = flat[off:off + size].view(s)
        out[n] = (0.5 + 1.5 * u) if n.endswith("var") else (u - 0.5) * 0.2
        off += size
    for n, s in shapes.items():
        kind = _kind(n)
        if kind == "affine":
            fill = 1.0 if n.endswith(".weight") else 0.0
            out[n] = torch.full(s, fill, device=device)
        elif kind == "skip":
            out[n] = torch.zeros(s, dtype=torch.int64, device=device)
    return {n: out[n].contiguous() for n in shapes}


def make_queue(k: int, dim: int, gen: torch.Generator, device):
    stdv = 1.0 / math.sqrt(dim / 3.0)
    return torch.empty((k, dim), device=device).uniform_(-stdv, stdv,
                                                         generator=gen)


def split(tensors: dict, module) -> tuple[dict, dict]:
    """(parameters, buffers) of ``tensors`` by the module's own split."""
    params = {n for n, _ in module.named_parameters()}
    return ({n: t for n, t in tensors.items() if n in params},
            {n: t for n, t in tensors.items() if n not in params
             and not n.endswith("num_batches_tracked")})
