"""Initial weights made on the device from the seed, in a few large draws.

The encoder's tensors are named as the program's encoder names them in its
state dict; the benchmark loads them there and hands the same tensors to
the reference. Each is drawn by the rule the program initialises it by
(PyTorch's defaults, which GCC trains from):

- uniform U(±bound), all in one draw in state-dict order: a linear
  layer's weight and bias, bound 1/sqrt(fan_in), bias-less layers too;
  a recurrent cell's ``weight_ih``, ``weight_hh``, ``bias_ih``,
  ``bias_hh``, ``bias_hn``, bound 1/sqrt(hidden); GAT's ``attn_l`` and
  ``attn_r`` (heads, F), bound 1/sqrt(heads); a parameter the model's
  reference module gives a bound by ``init_bound(name, shape, shapes)``;
- the degree embedding N(0, 1);
- a norm's affine (a BatchNorm's, or a 1-D ``weight`` and its ``bias``) 1
  and 0;
- BatchNorm running statistics (read in eval mode): mean U(-0.1, 0.1),
  variance U(0.5, 2).

The MoCo queue: U(±sqrt(3/dim)) (GCC's memory_moco.py).
"""

from __future__ import annotations

import math
import re

import torch

from benchmark.reference.encoder import DEFAULT_MODEL, model_module

RECURRENT = re.compile(r"(weight|bias)_(ih|hh|hn)(_l\d+(_reverse)?)?")


def _kind(name: str, shapes: dict) -> str:
    module, _, leaf = name.rpartition(".")
    if leaf in ("running_mean", "running_var"):
        return "stat"
    if leaf == "num_batches_tracked":
        return "skip"
    if name.startswith("degree_embedding"):
        return "embedding"
    weight = shapes.get(f"{module}.weight")
    if leaf in ("weight", "bias") and (f"{module}.running_mean" in shapes
                                       or (weight is not None
                                           and len(weight) == 1)):
        return "affine"
    return "uniform"


def _bound(name: str, shape: tuple, shapes: dict, init_bound) -> float:
    """The uniform bound of parameter ``name`` (see the module docstring)."""
    if init_bound is not None:
        bound = init_bound(name, shape, shapes)
        if bound is not None:
            return bound
    module, _, leaf = name.rpartition(".")
    cell = RECURRENT.fullmatch(leaf)
    if cell:
        hidden = shapes[f"{module}.weight_hh{cell[3] or ''}"][1]
        return 1.0 / math.sqrt(hidden)
    if leaf in ("attn_l", "attn_r"):
        return 1.0 / math.sqrt(shape[0])
    weight = shape if leaf == "weight" else shapes.get(f"{module}.weight")
    if leaf in ("weight", "bias") and weight is not None and len(weight) >= 2:
        return 1.0 / math.sqrt(math.prod(weight[1:]))
    raise ValueError(f"no initial-weight rule for {name} {tuple(shape)}: "
                     "give the model's reference module an init_bound(name, "
                     "shape, shapes)")


def make_encoder_tensors(shapes: dict, gen: torch.Generator, device,
                         model: str = DEFAULT_MODEL) -> dict:
    """{name: tensor} for every entry of ``shapes`` (name -> shape, in
    state-dict order) of an encoder of ``model``."""
    init_bound = getattr(model_module(model), "init_bound", None)
    kinds = {n: _kind(n, shapes) for n in shapes}
    out = {}
    lin = [(n, s) for n, s in shapes.items() if kinds[n] == "uniform"]
    total = sum(math.prod(s) for _, s in lin)
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0,
                                                      generator=gen)
    off = 0
    for n, s in lin:
        size = math.prod(s)
        bound = _bound(n, s, shapes, init_bound)
        out[n] = (flat[off:off + size] * bound).view(s)
        off += size
    emb = [(n, s) for n, s in shapes.items() if kinds[n] == "embedding"]
    for n, s in emb:
        out[n] = torch.empty(s, device=device).normal_(0.0, 1.0,
                                                       generator=gen)
    stats = [(n, s) for n, s in shapes.items() if kinds[n] == "stat"]
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
        if kinds[n] == "affine":
            fill = 1.0 if n.endswith(".weight") else 0.0
            out[n] = torch.full(s, fill, device=device)
        elif kinds[n] == "skip":
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
