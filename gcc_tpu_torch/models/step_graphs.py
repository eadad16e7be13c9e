"""CUDA-graph replay of the encoder calls of a train step.

A train step (``training/pretrain.py`` ``train_step``, ``e2e_split_step``)
issues ~1,600 (MoCo) to ~4,400 (E2E) kernels, nearly all of them inside
its encoder calls, each one costing the host more time than the card
spends on it. Inside a step (:func:`stepping`), on the card and outside a
data-parallel step, ``GraphEncoder.forward`` hands each call to its
module's :class:`StepGraphs`, which replays captured CUDA graphs:

- The graphs sit below ``module.__call__``: forward pre-hooks fire with
  the step's own ``BatchFeatures``, whose tensors the call copies into
  the graph's static inputs before the replay.
- A call that takes a gradient replays the forward graph through
  :class:`_Replay`, an autograd Function whose backward replays the
  backward graph (``torch.cuda.make_graphed_callables``'s scheme): the
  parameters' ``.grad`` fill as in eager mode, and ``optimizer.step()``
  stays a real call.
- A graph is keyed by the call's position within the step, its inputs'
  shapes and dtypes, train mode and the gradient it takes, so two calls
  of one step never share one (the second would overwrite the
  activations the first's backward reads).
- A key's first call runs eagerly, which is also the capture's warm-up;
  the second captures, then replays. A capture runs no kernel, so
  BatchNorm's running buffers, the dropout generator and Adam see the
  eager sequence.
- The dropout generator is registered with each capture: a replay draws
  fresh masks from it at the offsets an eager call would use.
- A deep copy starts with an empty cache; a moved or replaced parameter
  or buffer empties it.

Everything else (the CPU, generation, finetune, the giant path, a
data-parallel step, the composite readout) runs the eager forward.
"""

from __future__ import annotations

import contextlib

import torch
from torch.nn.modules import module as _module

from gcc_tpu_torch.parallel import data_parallel
from gcc_tpu_torch.utils.profiling import span


class _Counts:
    """Encoder calls by path, plain counters like the kernels'
    ``launches``: ``replays`` (the capturing call included), ``captures``
    and ``eager`` (a key's first call, or a call the graphs do not
    serve)."""

    def __init__(self):
        self.replays = self.captures = self.eager = 0

    def snapshot(self) -> dict[str, int]:
        return {"replays": self.replays, "captures": self.captures,
                "eager": self.eager}


counts = _Counts()


def describe(before: dict[str, int], now: dict[str, int]) -> str:
    """The counters' change between two snapshots, with the share of
    encoder calls replayed."""
    d = {k: now[k] - before[k] for k in now}
    share = d["replays"] / max(1, d["replays"] + d["eager"])
    return (f"step graphs {d['replays']} replays ({share:.1%} of encoder "
            f"calls), {d['captures']} captures, {d['eager']} eager")


# Bumped whenever any module registers a parameter, buffer or submodule:
# a cache whose module may have had one replaced is rebuilt.
_registrations = [0]


def _registered(*_):
    _registrations[0] += 1


_module.register_module_parameter_registration_hook(_registered)
_module.register_module_buffer_registration_hook(_registered)
_module.register_module_module_registration_hook(_registered)

_STEPS: list[dict] = []
_COLD = object()


@contextlib.contextmanager
def stepping():
    """The body is one train step: its encoder calls may replay graphs,
    each numbered by its order among its module's calls in the step."""
    _STEPS.append({})
    try:
        yield
    finally:
        _STEPS.pop()


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


class _Entry:
    """One key's graphs: static inputs and output, and for a call that
    takes a gradient the backward graph, its incoming gradient and the
    parameters' gradients it writes."""

    def __init__(self, fwd, inputs, out, gen, bwd=None, gout=None,
                 grads=None):
        self.fwd, self.inputs, self.out, self.gen = fwd, inputs, out, gen
        self.bwd, self.gout, self.grads = bwd, gout, grads


class _Replay(torch.autograd.Function):
    """The forward graph's output as a function of the parameters; its
    backward replays the backward graph."""

    @staticmethod
    def forward(ctx, entry, *params):
        ctx.entry = entry
        entry.fwd.replay()
        return entry.out.detach()

    @staticmethod
    def backward(ctx, grad):
        entry = ctx.entry
        entry.gout.copy_(grad)
        entry.bwd.replay()
        return (None,) + tuple(None if g is None else g.detach()
                               for g in entry.grads)


class StepGraphs:
    """A module's graphs by key (see the module docstring). Called with
    the module, the features, the dropout generator and the module's
    eager forward ``encode(feats, gen)``."""

    def __init__(self):
        self.entries: dict = {}
        self.tensors: list[torch.Tensor] = []
        self.ptrs: list[int] = []
        self.n_params = 0
        self.registrations = -1

    def __reduce__(self):
        # A copy (deepcopy, pickle) starts empty, bound to its own module.
        return (StepGraphs, ())

    def __call__(self, module, feats, gen, encode):
        if (not _STEPS or data_parallel.current() is not None
                or not _on_card(feats.adj)):
            counts.eager += 1
            return encode(feats, gen)
        step = _STEPS[-1]
        position = step.get(self, 0)
        step[self] = position + 1
        self._validate(module)
        params = self.tensors[:self.n_params]
        grads = (tuple(p.requires_grad for p in params)
                 if torch.is_grad_enabled() else ())
        key = (position, module.training, grads,
               tuple((x.shape, x.dtype) for x in feats))
        entry = self.entries.get(key, _COLD)
        if entry is _COLD or (entry is not None and entry.gen is not gen):
            # The key's first call (or a new generator): eager, and the
            # next call captures.
            self.entries[key] = None
            counts.eager += 1
            return encode(feats, gen)
        if entry is None:
            entry = self.entries[key] = _capture(module, feats, gen, params,
                                                 grads, encode)
            counts.captures += 1
        counts.replays += 1
        with span("gcc.train.replay"):
            for dst, src in zip(entry.inputs, feats):
                dst.copy_(src)
            if entry.bwd is None:
                entry.fwd.replay()
                return entry.out.detach()
            return _Replay.apply(entry, *(p for p, g in zip(params, grads)
                                          if g))

    def _validate(self, module) -> None:
        """Empty the cache if a parameter or buffer was replaced or moved
        since the graphs were captured."""
        if self.registrations != _registrations[0]:
            self.registrations = _registrations[0]
            params = list(module.parameters())
            tensors = params + list(module.buffers())
            if (len(tensors) != len(self.tensors)
                    or any(a is not b for a, b in zip(tensors, self.tensors))):
                self.entries.clear()
                self.tensors, self.n_params = tensors, len(params)
                self.ptrs = [t.data_ptr() for t in tensors]
        ptrs = [t.data_ptr() for t in self.tensors]
        if ptrs != self.ptrs:
            self.entries.clear()
            self.ptrs = ptrs


@contextlib.contextmanager
def _fresh_leaves(module, params, grads):
    """For a capture: the module's parameters that take a gradient, each
    swapped for a new leaf on the same storage. The captured backward
    then ends in gradient accumulators of the capture's own stream, not
    in the parameters', which a replay of another key in the same step
    may hold on the card's default stream."""
    leaves = {id(p): p.detach().requires_grad_()
              for p, g in zip(params, grads) if g}
    slots = [(m, name, p) for m in module.modules()
             for name, p in m._parameters.items() if id(p) in leaves]
    for m, name, p in slots:
        m._parameters[name] = leaves[id(p)]
    try:
        yield list(leaves.values())
    finally:
        for m, name, p in slots:
            m._parameters[name] = p


def _capture(module, feats, gen, params, grads, encode) -> _Entry:
    """Capture a call's forward graph on static copies of its inputs and,
    if it takes a gradient, the backward graph into the parameters'
    gradients, in one private memory pool."""
    inputs = [x.clone() for x in feats]
    fwd = torch.cuda.CUDAGraph()
    if gen is not None:
        fwd.register_generator_state(gen)
    with _fresh_leaves(module, params, grads) as leaves:
        with torch.cuda.graph(fwd):
            out = encode(type(feats)(*inputs), gen)
    if not leaves:
        return _Entry(fwd, inputs, out, gen)
    gout = torch.empty_like(out)
    bwd = torch.cuda.CUDAGraph()
    with torch.cuda.graph(bwd, pool=fwd.pool()):
        param_grads = torch.autograd.grad(out, leaves, gout,
                                          allow_unused=True)
    return _Entry(fwd, inputs, out.detach(), gen, bwd, gout, param_grads)
