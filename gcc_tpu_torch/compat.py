"""Weight and training-state bridge between gcc_tpu and the port.

Flax ``GraphEncoder`` variables (``params`` and ``batch_stats`` as nested
dicts of numpy arrays — e.g. from ``jax.device_get``) ↔ the port's
``GraphEncoder.state_dict()``. Flax Dense kernels are (in, out); torch
Linear weights are (out, in). Both directions are exact copies.

Flax module names follow creation order: in ``UnsupervisedGIN_0``,
``GINMLP_i`` (Linear_0, MaskedBatchNorm_0 or SELayer_0, Linear_1) per
conv layer, ``MaskedBatchNorm_{2i}`` / ``_{2i+1}`` (or ``SELayer_…``)
for its two norms, and ``Linear_j`` for the readout of hidden
representation j. GAT and MPNN encoders hold ``UnsupervisedGAT_0``
(``GATLayer_i``: Linear_0, attn_l, attn_r) or ``UnsupervisedMPNN_0``
(Linear_0-2, GRUCell_0), then ``Set2Set_0`` (``lstm_i``) and the head
``Linear_0`` / ``Linear_1``; they have no batch_stats. An encoder
without degree input has no ``DegreeEmbedding_0``. Flax's recurrent
cells keep one Dense per gate (GRU: ir iz in | hr hz hn; LSTM: ii if ig
io | hi hf hg ho); torch's stack the gates (r, z, n; i, f, g, o) into
``weight_ih`` / ``weight_hh``, and the port's cells hold only the
biases Flax has (GRU: ``bias_ih``, ``bias_hn``; LSTM: ``bias_hh``).

:func:`pretrain_state_from_numpy` / :func:`pretrain_state_to_numpy` carry
a whole training state across: the nested dict of numpy arrays that the
reference's ``load_checkpoint`` returns for an Orbax checkpoint
(``params``, ``batch_stats``, ``ema_params``, ``ema_batch_stats``,
``queue``, ``opt_state``, ``step``, ``nce_z``) ↔ the port's
``PretrainState``. Reading the Orbax files is the caller's business (a
script or test that may import ``gcc_tpu``); this module sees numpy
only. The reference's dropout key has no counterpart and is dropped.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _n(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float32, copy=True)


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _count(keys, prefix: str) -> int:
    """Number of distinct indices i among keys ``prefix + "{i}..."``."""
    return len({k[len(prefix):].split(".")[0]
                for k in keys if k.startswith(prefix)})


_DEGREE = "degree_embedding.embedding.weight"


def _layout_of_flax(params: dict) -> dict:
    degree = "DegreeEmbedding_0" in params
    if "UnsupervisedGIN_0" in params:
        gp = params["UnsupervisedGIN_0"]
        return {"model": "gin", "layers": _count(gp, "GINMLP_"),
                "se": "SELayer_0" in gp, "degree": degree}
    model = "gat" if "UnsupervisedGAT_0" in params else "mpnn"
    layers = (_count(params["UnsupervisedGAT_0"], "GATLayer_")
              if model == "gat" else 0)
    return {"model": model, "layers": layers, "degree": degree,
            "lstms": _count(params["Set2Set_0"], "lstm_")}


def _layout_of_state_dict(sd: dict) -> dict:
    degree = _DEGREE in sd
    if any(k.startswith("gnn.mlps.") for k in sd):
        return {"model": "gin", "layers": _count(sd, "gnn.mlps."),
                "se": "gnn.norms.0.linear0.weight" in sd, "degree": degree}
    model = "mpnn" if "gnn.lin0.weight" in sd else "gat"
    return {"model": model, "layers": _count(sd, "gnn.layers."),
            "degree": degree, "lstms": _count(sd, "set2set.lstms.")}


def _entries(layout: dict):
    """(kind, torch prefix, Flax path) of every block of an encoder.
    kinds: "param" (same array), "lin" / "lin_nobias" (kernel
    transposed), "bn" (params scale/offset + batch_stats mean/var),
    "lstm", "gru" (per-gate Dense layers stacked into one cell). An
    encoder without degree input has no degree embedding."""
    if layout["degree"]:
        yield "param", _DEGREE, ("DegreeEmbedding_0", "embedding")
    if layout["model"] == "gin":
        g = ("UnsupervisedGIN_0",)
        n, se = layout["layers"], layout["se"]

        def norm(prefix, path, se_name, bn_name):
            if se:
                yield "lin", f"{prefix}.linear0", path + (se_name, "Linear_0")
                yield "lin", f"{prefix}.linear1", path + (se_name, "Linear_1")
            else:
                yield "bn", prefix, path + (bn_name,)

        for i in range(n):
            mlp = g + (f"GINMLP_{i}",)
            yield "lin", f"gnn.mlps.{i}.linear0", mlp + ("Linear_0",)
            yield from norm(f"gnn.mlps.{i}.bn", mlp, "SELayer_0",
                            "MaskedBatchNorm_0")
            yield "lin", f"gnn.mlps.{i}.linear1", mlp + ("Linear_1",)
        for j in range(2 * n):
            yield from norm(f"gnn.norms.{j}", g, f"SELayer_{j}",
                            f"MaskedBatchNorm_{j}")
        for j in range(n + 1):
            yield "lin", f"gnn.readouts.{j}", g + (f"Linear_{j}",)
        return
    if layout["model"] == "gat":
        for i in range(layout["layers"]):
            path = ("UnsupervisedGAT_0", f"GATLayer_{i}")
            yield "lin_nobias", f"gnn.layers.{i}.fc", path + ("Linear_0",)
            for name in ("attn_l", "attn_r"):
                yield "param", f"gnn.layers.{i}.{name}", path + (name,)
    else:
        m = ("UnsupervisedMPNN_0",)
        for j, name in enumerate(("lin0", "edge0", "edge1")):
            yield "lin", f"gnn.{name}", m + (f"Linear_{j}",)
        yield "gru", "gnn.gru", m + ("GRUCell_0",)
    for i in range(layout["lstms"]):
        yield "lstm", f"set2set.lstms.{i}", ("Set2Set_0", f"lstm_{i}")
    yield "lin", "readout0", ("Linear_0",)
    yield "lin", "readout1", ("Linear_1",)


# Flax's per-gate Dense layers of a recurrent cell, in torch's gate order,
# and the port's bias tensors, each the concatenated biases of its gates.
_GATES = {"lstm": (("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho"),
                   {"bias_hh": ("hi", "hf", "hg", "ho")}),
          "gru": (("ir", "iz", "in"), ("hr", "hz", "hn"),
                  {"bias_ih": ("ir", "iz", "in"), "bias_hn": ("hn",)})}


def _cell_tensor_names(kind: str) -> tuple:
    return ("weight_ih", "weight_hh") + tuple(_GATES[kind][2])


def cell_to_torch(kind: str, p: dict) -> dict:
    """A Flax ``LSTMCell`` ("lstm") or ``GRUCell`` ("gru") param subtree
    → the tensors of the port's cell: per-gate kernels transposed and
    stacked in torch's gate order into ``weight_ih`` / ``weight_hh``, the
    gates' biases concatenated (the LSTM's ``bias_hh``; the GRU's
    ``bias_ih`` and ``bias_hn``)."""
    ins, hids, biases = _GATES[kind]
    out = {"weight_ih": _t(np.concatenate(
               [np.asarray(p[g]["kernel"]).T for g in ins])),
           "weight_hh": _t(np.concatenate(
               [np.asarray(p[g]["kernel"]).T for g in hids]))}
    for name, gates in biases.items():
        out[name] = _t(np.concatenate([p[g]["bias"] for g in gates]))
    return out


def cell_to_flax(kind: str, tensors: dict) -> dict:
    """Inverse of :func:`cell_to_torch`."""
    ins, hids, biases = _GATES[kind]
    p = {}
    for gates, name in ((ins, "weight_ih"), (hids, "weight_hh")):
        for g, w in zip(gates, np.split(_n(tensors[name]), len(gates))):
            p[g] = {"kernel": w.T.copy()}
    for name, gates in biases.items():
        for g, b in zip(gates, np.split(_n(tensors[name]), len(gates))):
            p[g]["bias"] = b
    return p


def flax_to_state_dict(params: dict, batch_stats: dict) -> dict:
    """Flax (params, batch_stats) → torch state_dict of GraphEncoder."""
    sd = {}
    for kind, tp, path in _entries(_layout_of_flax(params)):
        if kind == "param":
            sd[tp] = _t(_get(params, path))
        elif kind in ("lin", "lin_nobias"):
            p = _get(params, path)
            sd[f"{tp}.weight"] = _t(np.asarray(p["kernel"]).T)
            if kind == "lin":
                sd[f"{tp}.bias"] = _t(p["bias"])
        elif kind == "bn":
            p, s = _get(params, path), _get(batch_stats, path)
            sd[f"{tp}.weight"] = _t(p["scale"])
            sd[f"{tp}.bias"] = _t(p["offset"])
            sd[f"{tp}.running_mean"] = _t(s["mean"])
            sd[f"{tp}.running_var"] = _t(s["var"])
        else:
            sd.update({f"{tp}.{k}": v for k, v in
                       cell_to_torch(kind, _get(params, path)).items()})
    return sd


def state_dict_to_flax(sd: dict) -> tuple[dict, dict]:
    """Torch GraphEncoder state_dict → Flax (params, batch_stats) as
    nested dicts of numpy arrays."""
    params, stats = {}, {}
    for kind, tp, path in _entries(_layout_of_state_dict(sd)):
        if kind == "param":
            _set(params, path, _n(sd[tp]))
        elif kind in ("lin", "lin_nobias"):
            p = {"kernel": _n(sd[f"{tp}.weight"]).T.copy()}
            if kind == "lin":
                p["bias"] = _n(sd[f"{tp}.bias"])
            _set(params, path, p)
        elif kind == "bn":
            _set(params, path, {"scale": _n(sd[f"{tp}.weight"]),
                                "offset": _n(sd[f"{tp}.bias"])})
            _set(stats, path, {"mean": _n(sd[f"{tp}.running_mean"]),
                               "var": _n(sd[f"{tp}.running_var"])})
        else:
            _set(params, path, cell_to_flax(kind, {
                k: sd[f"{tp}.{k}"] for k in _cell_tensor_names(kind)}))
    return params, stats


def finetune_to_state_dicts(params: dict, batch_stats: dict
                            ) -> tuple[dict, dict]:
    """The reference's finetune params ({"encoder": …, "head": …}) and
    stats → (encoder state_dict, ClassifierHead state_dict)."""
    head = params["head"]["Linear_0"]
    return (flax_to_state_dict(params["encoder"], batch_stats),
            {"linear.weight": _t(np.asarray(head["kernel"]).T),
             "linear.bias": _t(head["bias"])})


def state_dicts_to_finetune(encoder_sd: dict, head_sd: dict
                            ) -> tuple[dict, dict]:
    """Inverse of :func:`finetune_to_state_dicts`."""
    enc, stats = state_dict_to_flax(encoder_sd)
    head = {"Linear_0": {"kernel": _n(head_sd["linear.weight"]).T.copy(),
                         "bias": _n(head_sd["linear.bias"])}}
    return {"encoder": enc, "head": head}, stats


def _ravel_leaves(tree: dict, prefix=()):
    """(path, leaf) pairs of a nested dict in the order
    ``jax.flatten_util.ravel_pytree`` concatenates them: depth first,
    keys sorted."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _ravel_leaves(tree[key], prefix + (key,))
        else:
            yield prefix + (key,), tree[key]


def _unravel_like(flat: np.ndarray, like: dict) -> dict:
    """Cut the flat vector into a tree shaped like ``like`` (each leaf
    raveled in C order, leaves in ``_ravel_leaves`` order)."""
    total = sum(int(np.prod(np.shape(leaf))) for _, leaf in _ravel_leaves(like))
    if total != np.size(flat):
        raise ValueError(f"flat optimizer vector has {np.size(flat)} entries, "
                         f"the parameters {total}")
    out: dict = {}
    at = 0
    for path, leaf in _ravel_leaves(like):
        size = int(np.prod(np.shape(leaf)))
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.asarray(flat[at:at + size]).reshape(np.shape(leaf))
        at += size
    return out


def _ravel(tree: dict) -> np.ndarray:
    return np.concatenate([np.asarray(leaf, np.float32).reshape(-1)
                           for _, leaf in _ravel_leaves(tree)])


def _param_tensors(model, params_tree: dict) -> dict:
    """A Flax-layout params tree as {torch parameter name: tensor}."""
    _, stats = state_dict_to_flax(model.state_dict())
    sd = flax_to_state_dict(params_tree, stats)
    return {name: sd[name] for name, _ in model.named_parameters()}


def _require_adam(cfg) -> None:
    if cfg.optim.optimizer != "adam":
        raise ValueError(f"the state bridge carries Adam's moments only, "
                         f"not {cfg.optim.optimizer!r}'s")


def pretrain_state_from_numpy(tree: dict, cfg, total_steps: int,
                              device="cuda"):
    """A ``PretrainState`` of the port holding the reference's training
    state ``tree`` (see module docstring). The reference keeps Adam's
    moments as flat vectors (``optax.flatten``): they are cut up in
    ``ravel_pytree`` order of the Flax params and laid onto the matching
    torch parameters (Linear kernels transposed), and Adam's step count
    is set."""
    from gcc_tpu_torch.training.pretrain import create_pretrain_state

    _require_adam(cfg)
    state = create_pretrain_state(cfg, total_steps, seed=cfg.seed,
                                  device=device)
    dev = state.device
    state.model.load_state_dict(
        flax_to_state_dict(tree["params"], tree["batch_stats"]))
    state.ema_model.load_state_dict(
        flax_to_state_dict(tree["ema_params"], tree["ema_batch_stats"]))
    memory = _t(tree["queue"]["memory"])
    if memory.shape != state.queue.memory.shape:
        raise ValueError(f"queue memory {tuple(memory.shape)} does not match "
                         f"the configuration's "
                         f"{tuple(state.queue.memory.shape)}")
    state.queue.memory.copy_(memory)
    state.queue.index.fill_(int(tree["queue"]["index"]))
    adam = next(s for s in tree["opt_state"]
                if isinstance(s, dict) and "mu" in s)
    moments = {key: _param_tensors(
        state.model, _unravel_like(np.asarray(adam[key]), tree["params"]))
        for key in ("mu", "nu")}
    for name, p in state.model.named_parameters():
        state.optimizer.state[p] = {
            "step": torch.tensor(float(adam["count"])),
            "exp_avg": moments["mu"][name].to(dev),
            "exp_avg_sq": moments["nu"][name].to(dev),
        }
    state.step = int(tree["step"])
    state.nce_z.fill_(float(tree["nce_z"]))
    return state


def pretrain_state_to_numpy(state) -> dict:
    """The inverse of :func:`pretrain_state_from_numpy`: the port's state
    as the reference's checkpoint tree (without ``dropout_rng``)."""
    _require_adam(state.cfg)
    params, stats = state_dict_to_flax(state.model.state_dict())
    ema_params, ema_stats = state_dict_to_flax(state.ema_model.state_dict())
    named = dict(state.model.named_parameters())
    opt = state.optimizer.state

    def moment(key: str) -> np.ndarray:
        sd = dict(state.model.state_dict())
        sd.update({name: opt[p][key] if p in opt else torch.zeros_like(p)
                   for name, p in named.items()})
        return _ravel(state_dict_to_flax(sd)[0])

    counts = {int(opt[p]["step"]) for p in named.values() if p in opt}
    if len(counts) > 1:
        raise ValueError(f"Adam step counts differ across parameters: "
                         f"{sorted(counts)}")
    count = np.asarray(counts.pop() if counts else 0, np.int32)
    # The reference's optimizer chain (training/optim.py): clip, decay,
    # Adam, learning-rate schedule; the first two keep no state.
    chain = []
    if state.cfg.optim.clip_norm > 0:
        chain.append(None)
    if state.cfg.optim.weight_decay:
        chain.append(None)
    chain += [{"count": count, "mu": moment("exp_avg"),
               "nu": moment("exp_avg_sq")}, {"count": count.copy()}]
    return {
        "params": params, "batch_stats": stats,
        "ema_params": ema_params, "ema_batch_stats": ema_stats,
        "queue": {"memory": _n(state.queue.memory),
                  "index": np.asarray(int(state.queue.index), np.int32)},
        "opt_state": chain,
        "step": np.asarray(state.step, np.int32),
        "nce_z": np.asarray(float(state.nce_z), np.float32),
    }
