"""Weight and training-state bridge between gcc_tpu and the port.

Flax ``GraphEncoder`` variables (``params`` and ``batch_stats`` as nested
dicts of numpy arrays — e.g. from ``jax.device_get``) ↔ the port's
``GraphEncoder.state_dict()``. Flax Dense kernels are (in, out); torch
Linear weights are (out, in). Both directions are exact copies.

Flax module names follow creation order: in ``UnsupervisedGIN_0``,
``GINMLP_i`` (Linear_0, MaskedBatchNorm_0, Linear_1) per conv layer,
``MaskedBatchNorm_{2i}`` / ``_{2i+1}`` for its two norms, and
``Linear_j`` for the readout of hidden representation j.

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


def _num_conv(gin_params: dict) -> int:
    return sum(1 for k in gin_params if k.startswith("GINMLP_"))


def flax_to_state_dict(params: dict, batch_stats: dict) -> dict:
    """Flax (params, batch_stats) → torch state_dict of GraphEncoder."""
    gp = params["UnsupervisedGIN_0"]
    gs = batch_stats["UnsupervisedGIN_0"]
    sd = {"degree_embedding.embedding.weight":
          _t(params["DegreeEmbedding_0"]["embedding"])}

    def lin(prefix, p):
        sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
        sd[f"{prefix}.bias"] = _t(p["bias"])

    def bn(prefix, p, s):
        sd[f"{prefix}.weight"] = _t(p["scale"])
        sd[f"{prefix}.bias"] = _t(p["offset"])
        sd[f"{prefix}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}.running_var"] = _t(s["var"])

    n_conv = _num_conv(gp)
    for i in range(n_conv):
        mp, ms = gp[f"GINMLP_{i}"], gs[f"GINMLP_{i}"]
        lin(f"gnn.mlps.{i}.linear0", mp["Linear_0"])
        bn(f"gnn.mlps.{i}.bn", mp["MaskedBatchNorm_0"],
           ms["MaskedBatchNorm_0"])
        lin(f"gnn.mlps.{i}.linear1", mp["Linear_1"])
    for j in range(2 * n_conv):
        bn(f"gnn.norms.{j}", gp[f"MaskedBatchNorm_{j}"],
           gs[f"MaskedBatchNorm_{j}"])
    for j in range(n_conv + 1):
        lin(f"gnn.readouts.{j}", gp[f"Linear_{j}"])
    return sd


def state_dict_to_flax(sd: dict) -> tuple[dict, dict]:
    """Torch GraphEncoder state_dict → Flax (params, batch_stats) as
    nested dicts of numpy arrays."""
    n_conv = len({k.split(".")[2] for k in sd if k.startswith("gnn.mlps.")})

    def lin(prefix):
        return {"kernel": _n(sd[f"{prefix}.weight"]).T.copy(),
                "bias": _n(sd[f"{prefix}.bias"])}

    def bn(prefix):
        return ({"scale": _n(sd[f"{prefix}.weight"]),
                 "offset": _n(sd[f"{prefix}.bias"])},
                {"mean": _n(sd[f"{prefix}.running_mean"]),
                 "var": _n(sd[f"{prefix}.running_var"])})

    gp, gs = {}, {}
    for i in range(n_conv):
        p_bn, s_bn = bn(f"gnn.mlps.{i}.bn")
        gp[f"GINMLP_{i}"] = {"Linear_0": lin(f"gnn.mlps.{i}.linear0"),
                             "MaskedBatchNorm_0": p_bn,
                             "Linear_1": lin(f"gnn.mlps.{i}.linear1")}
        gs[f"GINMLP_{i}"] = {"MaskedBatchNorm_0": s_bn}
    for j in range(2 * n_conv):
        gp[f"MaskedBatchNorm_{j}"], gs[f"MaskedBatchNorm_{j}"] = bn(
            f"gnn.norms.{j}")
    for j in range(n_conv + 1):
        gp[f"Linear_{j}"] = lin(f"gnn.readouts.{j}")
    params = {"DegreeEmbedding_0": {
                  "embedding": _n(sd["degree_embedding.embedding.weight"])},
              "UnsupervisedGIN_0": gp}
    return params, {"UnsupervisedGIN_0": gs}


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


def pretrain_state_from_numpy(tree: dict, cfg, total_steps: int,
                              device="cuda"):
    """A ``PretrainState`` of the port holding the reference's training
    state ``tree`` (see module docstring). The reference keeps Adam's
    moments as flat vectors (``optax.flatten``): they are cut up in
    ``ravel_pytree`` order of the Flax params and laid onto the matching
    torch parameters (Linear kernels transposed), and Adam's step count
    is set."""
    from gcc_tpu_torch.training.pretrain import create_pretrain_state

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
