"""Weight bridge between gcc_tpu's Flax GraphEncoder and the port.

Flax ``GraphEncoder`` variables (``params`` and ``batch_stats`` as nested
dicts of numpy arrays — e.g. from ``jax.device_get``) ↔ the port's
``GraphEncoder.state_dict()``. Flax Dense kernels are (in, out); torch
Linear weights are (out, in). Both directions are exact copies.

Flax module names follow creation order: in ``UnsupervisedGIN_0``,
``GINMLP_i`` (Linear_0, MaskedBatchNorm_0, Linear_1) per conv layer,
``MaskedBatchNorm_{2i}`` / ``_{2i+1}`` for its two norms, and
``Linear_j`` for the readout of hidden representation j.
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
