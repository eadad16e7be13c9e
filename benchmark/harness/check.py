"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``benchmark/reference``), number by number,
each against its limit from ``limits/<workload>.json``.

The reference builds every graph's adjacency, degrees, masks and PE
itself from the benchmark's inputs (the sampler's wire, the sampled
subgraphs) and follows the encoder, loss and update from the benchmark's
weights. The PE alone it takes from the program for the steps it follows:
the Ritz vectors of a near-degenerate cluster rotate on any rounding
difference, and the encoder reads their coordinates. The PE is checked
on its own, over every graph of the checked dispatch or call, by the row
cosines, which no such rotation moves.

Imports no module of the program and none of JAX.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from benchmark.reference import features as rf
from benchmark.reference import train as rt
from benchmark.reference.encoder import encode
from benchmark.reference.precision import no_tf32
from benchmark.reference.wire import dense, row_graphs, split_classes, \
    split_order


def keep_on_host(cap, check_steps: int) -> dict:
    """The first dispatch's captures, copied to the host: every encoder
    call's PE and degree feature, the checked steps' adjacency too."""
    fwd = []
    for tag, step, f in cap.forwards:
        entry = {"tag": tag, "step": step, "pos": f.pos.detach().cpu(),
                 "degrees": f.degrees.detach().cpu()}
        if step < check_steps:
            entry["adj"] = f.adj.detach().float().cpu()
        fwd.append(entry)
    return {"forwards": fwd,
            "grad0": {k: v.cpu() for k, v in cap.grad0.items()},
            "params": {k: v.cpu() for k, v in cap.params.items()},
            "keys": None if cap.keys is None else cap.keys.cpu()}


def _leaf_gaps(prog: dict, ref: dict, names) -> list[float]:
    """Each leaf's |‖prog‖ - ‖ref‖| over the larger of its ‖ref‖ and the
    median leaf's ‖ref‖."""
    norms = {n: float(torch.linalg.vector_norm(ref[n].double()))
             for n in names}
    med = float(np.median(list(norms.values())))
    return [abs(float(torch.linalg.vector_norm(prog[n].double())) - norms[n])
            / max(norms[n], med, 1e-30) for n in names]


def _pe_numbers(gaps) -> tuple[float, float]:
    """(median, mean) of the per-graph row-cosine gaps; their spread goes
    to stderr. The median reads the precision every graph is computed
    in; the mean also reads a few graphs gone wrong."""
    g = torch.cat(gaps)
    if not len(g):
        return 0.0, 0.0
    q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99], dtype=g.dtype))
    print(f"pe gaps over {len(g)} graphs: mean {float(g.mean())!r} median "
          f"{float(q[0])!r} p90 {float(q[1])!r} p99 {float(q[2])!r} max "
          f"{float(g.max())!r}", file=sys.stderr)
    return float(q[0]), float(g.mean())


# The encoder's settings a configuration may hold, all handed to the
# reference's model.
ENCODER_KEYS = ("model", "num_layers", "hidden_size", "output_size",
                "positional_embedding_size", "degree_embedding_size",
                "max_degree", "final_dropout", "num_heads", "set2set_iter",
                "set2set_lstm_layer", "use_selayer")


def encoder_cfg(config: dict) -> dict:
    return {k: config[k] for k in ENCODER_KEYS if k in config}


def train_cfg(config: dict) -> dict:
    out = encoder_cfg(config)
    for k in ("moco", "nce_t", "alpha", "learning_rate", "beta1", "beta2",
              "weight_decay", "clip_norm", "warmup", "total_steps"):
        out[k] = config[k]
    return out


def layout_forwards(first, config: dict, steps: int) -> list[dict]:
    """The encoder calls of a dispatch's first ``steps`` steps by the
    program's documented layout, as ``forward_graphs`` reads captured ones:
    MoCo's key then query call a step; E2E's query encoder twice a step,
    or twice a size class under the split."""
    if config["moco"]:
        tags = ["key", "query"]
    elif not config["e2e_split"]:
        tags = ["query"] * 2
    else:
        classes = split_classes(config["e2e_split"],
                                np.asarray(first[0].meta).shape[-1],
                                first[0].n_max or config["n_max"])
        tags = ["query"] * (2 * len(classes))
    return [{"tag": tag, "step": t} for t in range(steps) for tag in tags]


def forward_graphs(first, captured, config: dict):
    """For each captured encoder call, (graphs, bucket): which of the
    first dispatch's graphs it encoded, by the program's documented
    layout (the query or key row of its step; under the E2E size split,
    the pairs slotted into that class)."""
    sq, sk = first
    bucket = sq.n_max or config["n_max"]
    mq, mk = np.asarray(sq.meta), np.asarray(sk.meta)
    rows = {}
    out = []
    classes = (split_classes(config["e2e_split"], mq.shape[-1], bucket)
               if config["e2e_split"] else None)
    for entry in captured["forwards"]:
        t = entry["step"]
        j = rows.get((entry["tag"], t), 0)
        rows[(entry["tag"], t)] = j + 1
        if classes is None:
            # MoCo: the query encoder takes the query row, the key encoder
            # the key row; E2E: one encoder, the query row first.
            view = 0 if (entry["tag"] == "query"
                         and (config["moco"] or j == 0)) else 1
            wire = (sq, sk)[view]
            out.append((row_graphs(np.asarray(wire.edges)[t],
                                   np.asarray(wire.meta)[t], wire.id_bits),
                        bucket))
            continue
        n_cls = len(classes)
        view, c = divmod(j, n_cls)
        order = split_order(mq[t, 0], mk[t, 0], classes)
        lo = sum(cap for _, cap in classes[:c])
        wire = (sq, sk)[view]
        graphs = row_graphs(np.asarray(wire.edges)[t],
                            np.asarray(wire.meta)[t], wire.id_bits)
        out.append(([graphs[i] for i in order[lo:lo + classes[c][1]]],
                    classes[c][0]))
    return out


def reference_features(per_forward, pos_size: int, profile: str, device,
                        prec: str):
    """(adj, mask, seed, n_nodes, pe) per forward, the PE computed once
    per bucket over all the forwards' graphs."""
    feats = [dense(graphs, bucket, device) for graphs, bucket in per_forward]
    pes = [None] * len(feats)
    for bucket in sorted({b for _, b in per_forward}):
        idx = [i for i, (_, b) in enumerate(per_forward) if b == bucket]
        adj = torch.cat([feats[i][0] for i in idx])
        mask = torch.cat([feats[i][1] for i in idx])
        n = torch.cat([feats[i][3] for i in idx])
        pe = rf.positional_embedding(adj, mask, n, pos_size, profile, prec)
        off = 0
        for i in idx:
            size = feats[i][0].shape[0]
            pes[i] = pe[off:off + size]
            off += size
    return [f + (p,) for f, p in zip(feats, pes)]


def pretrain(first, captured, losses, params0, buffers0, queue0, s_drop,
             config, device, limits, prec: str = "f32"):
    """The numbers of a training cell (see ``limits/<workload>.json``)."""
    no_tf32()
    check_steps = len(losses)
    per_forward = forward_graphs(first, captured, config)
    ref = reference_features(per_forward, config["positional_embedding_size"],
                              "train", device, prec)
    gaps, mismatch = [], 0
    steps = [([], []) for _ in range(check_steps)]
    for entry, (adj, mask, seed, n, pe) in zip(captured["forwards"], ref):
        gaps.append(rf.pe_gaps(entry["pos"].to(device), pe, mask,
                               n)[(n >= 3).cpu()])
        t = entry["step"]
        if t >= check_steps:
            continue
        deg_ref = rf.degrees(adj)
        same = (torch.equal(entry["adj"].to(device), adj)
                & torch.equal(entry["degrees"].to(device).float(), deg_ref))
        mismatch += 0 if same else 1
        group = (entry["pos"].to(device), deg_ref.long(), seed, mask, adj)
        if config["moco"]:
            steps[t][0 if entry["tag"] == "query" else 1].append(group)
        else:
            steps[t][0].append(group)
    if not config["moco"]:
        steps = [(g[:len(g) // 2], g[len(g) // 2:]) for g, _ in steps]
    to = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
    out = rt.follow(to(params0), to(buffers0),
                    queue0.to(device) if config["moco"] else None, steps,
                    train_cfg(config), s_drop, prec)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                        out["losses"]))
    names = list(out["grad0"])
    grad_ref = {k: v.cpu() for k, v in out["grad0"].items()}
    grad_gap = max(_leaf_gaps(captured["grad0"], grad_ref, names))
    gnorm = {n: float(torch.linalg.vector_norm(grad_ref[n].double()))
             for n in names}
    med = float(np.median(list(gnorm.values())))
    moving = [n for n in names if gnorm[n] >= 1e-3 * med]
    change_prog = {n: captured["params"][n] - params0[n] for n in moving}
    change_ref = {n: out["params"][n].cpu() - params0[n] for n in moving}
    pe_median, pe_mean = _pe_numbers(gaps)
    checks = [("adjacency_mismatches", float(mismatch)),
              ("pe_rowcos_median", pe_median),
              ("pe_rowcos_mean", pe_mean),
              ("loss_gap", loss_gap),
              ("grad_gap", grad_gap),
              # The median leaf: the worst one swings with the rounding of
              # a few elements that Adam moves by their sign (PERF.md §2).
              ("change_median_gap", float(np.median(
                  _leaf_gaps(change_prog, change_ref, moving))))]
    if config["moco"]:
        keys_ref = torch.cat(out["keys"]).cpu()
        checks.append(("key_gap", float((captured["keys"] - keys_ref)
                                        .abs().max())))
    return [(n, v, limits[n]) for n, v in checks]


def embed(sampled, params, buffers, config, pos_size: int, n_max: int,
          device, limits, prec: str = "f32", block: int = 1024):
    """The numbers of a generation cell. sampled: per checked call
    {"q": subgraphs, "k": subgraphs, "pos": (q, k) program PE, "degrees":
    (q, k), "emb": the call's output}."""
    no_tf32()
    cfg = encoder_cfg(config)
    p = {k: v.to(device) for k, v in params.items()}
    b = {k: v.to(device) for k, v in buffers.items()}
    gaps, mismatch, emb_gap = [], 0, 0.0
    for call in sampled:
        views = []
        for v, subs in enumerate((call["q"], call["k"])):
            rows = []
            for lo in range(0, len(subs), block):
                graphs = [(np.asarray(s.src), np.asarray(s.dst),
                           s.num_nodes, s.seed) for s in subs[lo:lo + block]]
                adj, mask, seed, n = dense(graphs, n_max, device)
                deg = rf.degrees(adj)
                prog_deg = call["degrees"][v][lo:lo + block].to(device)
                mismatch += int((prog_deg.float() != deg).any(dim=1).sum())
                pos = call["pos"][v][lo:lo + block].to(device)
                pe = rf.positional_embedding(adj, mask, n, pos_size, "eval",
                                             prec)
                gaps.append(rf.pe_gaps(pos, pe, mask, n)[(n >= 3).cpu()])
                with torch.no_grad():
                    rows.append(encode(p, b, pos, deg.long(), seed, mask, adj,
                                       cfg, training=False, prec=prec))
            views.append(torch.cat(rows))
        ref = ((views[0] + views[1]) / 2.0).cpu().numpy()
        emb_gap = max(emb_gap, float(np.abs(call["emb"] - ref).max()))
    checks = [("degree_mismatches", float(mismatch)),
              ("pe_rowcos_median", _pe_numbers(gaps)[0]),
              ("embedding_gap", emb_gap)]
    return [(n, v, limits[n]) for n, v in checks]
