"""The control of ``correct``: the plain reference put in the program's
place and computed one precision below the configuration's (TF32
operands for float32), judged by the same comparison as a run.

    python3 benchmark/control.py --workload <name> --seed <n> [--seed ...]

For a training cell it samples the cell's first dispatch with the
program's pipeline, as a run does, and follows it with the reference in
TF32 (its own PE, encoder, loss and update); for a generation cell it
samples the first call's views and encodes them so. The comparison then
reads those outputs where a run reads the program's and prints each
number beside its limit, one JSON line a seed. The control has to come
out not correct. The benchmark's own runs never run it.
"""

from __future__ import annotations

import copy
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark.harness import check, common  # noqa: E402
from benchmark.harness.weights import make_encoder_tensors, make_queue, \
    split  # noqa: E402
from benchmark.reference import features as rf  # noqa: E402
from benchmark.reference import train as rt  # noqa: E402
from benchmark.reference.encoder import encode, model_name  # noqa: E402
from benchmark.reference.wire import dense  # noqa: E402

PREC = "tf32"


def _encoder_tensors(config, seed_weights, device, with_queue: bool):
    import torch

    from gcc_tpu_torch.models import GraphEncoder
    from benchmark.harness.pretrain import train_config

    model = GraphEncoder(train_config(config).encoder)
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(seed_weights)
    tensors = make_encoder_tensors(shapes, gen, device,
                                   model_name(config))
    queue = (make_queue(config["nce_k"], config["output_size"], gen, device)
             if with_queue else None)
    params, buffers = split({n: t.cpu() for n, t in tensors.items()}, model)
    return params, buffers, (None if queue is None else queue.cpu())


def pretrain_control(config, traffic, seed, device, limits):
    import torch

    from gcc_tpu_torch.graph.corpus import CorpusStore
    from gcc_tpu_torch.sampling.pipeline import PretrainPipeline
    from benchmark.harness.corpus import ensure_corpus
    from benchmark.harness.pretrain import pipeline_config, train_config

    s_weights, s_pipe, s_drop = common.derived_seeds(seed)[:3]
    cfg = train_config(config)
    store = CorpusStore.open(ensure_corpus(config["corpus"]))
    pcfg = pipeline_config(config, traffic)
    with PretrainPipeline(store, cfg.sampler, pcfg, seed=s_pipe) as pipe:
        sq, sk = next(pipe)
        first = (copy.deepcopy(sq), copy.deepcopy(sk))
    params0, buffers0, queue0 = _encoder_tensors(config, s_weights, device,
                                                 with_queue=True)
    check_steps = traffic["check_steps"]
    # The control's own outputs, in the program's place: its PE of every
    # graph and its steps, all at TF32.
    shell = {"forwards": check.layout_forwards(
        first, config, config["steps_per_dispatch"])}
    per_forward = check.forward_graphs(first, shell, config)
    feats = check.reference_features(
        per_forward, config["positional_embedding_size"], "train", device,
        PREC)
    follow_steps = [([], []) for _ in range(check_steps)]
    for entry, (adj, mask, seed_flag, n, pe) in zip(shell["forwards"],
                                                    feats):
        entry["pos"] = pe.cpu()
        entry["degrees"] = rf.degrees(adj).to(torch.int32).cpu()
        if entry["step"] < check_steps:
            entry["adj"] = adj.cpu()
            group = (pe, rf.degrees(adj).long(), seed_flag, mask, adj)
            side = 0 if (not config["moco"] or entry["tag"] == "query") else 1
            follow_steps[entry["step"]][side].append(group)
    if not config["moco"]:
        follow_steps = [(g[:len(g) // 2], g[len(g) // 2:])
                        for g, _ in follow_steps]
    to = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
    out = rt.follow(to(params0), to(buffers0),
                    queue0.to(device) if config["moco"] else None,
                    follow_steps, check.train_cfg(config), s_drop, PREC)
    shell["grad0"] = {k: v.cpu() for k, v in out["grad0"].items()}
    shell["params"] = {k: v.cpu() for k, v in out["params"].items()}
    shell["keys"] = (torch.cat(out["keys"]).cpu() if config["moco"]
                     else None)
    return check.pretrain(first, shell, out["losses"], params0, buffers0,
                          queue0, s_drop, config, device, limits)


def embed_control(config, traffic, seed, device, limits):
    import numpy as np
    import torch

    from gcc_tpu_torch.generate import node_subgraphs
    from gcc_tpu_torch.graph.csr import CSRGraph
    from benchmark.harness.corpus import dataset_graph
    from benchmark.harness.pretrain import train_config

    s_weights, _, _, s_sample = common.derived_seeds(seed)[:4]
    cfg = train_config(config)
    n_max, e_max, batch = traffic["n_max"], traffic["e_max"], traffic["batch"]
    indptr, indices = dataset_graph(traffic["dataset_nodes"],
                                    traffic["dataset_avg_degree"],
                                    traffic["dataset_seed"])
    subs_q, subs_k = node_subgraphs(CSRGraph(indptr=indptr, indices=indices),
                                    cfg, n_max, e_max, rng_seed=s_sample,
                                    two_views=True)
    params, buffers, _ = _encoder_tensors(config, s_weights, device, False)
    p = {k: v.to(device) for k, v in params.items()}
    b = {k: v.to(device) for k, v in buffers.items()}
    enc_cfg = check.encoder_cfg(config)
    pos_size = config["positional_embedding_size"]
    sampled = []
    for c in range(traffic["check_calls"]):
        j = c * batch % (len(subs_q) - batch + 1)
        call = {"q": subs_q[j:j + batch], "k": subs_k[j:j + batch]}
        views, poss, degs = [], [], []
        for subs in (call["q"], call["k"]):
            graphs = [(np.asarray(s.src), np.asarray(s.dst), s.num_nodes,
                       s.seed) for s in subs]
            rows, pos_rows, deg_rows = [], [], []
            for lo in range(0, len(graphs), 1024):
                adj, mask, seed_flag, n = dense(graphs[lo:lo + 1024], n_max,
                                                device)
                pe = rf.positional_embedding(adj, mask, n, pos_size, "eval",
                                             PREC)
                deg = rf.degrees(adj)
                with torch.no_grad():
                    rows.append(encode(p, b, pe, deg.long(), seed_flag, mask,
                                       adj, enc_cfg, training=False,
                                       prec=PREC))
                pos_rows.append(pe.cpu())
                deg_rows.append(deg.to(torch.int32).cpu())
            views.append(torch.cat(rows))
            poss.append(torch.cat(pos_rows))
            degs.append(torch.cat(deg_rows))
        call["emb"] = ((views[0] + views[1]) / 2.0).cpu().numpy()
        call["pos"], call["degrees"] = tuple(poss), tuple(degs)
        sampled.append(call)
    return check.embed(sampled, params, buffers, config, pos_size, n_max,
                       device, limits)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--benchmark-json",
                    default=os.path.join(_ROOT, "BENCHMARK.json"))
    ap.add_argument("--override", default=None)
    args = ap.parse_args(argv)
    bench = common.load_json(args.benchmark_json)
    cell, cfg_entry = common.find_cell(bench, args.workload)
    config = common.load_json(os.path.join(_ROOT, cfg_entry["file"]))
    traffic = common.load_json(common.traffic_path(cell["traffic"]))
    limits = common.load_json(common.limits_path(cell["name"]))
    if args.override:
        extra = json.loads(args.override)
        config.update(extra.get("config", {}))
        traffic.update(extra.get("traffic", {}))
    common.require_model(config)
    device = common.device_check(args.device, cell["chips"])
    run = embed_control if traffic["kind"] == "embed" else pretrain_control
    for seed in args.seed:
        checks = run(config, traffic, seed, device, limits)
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "correct": all(v <= lim for _, v, lim in checks),
                          "checks": {n: {"value": v, "limit": lim}
                                     for n, v, lim in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
