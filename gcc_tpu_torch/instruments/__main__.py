"""The downstream instruments' command line.

  python -m gcc_tpu_torch.instruments pretrain --out DIR [--epochs 100]
  python -m gcc_tpu_torch.instruments finetune --ckpt DIR/<run>/current
  python -m gcc_tpu_torch.instruments embed --ckpt DIR/<run>/current --out EMB
  python -m gcc_tpu_torch.instruments score --in EMB

``pretrain``, ``finetune`` and ``embed`` run the encoder (``--device``,
default ``cuda``). ``embed`` writes one ``.npz`` per frozen-embedding
instrument (role, graph, sim): its embeddings or readouts, its labels or
correspondence arrays, the fixture's parameters and hash and the host
sampling and encode walls. ``score`` needs scikit-learn (the card's
machine has none): it rebuilds each fixture from the parameters its file
holds, holds it to the stored hash, computes the baselines, prints each
reference script's table and writes them to ``scores.json`` beside the
files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from gcc_tpu_torch.instruments import graph_families, role, similarity

INSTRUMENTS = ("role", "graph", "sim")
# (n_max, e_max) of each instrument's encode calls, the reference
# scripts' defaults.
ROLE_BUCKET, GRAPH_BUCKET, SIM_BUCKET = (256, 2048), (256, 8192), (256, 2048)


def embed(ckpt: str, out_dir: str, which=INSTRUMENTS, blocks: int = 120,
          graphs_per_class: int = 60, sim_n: int = 1000, log_fn=print,
          device="cuda") -> dict:
    """Write ``out_dir/<instrument>.npz`` for each of ``which``; returns
    {instrument: {"path", "sample_s"?, "encode_s"}}."""
    from gcc_tpu_torch.training.checkpoint import load_config, load_encoder

    unknown = set(which) - set(INSTRUMENTS)
    if unknown:
        raise ValueError(f"unknown instruments {sorted(unknown)}; known: "
                         f"{INSTRUMENTS}")
    cfg = load_config(os.path.dirname(ckpt))
    enc = load_encoder(ckpt, cfg, device=device)
    os.makedirs(out_dir, exist_ok=True)
    done = {}
    if "role" in which:
        g, y = role.build_role_graph_v2(blocks)
        emb, t = role.role_embeddings(cfg, enc, g, *ROLE_BUCKET,
                                      device=device)
        path = os.path.join(out_dir, "role.npz")
        np.savez(path, emb=emb, labels=y, blocks=blocks,
                 hash=role.role_hash(g), **t)
        done["role"] = dict(path=path, **t)
        log_fn(f"role v2: {g.num_nodes} nodes, {g.num_edges} edges; "
               f"sampling {t['sample_s']:.2f} s, encode {t['encode_s']:.2f} "
               f"s -> {path}")
    if "graph" in which:
        graphs, y = graph_families.build_graph_benchmark(graphs_per_class)
        ro, t = graph_families.graph_readouts(cfg, enc, graphs,
                                              *GRAPH_BUCKET, device=device)
        path = os.path.join(out_dir, "graph.npz")
        np.savez(path, score=ro["score"], composite=ro["composite"],
                 labels=y, graphs_per_class=graphs_per_class,
                 hash=graph_families.families_hash(graphs), **t)
        done["graph"] = dict(path=path, **t)
        log_fn(f"graph families: {len(graphs)} graphs; encode "
               f"{t['encode_s']:.2f} s -> {path}")
    if "sim" in which:
        g1, g2, d1, d2 = similarity.build_sim_pair(
            sim_n, rewire=similarity.REWIRE)
        embs, comps, t = similarity.sim_embeddings(cfg, enc, (g1, g2),
                                                   *SIM_BUCKET,
                                                   device=device)
        c1, c2 = similarity.correspondence(d1, d2, sim_n)
        path = os.path.join(out_dir, "sim.npz")
        np.savez(path, emb_1=embs[0], emb_2=embs[1], comp_1=comps[0],
                 comp_2=comps[1], corr_1=c1, corr_2=c2, n=sim_n,
                 hash=similarity.sim_hash(g1, g2, c2), **t)
        done["sim"] = dict(path=path, **t)
        log_fn(f"sim pair: 2 x {sim_n} nodes; sampling {t['sample_s']:.2f} "
               f"s, encode {t['encode_s']:.2f} s -> {path}")
    return done


def _rebuilt(name: str, want: str, got: str) -> None:
    if want != got:
        raise ValueError(f"{name}: the fixture rebuilt from the file's "
                         f"parameters hashes to {got}, the file holds "
                         f"{want}: it was written by other generators")


def _print_table(title: str, results: dict, log_fn, width: int) -> None:
    log_fn(title)
    for name, res in results.items():
        log_fn(f"{name:{width}s} {res}")


def score(in_dir: str, log_fn=print) -> dict:
    """Score every ``<instrument>.npz`` found in ``in_dir``; returns
    {instrument: results}. Raises without scikit-learn, or if no file is
    there."""
    try:
        import sklearn  # noqa: F401
    except ImportError as e:
        raise RuntimeError("score needs scikit-learn (the LogReg and SVC "
                           "protocols, ProNE's randomized SVD)") from e
    found = [w for w in INSTRUMENTS
             if os.path.exists(os.path.join(in_dir, f"{w}.npz"))]
    if not found:
        raise FileNotFoundError(f"no instrument file ({', '.join(INSTRUMENTS)}"
                                f".npz) in {in_dir}")
    out = {}
    for name in found:
        z = np.load(os.path.join(in_dir, f"{name}.npz"))
        if name == "role":
            g, y = role.build_role_graph_v2(int(z["blocks"]))
            _rebuilt(name, str(z["hash"]), role.role_hash(g))
            np.testing.assert_array_equal(z["labels"], y)
            out[name] = role.score_role(z["emb"], g, y)
            _print_table(f"role graph (v2): {g.num_nodes} nodes, "
                         f"{g.num_edges} edges, {y.shape[1]} classes",
                         out[name], log_fn, 10)
        elif name == "graph":
            graphs, y = graph_families.build_graph_benchmark(
                int(z["graphs_per_class"]))
            _rebuilt(name, str(z["hash"]),
                     graph_families.families_hash(graphs))
            np.testing.assert_array_equal(z["labels"], y)
            out[name] = graph_families.score_graph_families(
                z["score"], z["composite"], graphs, y)
            _print_table(f"graph benchmark: {len(graphs)} graphs, 6 classes",
                         out[name], log_fn, 16)
        else:
            n = int(z["n"])
            g1, g2, d1, d2 = similarity.build_sim_pair(
                n, rewire=similarity.REWIRE)
            _rebuilt(name, str(z["hash"]),
                     similarity.sim_hash(g1, g2, z["corr_2"]))
            c1, c2 = similarity.correspondence(d1, d2, n)
            np.testing.assert_array_equal(z["corr_1"], c1)
            np.testing.assert_array_equal(z["corr_2"], c2)
            out[name] = similarity.score_similarity(
                (z["emb_1"], z["emb_2"]), (z["comp_1"], z["comp_2"]), g1, g2,
                d1, d2)
            _print_table(f"sim pair: {n}/{n} nodes, {g1.num_edges}/"
                         f"{g2.num_edges} edges, rewire={similarity.REWIRE}",
                         out[name], log_fn, 17)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m gcc_tpu_torch.instruments")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("pretrain", help="the canonical MoCo recipe")
    p.add_argument("--out", required=True)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--corpus", default=None,
                   help="corpus directory (made there unless present; "
                        "default OUT/corpus)")
    p.add_argument("--diverse", action="store_true",
                   help="the family-diverse corpus (the reference's -div arm)")
    p.add_argument("--device", default="cuda")

    p = sub.add_parser("finetune", help="role v2 finetune, two arms")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--blocks", type=int, default=60)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--folds", type=int, nargs="+", default=[0])
    p.add_argument("--n-max", type=int, default=256)
    p.add_argument("--e-max", type=int, default=2048)
    p.add_argument("--arms", nargs="+", default=["pretrained", "scratch"])
    p.add_argument("--out", default=None, help="JSON file to write")
    p.add_argument("--device", default="cuda")

    p = sub.add_parser("embed", help="frozen embeddings of the instruments")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True, help="directory for the .npz")
    p.add_argument("--which", default=",".join(INSTRUMENTS))
    p.add_argument("--blocks", type=int, default=120, help="role v2")
    p.add_argument("--graphs-per-class", type=int, default=60)
    p.add_argument("--sim-n", type=int, default=1000)
    p.add_argument("--device", default="cuda")

    p = sub.add_parser("score", help="score embed's files (scikit-learn)")
    p.add_argument("--in", dest="in_dir", required=True)

    args = ap.parse_args(argv)
    log = lambda s: print(s, flush=True)  # noqa: E731
    if args.cmd == "pretrain":
        from gcc_tpu_torch.instruments.pretrain import pretrain

        summary = pretrain(args.out, args.epochs, args.seed, args.corpus,
                           args.diverse, log_fn=log, device=args.device)
        with open(os.path.join(summary["run_dir"], "metrics.jsonl")) as f:
            last = json.loads(f.readlines()[-1])
        summary["last_step_loss"] = last["loss"]
        log(json.dumps(summary))
    elif args.cmd == "finetune":
        from gcc_tpu_torch.instruments.finetune import run_finetune_instrument

        run_finetune_instrument(args.ckpt, args.blocks, args.epochs,
                                args.folds, args.n_max, args.e_max,
                                args.arms, args.out, log_fn=log,
                                device=args.device)
    elif args.cmd == "embed":
        embed(args.ckpt, args.out, args.which.split(","), args.blocks,
              graphs_per_class=args.graphs_per_class, sim_n=args.sim_n,
              log_fn=log, device=args.device)
    else:
        results = score(args.in_dir, log_fn=log)
        out = os.path.join(args.in_dir, "scores.json")
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
        log(f"wrote {out}")


if __name__ == "__main__":
    sys.exit(main())
