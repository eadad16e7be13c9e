"""Graph-level readout compositions on the graph-families benchmark.

Counterpart of ``scripts/graph_readout_ab.py``. The GIN computes more
graph-level quantities than the reference's frozen score readout: the
pooled activations of every layer, the pooled input features among them
(PE sums, the trained degree embedding, the seed flag). ``encode`` runs
the benchmark's graphs through ``generate_graph_readouts`` once per
checkpoint on the card and writes ``score``, ``pooled`` and ``n_nodes``
as ``readouts_<i>.npz``, with the levers and PE switches a checkpoint
carries put back to their defaults (the reference's script runs without
its variables: the eval profile's 16 guards, float32 storage; the
checkpoint's PE method stays). ``score`` (scikit-learn) composes every
readout on the host (:func:`assemble_variants`) and scores it with the
reference's SVC 10-fold protocol: the headline set, or with ``--full``
every variant with and without per-fold standardization, then the best
GCC-alone variant with the degree histogram appended (``+dh``) and the
majority floor (``graph_readout_ab.py:84-182``). Results go to
``readout_ab.json`` (``readout_ab_full.json``) beside the files. Both
commands write only under ``--out`` / ``--in``.

  python -m gcc_tpu_torch.scripts.graph_readout_ab encode --ckpt GLOB ...
      --out DIR
  python -m gcc_tpu_torch.scripts.graph_readout_ab score --in DIR [--full]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np

HEADLINE = ("score", "inmean+convl2", "layercat", "in_pooled_mean")


def _l2(x, axis=-1):
    n = np.linalg.norm(x, axis=axis, keepdims=True)
    return x / np.where(n == 0, 1.0, n)


def assemble_variants(ro: dict) -> dict[str, np.ndarray]:
    """The readout variants of ``generate_graph_readouts``' output
    (``graph_readout_ab.py:45-81``): the score; the per-layer pooled conv
    activations concatenated (``layercat``), with the pooled input
    features (``+in``), divided by the node count (``_mean``) or each
    block L2-normalized (``_l2``); the pooled input alone; and the
    composites, ``inmean+convl2`` being ``composite_graph_readout``."""
    from gcc_tpu_torch.generate import composite_graph_readout

    score, pooled, n = ro["score"], ro["pooled"], ro["n_nodes"][:, None]
    conv = pooled[1:]
    v = {
        "score": score,
        "layercat": np.concatenate(conv, axis=1),
        "layercat+in": np.concatenate(pooled, axis=1),
        "layercat_mean": np.concatenate([p / n for p in conv], axis=1),
        "layercat+in_mean": np.concatenate([p / n for p in pooled], axis=1),
        "layercat_l2": np.concatenate([_l2(p) for p in conv], axis=1),
        "layercat+in_l2": np.concatenate([_l2(p) for p in pooled], axis=1),
        "in_pooled": pooled[0],
        "in_pooled_mean": pooled[0] / n,
    }
    v["score+layercat"] = np.concatenate([score, v["layercat+in"]], axis=1)
    v["sum+mean"] = np.concatenate(
        [v["layercat+in"], v["layercat+in_mean"]], axis=1)
    v["inmean+convl2"] = composite_graph_readout(ro)
    v["inmean+convmean"] = np.concatenate([p / n for p in pooled], axis=1)
    v["insum+inmean+convl2"] = np.concatenate(
        [pooled[0], pooled[0] / n] + [_l2(p) for p in conv], axis=1)
    v["inmean+convl2+score"] = np.concatenate(
        [pooled[0] / n] + [_l2(p) for p in conv] + [score], axis=1)
    return v


def encode(ckpts, out_dir: str, graphs_per_class: int = 60,
           n_max: int = 256, e_max: int = 8192, log_fn=print,
           device="cuda") -> list[str]:
    """One ``readouts_<i>.npz`` per checkpoint (sorted): the readouts,
    the checkpoint's path, the fixture's parameter and hash, the encode
    wall. Returns the paths."""
    from gcc_tpu_torch.config import without_switches
    from gcc_tpu_torch.device import resolve_device
    from gcc_tpu_torch.generate import generate_graph_readouts
    from gcc_tpu_torch.instruments import graph_families
    from gcc_tpu_torch.training.checkpoint import load_config, load_encoder

    device = resolve_device(device)
    graphs, _ = graph_families.build_graph_benchmark(graphs_per_class)
    digest = graph_families.families_hash(graphs)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, ckpt in enumerate(sorted(ckpts)):
        cfg = without_switches(load_config(os.path.dirname(ckpt)))
        enc = load_encoder(ckpt, cfg, device=device)
        t0 = time.perf_counter()
        ro = generate_graph_readouts(cfg, enc, graphs, n_max=n_max,
                                     e_max=e_max, device=device)
        encode_s = time.perf_counter() - t0
        path = os.path.join(out_dir, f"readouts_{i}.npz")
        np.savez(path, ckpt=ckpt, score=ro["score"], n_nodes=ro["n_nodes"],
                 n_pooled=len(ro["pooled"]), graphs_per_class=graphs_per_class,
                 hash=digest, encode_s=encode_s,
                 **{f"pooled{j}": p for j, p in enumerate(ro["pooled"])})
        log_fn(f"{ckpt}: {len(graphs)} graphs encoded in {encode_s:.2f} s "
               f"-> {path}")
        paths.append(path)
    return paths


def load_readouts(path: str) -> dict:
    z = np.load(path)
    return {"score": z["score"], "n_nodes": z["n_nodes"],
            "pooled": [z[f"pooled{j}"] for j in range(int(z["n_pooled"]))]}


def score_readouts(ro: dict, y: np.ndarray, dh: np.ndarray,
                   full: bool = False, log_fn=print) -> tuple[dict, str]:
    """({row: micro-F1}, best GCC-alone row) of one checkpoint's
    readouts, rows in the reference's order."""
    from gcc_tpu_torch.tasks import evaluate_graph_embeddings

    rows = {}

    def ev(name, emb, std):
        key = f"{name}{'/std' if std else ''}"
        rows[key] = evaluate_graph_embeddings(emb, y, standardize=std)[
            "Micro-F1"]
        log_fn(f"{key:24s} {rows[key]:.4f}")

    ev("degree-hist", dh, False)
    if full:
        ev("degree-hist", dh, True)
    variants = assemble_variants(ro)
    if not full:
        variants = {k: v for k, v in variants.items() if k in HEADLINE}
    for name, emb in variants.items():
        for std in ((False, True) if full else (False,)):
            ev(name, emb, std)
    # Complementarity probe for the best GCC-alone variant.
    best = max((k for k in rows if not k.startswith("degree-hist")),
               key=lambda k: rows[k])
    bname = best.split("/")[0]
    ev(f"{bname}+dh", np.concatenate([variants[bname], dh], axis=1),
       best.endswith("/std"))
    counts = np.bincount(y)
    rows["majority"] = float(counts.max() / counts.sum())
    return rows, best


def score(in_dir: str, full: bool = False, log_fn=print) -> list[dict]:
    """Score every ``readouts_<i>.npz`` in ``in_dir`` (the fixture rebuilt
    from its parameter and held to its hash); writes and returns the
    per-checkpoint results. Needs scikit-learn."""
    from gcc_tpu_torch.instruments import graph_families

    paths = sorted(glob.glob(os.path.join(in_dir, "readouts_*.npz")))
    if not paths:
        raise FileNotFoundError(f"no readouts_*.npz in {in_dir}")
    fixtures, out = {}, []
    for path in paths:
        z = np.load(path)
        gpc = int(z["graphs_per_class"])
        if gpc not in fixtures:
            graphs, y = graph_families.build_graph_benchmark(gpc)
            dh = graph_families.degree_histogram_embeddings(graphs)
            fixtures[gpc] = (graphs, y, dh,
                             graph_families.families_hash(graphs))
        graphs, y, dh, digest = fixtures[gpc]
        if str(z["hash"]) != digest:
            raise ValueError(f"{path}: the fixture rebuilt from its "
                             f"parameter hashes to {digest}, the file holds "
                             f"{z['hash']}")
        log_fn(f"\n=== {z['ckpt']} ({len(graphs)} graphs, 6 classes)")
        rows, best = score_readouts(load_readouts(path), y, dh, full, log_fn)
        log_fn(f"best GCC-alone: {best} = {rows[best]:.4f}")
        out.append({"ckpt": str(z["ckpt"]), "results": rows, "best": best,
                    "encode_s": float(z["encode_s"])})
    path = os.path.join(in_dir, "readout_ab_full.json" if full
                        else "readout_ab.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    log_fn(f"wrote {path}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m gcc_tpu_torch.scripts.graph_readout_ab")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("encode", help="readouts of each checkpoint (the card)")
    p.add_argument("--ckpt", required=True, nargs="+",
                   help="checkpoint paths or globs")
    p.add_argument("--out", required=True, help="directory for the .npz")
    p.add_argument("--graphs-per-class", type=int, default=60)
    p.add_argument("--n-max", type=int, default=256)
    p.add_argument("--e-max", type=int, default=8192)
    p.add_argument("--device", default="cuda")
    p = sub.add_parser("score", help="the readout grid (scikit-learn)")
    p.add_argument("--in", dest="in_dir", required=True)
    p.add_argument("--full", action="store_true",
                   help="every variant, with and without per-fold "
                        "standardization (default: the headline set)")
    args = ap.parse_args(argv)
    log = lambda s: print(s, flush=True)  # noqa: E731
    if args.cmd == "encode":
        ckpts = sorted(set(sum((glob.glob(p) for p in args.ckpt), [])))
        if not ckpts:
            raise SystemExit(f"no checkpoint matches {args.ckpt}")
        return encode(ckpts, args.out, args.graphs_per_class, args.n_max,
                      args.e_max, log, args.device)
    return score(args.in_dir, args.full, log)


if __name__ == "__main__":
    main()
