"""The paired PE-fidelity A/B: pre-training arms that differ in their
training PE (or batch composition, corpus, storage), each scored by the
same frozen-embedding role transfer with the eval PE pinned to exact
eigh.

Counterpart of ``scripts/pe_ab.py``. The reference selects each arm's PE
through environment variables in a child process; here an arm is a
configuration (``ARMS``, ``pe_ab.py:41-42`` and ``:190-215``):

  eigh                 EncoderConfig.pe_method "eigh" (exact)
  subspace             the subspace PE with pe_guards 16 on the train
                       profile (and a generalized Rayleigh-Ritz)
  subspace-g0          pe_guards None: the train profile's 0 guards
  subspace-g0-stacked  g0 with the stacked emission (random batch
                       composition) in place of size routing
  subspace-g0-div      g0 on the family-diverse corpus
  subspace-g0-bf16     g0 with both bf16 storage levers

The reference pins the guards of every arm but the g0 ones to 16, the
eigh arm's too, where the exact PE ignores them; so does ``ARMS``. It
pins the g0 arms' to 0 in the training process, which is what that
process gets unpinned; ``ARMS`` leaves them None, so that a g0
checkpoint, which carries its configuration, is evaluated at the eval
profile's 16 guards wherever it is used later. Each
(arm, seed) trains the canonical MoCo recipe (``instruments/pretrain.py``,
``pe_ab.py:48-106``) for ``--epochs`` in ``ROOT/<arm>_s<seed>`` (a
finished run found there is reused, ``pe_ab.py:83-106``), then encodes
the role graph, v2 (or v1), from its last checkpoint with the eval PE
pinned to exact eigh, the guards back to each profile's and the levers to
float32 for every arm (``pe_ab.py:107-135``), and writes the embeddings
and labels as ``pe_ab_<bench>.npz`` beside ``pe_ab_<bench>.json`` (loss,
walls). Seeds drive the sampler, so the arms of one seed see the same
data stream: their deltas are paired.

``score`` needs scikit-learn (the card's machine has none): each run's
role micro-F1 (10-fold LogReg, ``evaluate_node_embeddings``), each arm's
mean ± std over seeds and the paired per-seed deltas (``PAIRS``), written
to ``ROOT/summary_<bench>.json``. Everything is written under ``--root``.

  python -m gcc_tpu_torch.scripts.pe_ab run --root DIR [--arms A ...]
      [--seeds 0 1 2] [--epochs 16] [--bench v2|v1]
  python -m gcc_tpu_torch.scripts.pe_ab score --root DIR [--bench v2|v1]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import time
from typing import NamedTuple

import numpy as np


class Arm(NamedTuple):
    pe_method: str
    pe_guards: int | None
    emit: str
    diverse: bool
    bf16: bool


ARMS = {
    "subspace": Arm("subspace", 16, "routed", False, False),
    "eigh": Arm("eigh", 16, "routed", False, False),
    "subspace-g0": Arm("subspace", None, "routed", False, False),
    "subspace-g0-stacked": Arm("subspace", None, "stacked", False, False),
    "subspace-g0-div": Arm("subspace", None, "routed", True, False),
    "subspace-g0-bf16": Arm("subspace", None, "routed", False, True),
}
# The reference's default --arms (ARMS[:3] there).
DEFAULT_ARMS = ("subspace", "eigh", "subspace-g0")
# Paired per-seed deltas the summary reports: (name, arm, baseline arm).
PAIRS = (("g0 - eigh", "subspace-g0", "eigh"),
         ("g16 - eigh", "subspace", "eigh"),
         ("g0 - g16", "subspace-g0", "subspace"),
         ("routed - stacked", "subspace-g0", "subspace-g0-stacked"),
         ("bf16 - f32", "subspace-g0-bf16", "subspace-g0"),
         ("div - plain", "subspace-g0-div", "subspace-g0"))
# The role transfer's bucket (pe_ab.py:137-139).
EVAL_N_MAX, EVAL_E_MAX = 256, 2048


def arm_config(arm: str, epochs: int = 16, seed: int = 0,
               num_samples: int = 2000):
    """(TrainConfig, PipelineConfig) of one arm: the recipe with the
    arm's PE method, guards, emission and levers. ``num_samples`` below
    the recipe's 2,000 cuts an epoch's depth (62 steps at 2,000)."""
    from gcc_tpu_torch.instruments.pretrain import recipe

    a = ARMS[arm]
    lever = "bfloat16" if a.bf16 else "float32"
    cfg, pcfg = recipe(epochs, seed, adj_dtype=lever, jacobi_v_dtype=lever)
    cfg = dataclasses.replace(
        cfg, num_samples=num_samples, encoder=dataclasses.replace(
            cfg.encoder, pe_method=a.pe_method, pe_guards=a.pe_guards))
    pcfg = dataclasses.replace(pcfg, emit=a.emit, num_samples=num_samples)
    return cfg, pcfg


def expected_steps(cfg) -> int:
    return cfg.epochs * (cfg.num_samples * max(1, cfg.num_workers)
                         // cfg.batch_size)


def read_losses(run_dir: str) -> list[float]:
    """The losses of ``run_dir/metrics.jsonl``, a truncated trailing line
    (a killed run) skipped."""
    losses = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            try:
                losses.append(json.loads(line)["loss"])
            except (json.JSONDecodeError, KeyError):
                continue
    return losses


def finished_run(out_dir: str, steps: int) -> str | None:
    """A run under ``out_dir`` whose metrics hold at least ``steps``
    losses and that has a ``current`` checkpoint; ``current`` alone is no
    completion mark (it is written every epoch)."""
    for ck in sorted(glob.glob(os.path.join(out_dir, "*", "current"))):
        run_dir = os.path.dirname(ck)
        if (os.path.exists(os.path.join(run_dir, "metrics.jsonl"))
                and len(read_losses(run_dir)) >= steps):
            return run_dir
    return None


def train(cfg, pcfg, corpus: str, out_dir: str, steps_per_call: int,
          log_fn=print, device="cuda") -> tuple[str, float, float]:
    """Train ``cfg`` into ``out_dir`` unless a finished run is there;
    returns (run_dir, average loss of the last epoch, training wall)."""
    from gcc_tpu_torch.training.loop import run_pretrain

    steps = expected_steps(cfg)
    t0 = time.time()
    run_dir = finished_run(out_dir, steps)
    if run_dir is None:
        run_dir = run_pretrain(cfg, corpus, out_dir, pcfg=pcfg, log_fn=log_fn,
                               steps_per_call=steps_per_call,
                               device=device)["run_dir"]
    else:
        log_fn(f"reusing the finished run {run_dir}")
    losses = read_losses(run_dir)
    per_epoch = max(1, len(losses) // max(1, cfg.epochs))
    return run_dir, float(np.mean(losses[-per_epoch:])), time.time() - t0


def eval_config(cfg):
    """The transfer's configuration for every arm: exact eigh PE, the
    levers and PE switches at their defaults (each profile's guards,
    float32 storage; ``pe_ab.py:121-135``)."""
    from gcc_tpu_torch.config import without_switches

    cfg = without_switches(cfg)
    return dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, pe_method="eigh"))


def role_fixture(bench: str = "v2", motifs: int = 200, blocks: int = 120):
    """(graph, labels) of the role benchmark: v2, the 9-class sub-ceiling
    graph (``blocks``), or v1 (``motifs``)."""
    from gcc_tpu_torch.instruments import role

    if bench == "v2":
        return role.build_role_graph_v2(blocks)
    if bench == "v1":
        return role.build_role_graph(motifs)
    raise ValueError(f"unknown role benchmark {bench!r}: v1 or v2")


def transfer(run_dir: str, path: str, bench: str = "v2", motifs: int = 200,
             blocks: int = 120, device="cuda", n_max: int = EVAL_N_MAX,
             e_max: int = EVAL_E_MAX) -> dict:
    """Encode the role graph from ``run_dir/current`` with the eval PE
    pinned (:func:`eval_config`), two views a node averaged, in the
    protocol's bucket (``n_max``, ``e_max``), and write ``path`` (.npz:
    emb, labels, the fixture's parameters and hash). Returns
    {"eval_nodes", "sample_s", "encode_s"}."""
    from gcc_tpu_torch.instruments import role
    from gcc_tpu_torch.training.checkpoint import load_config, load_encoder

    g, y = role_fixture(bench, motifs, blocks)
    cfg = eval_config(load_config(run_dir))
    enc = load_encoder(os.path.join(run_dir, "current"), cfg, device=device)
    emb, t = role.role_embeddings(cfg, enc, g, n_max, e_max, device=device)
    np.savez(path, emb=emb, labels=y, bench=bench, motifs=motifs,
             blocks=blocks, hash=role.role_hash(g))
    return {"eval_nodes": int(g.num_nodes), **t}


def result_paths(root: str, arm: str, seed: int, bench: str):
    out = os.path.join(root, f"{arm}_s{seed}")
    name = "pe_ab" if bench == "v1" else f"pe_ab_{bench}"
    return out, os.path.join(out, name + ".json"), \
        os.path.join(out, name + ".npz")


def run_arm(root: str, arm: str, seed: int, epochs: int = 16,
            bench: str = "v2", motifs: int = 200, blocks: int = 120,
            num_samples: int = 2000, log_fn=print, device="cuda") -> dict:
    """Train one (arm, seed) and write its transfer; returns the record
    written to its JSON."""
    from gcc_tpu_torch.device import resolve_device
    from gcc_tpu_torch.instruments.pretrain import STEPS_PER_CALL, make_corpus

    device = resolve_device(device)
    if arm not in ARMS:
        raise ValueError(f"unknown arm {arm!r}; known: {sorted(ARMS)}")
    out, json_path, npz_path = result_paths(root, arm, seed, bench)
    cfg, pcfg = arm_config(arm, epochs, seed, num_samples)
    diverse = ARMS[arm].diverse
    corpus = os.path.join(root, "corpus_diverse" if diverse else "corpus")
    t0 = time.time()
    make_corpus(corpus, diverse)
    corpus_s = time.time() - t0
    run_dir, avg_loss, train_s = train(cfg, pcfg, corpus, out,
                                       STEPS_PER_CALL, log_fn, device)
    t0 = time.time()
    t = transfer(run_dir, npz_path, bench, motifs, blocks, device)
    rec = {"bench": bench, "method": arm, "seed": seed, "epochs": epochs,
           "steps": expected_steps(cfg), "avg_loss": avg_loss,
           "train_s": round(train_s, 1), "eval_s": round(time.time() - t0, 1),
           "corpus_s": round(corpus_s, 1), "eval_pe": "eigh",
           "run_dir": os.path.relpath(run_dir, root), **t}
    with open(json_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def run(root: str, arms=DEFAULT_ARMS, seeds=(0, 1, 2), epochs: int = 16,
        bench: str = "v2", motifs: int = 200, log_fn=print,
        device="cuda") -> list[dict]:
    """Every (seed, arm) in that order; a pair whose JSON exists is read,
    not run again (``pe_ab.py:186-195``)."""
    from gcc_tpu_torch.device import resolve_device

    device = resolve_device(device)
    os.makedirs(root, exist_ok=True)
    records = []
    for seed in seeds:
        for arm in arms:
            _, json_path, _ = result_paths(root, arm, seed, bench)
            if os.path.exists(json_path):
                with open(json_path) as f:
                    records.append(json.load(f))
                log_fn(f"[pe_ab] cached {arm} seed={seed}")
                continue
            log_fn(f"[pe_ab] running {arm} seed={seed} ...")
            records.append(run_arm(root, arm, seed, epochs, bench, motifs,
                                   log_fn=log_fn, device=device))
            r = records[-1]
            log_fn(f"[pe_ab] {arm} seed={seed} done: train {r['train_s']} s, "
                   f"eval {r['eval_s']} s, avg loss {r['avg_loss']:.4f}")
    return records


def summarize(f1: dict) -> dict:
    """{"arms": {arm: {mean, std, seeds}}, "deltas": {name: {per_seed,
    mean, std}}} from {arm: {seed: micro-F1}}: population std over seeds
    (``np.std``, as ``pe_ab.py:245-247``); a delta is taken over the
    seeds both arms ran."""
    arms = {arm: {"mean": float(np.mean(list(rows.values()))),
                  "std": float(np.std(list(rows.values()))),
                  "seeds": {int(s): float(v) for s, v in sorted(rows.items())}}
            for arm, rows in f1.items()}
    deltas = {}
    for name, arm, base in PAIRS:
        seeds = sorted(set(f1.get(arm, {})) & set(f1.get(base, {})))
        if not seeds:
            continue
        d = {int(s): float(f1[arm][s] - f1[base][s]) for s in seeds}
        v = list(d.values())
        deltas[name] = {"per_seed": d, "mean": float(np.mean(v)),
                        "std": float(np.std(v))}
    return {"arms": arms, "deltas": deltas}


def score(root: str, bench: str = "v2", log_fn=print) -> dict:
    """Score every run's transfer under ``root``; writes and returns
    ``summary_<bench>.json``: {"runs": [...], "arms", "deltas"}. Needs
    scikit-learn."""
    from gcc_tpu_torch.tasks import evaluate_node_embeddings

    name = "pe_ab" if bench == "v1" else f"pe_ab_{bench}"
    runs, f1 = [], {}
    pattern = os.path.join(root, "*", name + ".json")
    for json_path in sorted(glob.glob(pattern)):
        with open(json_path) as f:
            rec = json.load(f)
        z = np.load(json_path[:-len(".json")] + ".npz")
        rec["role"] = evaluate_node_embeddings(z["emb"], z["labels"])
        runs.append(rec)
        f1.setdefault(rec["method"], {})[rec["seed"]] = rec["role"]["Micro-F1"]
    if not runs:
        raise FileNotFoundError(f"no {name}.json under {root}/*/")
    out = {"runs": runs, **summarize(f1)}
    log_fn("=== PE A/B summary (micro-F1, paired by seed) ===")
    for arm, s in out["arms"].items():
        log_fn(f"{arm:20s} f1 mean {s['mean']:.4f} ± {s['std']:.4f}  "
               + " ".join(f"s{k}:{v:.4f}" for k, v in s["seeds"].items()))
    for d_name, d in out["deltas"].items():
        log_fn(f"{d_name:20s} {d['mean']:+.4f} ± {d['std']:.4f}  "
               + " ".join(f"s{k}:{v:+.4f}" for k, v in d["per_seed"].items()))
    path = os.path.join(root, "summary.json" if bench == "v1"
                        else f"summary_{bench}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    log_fn(f"wrote {path}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gcc_tpu_torch.scripts.pe_ab")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="train and encode the arms (the card)")
    p.add_argument("--root", required=True)
    p.add_argument("--arms", nargs="+", default=list(DEFAULT_ARMS),
                   choices=sorted(ARMS))
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--epochs", type=int, default=16)
    p.add_argument("--bench", choices=["v1", "v2"], default="v2")
    p.add_argument("--motifs", type=int, default=200, help="role v1")
    p.add_argument("--device", default="cuda")
    p = sub.add_parser("score", help="micro-F1 and the paired summary "
                                     "(scikit-learn)")
    p.add_argument("--root", required=True)
    p.add_argument("--bench", choices=["v1", "v2"], default="v2")
    args = ap.parse_args(argv)
    log = lambda s: print(s, flush=True)  # noqa: E731
    if args.cmd == "run":
        return run(args.root, args.arms, args.seeds, args.epochs, args.bench,
                   args.motifs, log_fn=log, device=args.device)
    return score(args.root, args.bench, log)


if __name__ == "__main__":
    main()
