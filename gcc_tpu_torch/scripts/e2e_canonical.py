"""E2E pre-training at the reference's headline configuration for the
canonical 100 epochs, then the role-v2 transfer of ``pe_ab`` (eval PE
pinned to exact eigh), so that E2E's transfer reads beside the MoCo
arms'.

Counterpart of ``scripts/e2e_canonical.py``: batch 256, in-batch
negatives (K = 255), rw_hops 256, stacked emission at n_max 256 / e_max
2048, 8 steps a dispatch, 8,192 samples (32 steps) an epoch, the default
size split of the E2E step (``e2e_canonical.py:50-64``), on the recipe's
synthetic corpus. ``run`` trains into ``OUT`` (a finished run found there
is reused) and writes ``e2e_canonical.npz`` (embeddings, labels) and
``e2e_canonical.json`` (losses, walls); ``score`` (scikit-learn) adds the
role-v2 micro-F1 in ``e2e_canonical_score.json``. Everything is written
under ``--out``.

  python -m gcc_tpu_torch.scripts.e2e_canonical run --out DIR [--epochs 100]
  python -m gcc_tpu_torch.scripts.e2e_canonical score --out DIR
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from gcc_tpu_torch.scripts import pe_ab

BATCH, STEPS_PER_CALL = 256, 8


def e2e_config(epochs: int = 100, seed: int = 0, num_samples: int = 8192):
    """(TrainConfig, PipelineConfig) of ``e2e_canonical.py:50-64``."""
    from gcc_tpu_torch.config import ContrastConfig, SamplerConfig, TrainConfig
    from gcc_tpu_torch.sampling.pipeline import PipelineConfig

    cfg = TrainConfig(
        batch_size=BATCH,
        epochs=epochs,
        seed=seed,
        num_samples=num_samples,
        num_workers=1,
        sampler=SamplerConfig(rw_hops=256),
        contrast=ContrastConfig(moco=False, nce_k=BATCH - 1),
    )
    pcfg = PipelineConfig(
        batch_size=BATCH, n_max=256, e_max=2048, num_samples=num_samples,
        num_workers=1, mode="thread", emit="stacked", super_batch=8,
    )
    return cfg, pcfg


def run(out: str, epochs: int = 100, num_samples: int = 8192, seed: int = 0,
        blocks: int = 120, log_fn=print, device="cuda") -> dict:
    """Train and encode; returns the record written to
    ``e2e_canonical.json``."""
    from gcc_tpu_torch.device import resolve_device
    from gcc_tpu_torch.instruments.pretrain import make_corpus

    device = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    cfg, pcfg = e2e_config(epochs, seed, num_samples)
    corpus = os.path.join(out, "corpus")
    make_corpus(corpus)
    run_dir, _, train_s = pe_ab.train(cfg, pcfg, corpus, out, STEPS_PER_CALL,
                                      log_fn, device)
    losses = pe_ab.read_losses(run_dir)
    per_epoch = num_samples // BATCH
    log_fn(f"trained {len(losses)} steps in {train_s:.0f}s")
    t = pe_ab.transfer(run_dir, os.path.join(out, "e2e_canonical.npz"), "v2",
                       blocks=blocks, device=device)
    rec = {"config": f"e2e b={BATCH} k={BATCH - 1} epochs={epochs} "
                     f"steps={len(losses)} split=default",
           "loss_first_epoch": float(np.mean(losses[:per_epoch])),
           "avg_loss_final_epoch": float(np.mean(losses[-per_epoch:])),
           "train_s": round(train_s, 1), "eval_pe": "eigh",
           "run_dir": os.path.relpath(run_dir, out), **t}
    with open(os.path.join(out, "e2e_canonical.json"), "w") as f:
        json.dump(rec, f, indent=1)
    log_fn("E2E_CANONICAL " + json.dumps(rec))
    return rec


def score(out: str, log_fn=print) -> dict:
    """The role-v2 micro-F1 of ``run``'s embeddings (scikit-learn)."""
    from gcc_tpu_torch.tasks import evaluate_node_embeddings

    with open(os.path.join(out, "e2e_canonical.json")) as f:
        rec = json.load(f)
    z = np.load(os.path.join(out, "e2e_canonical.npz"))
    rec["role_v2"] = evaluate_node_embeddings(z["emb"], z["labels"])
    with open(os.path.join(out, "e2e_canonical_score.json"), "w") as f:
        json.dump(rec, f, indent=1)
    log_fn("E2E_CANONICAL " + json.dumps(rec))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m gcc_tpu_torch.scripts.e2e_canonical")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="train and encode (the card)")
    p.add_argument("--out", required=True)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--num-samples", type=int, default=8192)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p = sub.add_parser("score", help="role-v2 micro-F1 (scikit-learn)")
    p.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    log = lambda s: print(s, flush=True)  # noqa: E731
    if args.cmd == "run":
        return run(args.out, args.epochs, args.num_samples, args.seed,
                   log_fn=log, device=args.device)
    return score(args.out, log)


if __name__ == "__main__":
    main()
