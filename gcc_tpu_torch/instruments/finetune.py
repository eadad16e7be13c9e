"""Finetune instrument (``scripts/finetune_benchmark.py``).

The finetune protocol (encoder + linear head, cross-entropy, clip by
value 1, the warmup-linear rate, 10-fold stratified CV) on the 9-class
role-v2 graph, where classes are confusable by construction, so scores
land mid-range. Arms:

  pretrained  encoder from the checkpoint's query encoder (BatchNorm
              statistics reset, as the protocol does)
  scratch     encoder initialized from ``cfg.seed`` by an explicit
              generator; no pretrained tensor is read

Micro-F1 and the folds are the port's own (``training/finetune.py``),
so the instrument runs whole on the card, where scikit-learn is absent.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import time

from gcc_tpu_torch.instruments.role import build_role_graph_v2

ARMS = ("pretrained", "scratch")


def run_finetune_instrument(ckpt: str, blocks: int = 60, epochs: int = 10,
                            folds=(0,), n_max: int = 256, e_max: int = 2048,
                            arms=ARMS, out: str | None = None,
                            log_fn=print, device="cuda") -> dict:
    """Finetune each arm on role v2 at ``blocks`` for ``epochs`` on
    ``folds``; returns, and writes to ``out`` if given, the reference's
    JSON: {ckpt, blocks, epochs, folds, results: {arm: {mean, std,
    folds}}}, plus each arm's wall seconds under ``wall``."""
    from gcc_tpu_torch.device import resolve_device
    from gcc_tpu_torch.training.checkpoint import load_checkpoint, load_config
    from gcc_tpu_torch.training.finetune import (
        NodeLabeledData,
        run_finetune_cv,
    )

    device = resolve_device(device)
    ckpts = sorted(glob.glob(ckpt))
    if not ckpts:
        raise FileNotFoundError(f"no checkpoint matches {ckpt}")
    ckpt = ckpts[0]
    unknown = set(arms) - set(ARMS)
    if unknown:
        raise ValueError(f"unknown arms {sorted(unknown)}; known: {ARMS}")
    g, y = build_role_graph_v2(blocks=blocks)
    folds = list(folds)
    log_fn(f"role-v2 finetune: {g.num_nodes} nodes, {y.shape[1]} classes, "
           f"{epochs} epochs, folds {folds}")
    cfg = dataclasses.replace(load_config(os.path.dirname(ckpt)),
                              epochs=epochs)
    data = NodeLabeledData(g, y, cfg, n_max=n_max, e_max=e_max)
    results, wall = {}, {}
    for arm in arms:
        t0 = time.time()
        pretrained = (load_checkpoint(ckpt)["model"] if arm == "pretrained"
                      else None)
        results[arm] = run_finetune_cv(cfg, data, pretrained, folds=folds,
                                       log_fn=log_fn, device=device)
        wall[arm] = time.time() - t0
        log_fn(f"{arm:11s} {results[arm]}  ({wall[arm]:.0f}s)")
    record = {"ckpt": ckpt, "blocks": blocks, "epochs": epochs,
              "folds": folds, "results": results, "wall": wall}
    if out:
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
        log_fn(f"wrote {out}")
    return record
