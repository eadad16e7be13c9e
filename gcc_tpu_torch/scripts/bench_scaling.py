"""Data-parallel weak scaling of the MoCo step.

Counterpart of ``scripts/bench_scaling.py``: the steady-state step time
of ``parallel.data_parallel.make_dp_train_step`` for the same per-rank
batch at each world size (the global batch grows with the world size;
perfect scaling keeps the step time flat), and the efficiency against
the first world size. Each world size is one ``torch.distributed.run``
job of this module (one rank a device: NCCL on cards, gloo with
``--device cpu``); rank 0 reports its step time to this process.

Every step featurizes its padded toy batches (this rank's rows of them)
and runs the MoCo step on the row-sharded queue.

Usage: python -m gcc_tpu_torch.scripts.bench_scaling --devices 1
    [--per-device-batch 8] [--steps 20] [--n-max 64] [--device cuda]

One card runs world size 1 only: NCCL refuses two ranks on one device.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from gcc_tpu_torch.bench import gpu_line
from gcc_tpu_torch.config import ContrastConfig, SamplerConfig, TrainConfig
from gcc_tpu_torch.device import resolve_device
from gcc_tpu_torch.graph.batch import (
    PaddedSubgraphBatch,
    Subgraph,
    WireBatch,
    batch_subgraphs,
)
from gcc_tpu_torch.parallel import multihost
from gcc_tpu_torch.parallel.data_parallel import (
    make_dp_train_step,
    shard_batch,
    shard_state,
)
from gcc_tpu_torch.paths import REPO_ROOT
from gcc_tpu_torch.training.pretrain import create_pretrain_state

MODULE = "gcc_tpu_torch.scripts.bench_scaling"
REPORT = "bench_scaling rank 0: "
JOB_TIMEOUT_S = 600  # a world size's torch.distributed.run job


def _toy_batch(batch_size=8, n=24, n_max=32, e_max=256, seed=0):
    """``__graft_entry__._toy_batch``: batch_size random symmetric graphs
    of n nodes (3n draws, self-loops dropped), padded to (n_max, e_max)."""
    rng = np.random.default_rng(seed)
    subs = []
    for _ in range(batch_size):
        src = rng.integers(0, n, 3 * n)
        dst = rng.integers(0, n, 3 * n)
        keep = src != dst
        s = np.concatenate([src[keep], dst[keep]]).astype(np.int32)
        d = np.concatenate([dst[keep], src[keep]]).astype(np.int32)
        subs.append(Subgraph(src=s, dst=d, num_nodes=n))
    return batch_subgraphs(subs, n_max=n_max, e_max=e_max)


def wire_from_padded(b: PaddedSubgraphBatch) -> WireBatch:
    """The padded wire form of a padded batch: (B, E_max) local endpoints,
    so that ``shard_batch`` hands each rank its rows and the step
    featurizes them (``expand_wire`` restores the same padding)."""
    bsz, e_max = b.batch_size, b.e_max
    base = (np.arange(bsz, dtype=np.int32) * b.n_max)[:, None]
    return WireBatch(
        src=(b.edges_src.reshape(bsz, e_max) - base).astype(np.int16),
        dst=(b.edges_dst.reshape(bsz, e_max) - base).astype(np.int16),
        n_nodes=b.n_nodes.copy(),
        n_edges=(b.edge_weight.reshape(bsz, e_max) > 0).sum(1).astype(
            np.int32),
        seed_pos=b.seed_flag.argmax(axis=1).astype(np.int32),
    )


def rank_step_ms(per_device_batch: int, steps: int, n_max: int,
                 device) -> float:
    """This rank's steady step time (ms) in the running job: one settling
    step, then ``steps`` steps synchronized at the end."""
    world = multihost.world_size()
    bsz = per_device_batch * world
    cfg = TrainConfig(batch_size=bsz,
                      contrast=ContrastConfig(moco=True, nce_k=128 * world),
                      sampler=SamplerConfig(rw_hops=8))
    bq, bk = (wire_from_padded(_toy_batch(batch_size=bsz, n=n_max // 2,
                                          n_max=n_max, e_max=n_max * 8,
                                          seed=s)) for s in (1, 2))
    state = shard_state(create_pretrain_state(cfg, total_steps=1000, seed=0,
                                              device=device))
    step = make_dp_train_step(n_max=n_max)
    dq, dk = shard_batch(bq), shard_batch(bk)
    float(step(state, dq, dk)["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step(state, dq, dk)
    float(m["loss"])
    return (time.perf_counter() - t0) / steps * 1000


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _world_step_ms(world: int, args) -> float:
    """One torch.distributed.run job of ``world`` ranks; rank 0's step."""
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", str(world), "--master-addr", "localhost",
           "--master-port", str(_free_port()), "-m", MODULE, "rank",
           "--per-device-batch", str(args.per_device_batch),
           "--steps", str(args.steps), "--n-max", str(args.n_max),
           "--device", args.device]
    # From the repository root, where ``-m`` finds the package.
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO_ROOT,
                         timeout=JOB_TIMEOUT_S)
    if out.returncode:
        raise RuntimeError(f"world size {world} failed ({out.returncode}):\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    for line in out.stdout.splitlines():
        if line.startswith(REPORT):
            return float(line[len(REPORT):])
    raise RuntimeError(f"world size {world}: rank 0 reported no step time:\n"
                       f"{out.stdout[-2000:]}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Data-parallel weak scaling.")
    ap.add_argument("role", nargs="?", default="sweep",
                    choices=("sweep", "rank"))
    ap.add_argument("--devices", type=int, nargs="+", default=[1],
                    help="world sizes, one rank a device")
    ap.add_argument("--per-device-batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--n-max", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.role == "rank":
        with multihost.multihost_session(device.type):
            if device.type == "cuda":
                device = torch.device("cuda", torch.cuda.current_device())
            ms = rank_step_ms(args.per_device_batch, args.steps, args.n_max,
                              device)
            if multihost.rank() == 0:
                print(f"{REPORT}{ms!r}", flush=True)
        return {}
    if device.type == "cuda" and max(args.devices) > torch.cuda.device_count():
        raise ValueError(f"world size {max(args.devices)} needs as many "
                         f"cards; {torch.cuda.device_count()} visible")
    results = {}
    base = None
    for world in args.devices:
        ms = _world_step_ms(world, args)
        base = base or ms
        results[world] = {"step_ms": round(ms, 2),
                          "efficiency": round(base / ms, 3)}
        print(f"devices={world} batch={args.per_device_batch * world}: "
              f"{ms:.2f} ms/step, weak-scaling efficiency {base / ms:.2f}",
              flush=True)
    line = {"scaling": results,
            "gpu": gpu_line() if device.type == "cuda" else None}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
