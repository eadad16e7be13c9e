"""Pretraining loop (the reference's train_moco epochs,
train.py:713-786, minus its scaffolding).

Counterpart of ``gcc_tpu/training/loop.py``: one process on one
device, or one process per device under ``torch.distributed`` (data
parallel, on one host or many). PyTorch queues the device work of a
dispatch asynchronously; metrics stay on the device and are fetched with
a lag of ``metrics_lag`` steps, so the host never waits for the step it
has just queued.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Callable

import torch
import torch.distributed as dist

from gcc_tpu_torch.config import TrainConfig
from gcc_tpu_torch.device import resolve_device
from gcc_tpu_torch.graph.corpus import CorpusStore
from gcc_tpu_torch.parallel import data_parallel, multihost
from gcc_tpu_torch.sampling import native
from gcc_tpu_torch.sampling.pipeline import PipelineConfig, PretrainPipeline
from gcc_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from gcc_tpu_torch.training.pretrain import (
    create_pretrain_state,
    train_dispatch,
)
from gcc_tpu_torch.utils.meters import AverageMeter
from gcc_tpu_torch.utils.profiling import TensorBoardWriter, maybe_profile


def run_pretrain(
    cfg: TrainConfig,
    corpus_path: str,
    out_dir: str,
    pcfg: PipelineConfig | None = None,
    log_fn: Callable[[str], None] = print,
    metrics_lag: int = 8,
    resume: str | None = None,
    tensorboard: bool = False,
    profile_dir: str | None = None,
    steps_per_call: int = 64,
    dp_devices: int = 1,
    device="cuda",
) -> dict:
    """Train for cfg.epochs over the corpus; returns the final summary
    dict ({epoch, avg_loss, steps, steps_per_epoch_skipped, wall,
    run_dir}). Writes ``metrics.jsonl`` (one line per step) and a
    checkpoint per epoch under ``out_dir/<run name>``.

    resume: checkpoint path — restores the full state including the
    optimizer moments and the queue.

    steps_per_call: optimizer steps per dispatch (one queue item of the
    stacked or routed pipeline, featurized in one batched call; epochs
    are rounded down to a whole number of dispatches). Small datasets
    fall back to one epoch per dispatch.

    An E2E run (``moco`` False) whose ``e2e_split`` spec applies to the
    stacked dispatches takes the size split, and every metrics line
    carries ``e2e_split_overflow``.

    The padded pairs wire (``compact_wire`` False) trains one step per
    pair, each featurizing its query and key views in one call
    (``featurize_pair``), as the reference does where the stacked upgrade
    does not apply.

    Data parallel (``dp_devices`` > 1, or any run inside an initialized
    process group, ``parallel.multihost.initialize_multihost``): one
    rank per device, ``dp_devices`` the world size. The pipeline emits
    the stacked wire with a device axis (``PipelineConfig.devices``);
    every rank of a host runs its host's pipeline (the same seed, so the
    same graphs) and trains on its slice of the device axis, its
    ``LOCAL_RANK``; the train step's collectives make the global batch's
    step (``parallel/data_parallel.py``); the state is replicated (the
    same seed on every rank). Across hosts (``LOCAL_WORLD_SIZE`` below
    the world size) ``cfg.batch_size`` stays the GLOBAL batch, each host
    samples its share from its own corpus shard
    (``corpus_shard_for_host``) with seed ``cfg.seed + 15_485_863·host``,
    and the reference's conditions hold: ``dp_devices`` the global count,
    the stacked wire, an explicit ``PipelineConfig.e_tot``, a divisible
    batch, no routed wire. Only rank 0 writes metrics, TensorBoard and
    checkpoints. (The reference initializes its parameters from a
    flattened first item; torch modules need no sample, so the port has
    nothing to flatten.) Routed emission with E2E is refused with
    ``ValueError``, as in the reference.

    The reference warms its large-bucket program with a throwaway step on
    empty graphs before a routed run, so that a compile does not stall
    training when the first large dispatch arrives. Eager PyTorch
    compiles nothing per bucket, so that step has no counterpart here."""
    device = resolve_device(device)
    store = CorpusStore.open(corpus_path)
    pcfg = pcfg or PipelineConfig(
        batch_size=cfg.batch_size,
        num_samples=cfg.num_samples,
        num_workers=cfg.num_workers,
    )
    dp = dp_devices > 1 or dist.is_initialized()
    nproc = multihost.host_count()
    is_main = multihost.rank() == 0
    if nproc > 1:
        # Multi-host: every host runs this same loop in lockstep;
        # cfg.batch_size stays the GLOBAL batch and each host samples its
        # 1/nproc share from its own corpus shard.
        if dp_devices <= 1 or dp_devices % nproc:
            raise ValueError(
                f"multi-host run_pretrain needs dp_devices (got "
                f"{dp_devices}) set to the GLOBAL device count, "
                f"divisible by the host count ({nproc})")
        if pcfg.emit == "pairs":
            raise ValueError(
                "multi-host run_pretrain requires the stacked compact "
                "wire (emit='stacked'): padded pairs have no shardable "
                "device axis")
        if pcfg.e_tot is None:
            raise ValueError(
                "multi-host run_pretrain requires an explicit "
                "PipelineConfig.e_tot: each host probing its own corpus "
                "shard would produce mismatched global batch shapes. "
                "Pick one value (e.g. from a single-host probe) and pass "
                "it on every host.")
        if cfg.batch_size % nproc:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible "
                             f"by the host count {nproc}")
        pcfg = dataclasses.replace(pcfg, batch_size=cfg.batch_size // nproc)
    # Upgrade to stacked emission when the fast path supports it: the
    # sampler ships one (K, ...) compact item per K-step dispatch straight
    # from the native buffers — no per-step slicing, K fewer queue hops.
    spe = pcfg.num_samples * max(1, pcfg.num_workers) // pcfg.batch_size
    k_item = max(1, min(steps_per_call, spe))
    if (pcfg.emit == "pairs" and pcfg.compact_wire and pcfg.n_max <= 256
            and native.native_available()):
        pcfg = dataclasses.replace(pcfg, emit="stacked")
    if pcfg.emit == "routed":
        # Routed batches are size-class-homogeneous: learning-neutral for
        # MoCo (negatives come from the queue) but a silent objective
        # change for E2E, whose in-batch negatives would become
        # size-correlated; and routing is host-local, so hosts would emit
        # mismatched bucket tags at the same step.
        if not cfg.contrast.moco:
            raise ValueError(
                "emit='routed' with moco=False changes the E2E objective "
                "(in-batch negatives become size-class-correlated); use "
                "emit='stacked' or 'pairs' for E2E training.")
        if nproc > 1:
            raise ValueError(
                "emit='routed' is host-local (bucket tags would diverge "
                "across hosts); use emit='stacked' for multi-host runs.")
    stacked = pcfg.emit in ("stacked", "routed")
    if stacked and pcfg.super_batch != k_item:
        # Item shape must match the K-step dispatch width.
        pcfg = dataclasses.replace(
            pcfg, super_batch=k_item, prefetch=max(2, pcfg.prefetch // k_item))
    if dp:
        if not stacked:
            raise ValueError(
                "dp_devices > 1 needs the stacked/routed compact wire "
                "(native sampler, compact_wire, n_max <= 256) — the "
                "padded pairs path has no shardable device axis.")
        if cfg.batch_size % dp_devices:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible "
                             f"by dp_devices {dp_devices}")
        if multihost.world_size() != dp_devices:
            raise ValueError(
                f"dp_devices={dp_devices} but {multihost.world_size()} "
                "ranks: run one process per device (torchrun "
                "--nproc-per-node, initialize_multihost)")
        # Each host's items carry its devices' slices of the batch.
        pcfg = dataclasses.replace(pcfg, devices=dp_devices // nproc)
    run_dir = os.path.join(out_dir, cfg.run_name())
    os.makedirs(run_dir, exist_ok=True)
    # Every rank computes the same (global) metrics; rank 0 writes them.
    tb = TensorBoardWriter(os.path.join(run_dir, "tb")
                           if tensorboard and is_main else None)
    host_graph_ids = None
    pipe_seed = cfg.seed
    if nproc > 1:
        # Per-host corpus shard and a decorrelated sampling stream.
        host_graph_ids = multihost.corpus_shard_for_host(store.graph_sizes)
        pipe_seed = cfg.seed + 15_485_863 * multihost.host_index()

    loss_meter = AverageMeter()
    summary: dict = {}
    pending: list[tuple[int, dict]] = []
    with contextlib.closing(tb), \
            PretrainPipeline(store, cfg.sampler, pcfg, seed=pipe_seed,
                             graph_ids=host_graph_ids) as pipe, \
            open(os.path.join(run_dir, "metrics.jsonl") if is_main
                 else os.devnull, "a") as mfile, \
            (data_parallel.data_parallel() if dp
             else contextlib.nullcontext()), \
            maybe_profile(profile_dir):
        steps_per_epoch = pipe.steps_per_epoch
        total_steps = steps_per_epoch * cfg.epochs
        state = create_pretrain_state(cfg, total_steps, seed=cfg.seed,
                                      device=device)
        if resume:
            load_checkpoint(resume, state)
            log_fn(f"resumed from {resume} at step {state.step}")
        # In stacked mode the item shape fixes the dispatch width.
        k_steps = (pcfg.super_batch if stacked
                   else max(1, min(steps_per_call, steps_per_epoch)))

        def dispatch() -> dict:
            """Queue k_steps optimizer steps; (k_steps,) device tensors
            per metric."""
            if stacked:
                # One queue item IS the whole K-step dispatch.
                wq, wk = next(pipe)
                if dp:
                    wq, wk = _rank_slice(wq), _rank_slice(wk)
                return train_dispatch(state, wq, wk, n_max=pcfg.n_max)
            per_step = [train_dispatch(state, *next(pipe), n_max=pcfg.n_max)
                        for _ in range(k_steps)]
            return {k: torch.cat([m[k] for m in per_step])
                    for k in per_step[0]}

        def drain(entry) -> None:
            s0, m = entry
            # One transfer per metric and dispatch; it waits for that
            # dispatch only, later ones stay queued on the device.
            host = {k: v.tolist() for k, v in m.items()}
            overflow = host.get("e2e_split_overflow")
            for j, loss in enumerate(host["loss"]):
                s = s0 + j
                loss_meter.update(loss)
                rec = {"step": s, "loss": loss, "prob": host["prob"][j],
                       "grad_norm": host["grad_norm"][j]}
                if overflow is not None:
                    # Size-split E2E: > 0 means pairs beyond the large
                    # classes' capacity were forced into a smaller bucket
                    # and lost edges this step — surface it.
                    rec["e2e_split_overflow"] = overflow[j]
                    if overflow[j]:
                        log_fn(f"WARNING step {s}: e2e split overflow "
                               f"{overflow[j]} pairs truncated — raise the "
                               f"large-class capacity in "
                               f"ContrastConfig.e2e_split")
                mfile.write(json.dumps(rec) + "\n")
                tb.scalar("moco_loss", loss, s)
                tb.scalar("moco_prob", host["prob"][j], s)
                if (s + 1) % cfg.print_freq == 0:
                    log_fn(f"step {s + 1}/{total_steps} "
                           f"loss {loss_meter.val:.4f} ({loss_meter.avg:.4f})")

        # Epochs are rounded DOWN to a whole number of K-step dispatches:
        # steps_per_epoch % k_steps trailing steps per epoch are skipped
        # (the reference's epoch is exact). Recorded in the summary.
        calls_per_epoch = max(1, steps_per_epoch // k_steps)
        skipped_steps = max(0, steps_per_epoch - calls_per_epoch * k_steps)
        if skipped_steps:
            log_fn(f"note: epoch rounded down to {calls_per_epoch} dispatches "
                   f"of {k_steps} steps; {skipped_steps} of {steps_per_epoch} "
                   f"steps/epoch skipped")
        global_step = 0
        t_start = time.time()
        for epoch in range(1, cfg.epochs + 1):
            t_epoch = time.time()
            data_t = 0.0
            for _ in range(calls_per_epoch):
                t0 = time.time()
                metrics = dispatch()
                # Host time of the dispatch: sampler wait plus queueing
                # the device work (the two are not told apart here).
                data_t += time.time() - t0
                pending.append((global_step, metrics))
                global_step += k_steps
                # Drain metrics with lag to keep the dispatches queued.
                while len(pending) > max(1, metrics_lag // k_steps):
                    drain(pending.pop(0))
            # Epoch boundary: drain all in-flight metrics (the transfers
            # wait for the device; saving then copies the state off it).
            while pending:
                drain(pending.pop(0))
            if epoch % cfg.save_freq == 0:
                save_checkpoint(run_dir, state, cfg, step=epoch)
            save_checkpoint(run_dir, state, cfg)
            log_fn(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s "
                   f"(host dispatch {data_t:.1f}s), avg loss "
                   f"{loss_meter.avg:.4f}")
            summary = {
                "epoch": epoch,
                "avg_loss": loss_meter.avg,
                "steps": global_step,
                "steps_per_epoch_skipped": skipped_steps,
                "wall": time.time() - t_start,
            }
            loss_meter.reset()
    summary["run_dir"] = run_dir
    return summary


def _rank_slice(wire):
    """This rank's slice of its host's device axis: (K, 1, e_dev) edges,
    (K, 1, 3, b) meta. A host of one device emits no device axis
    (``PipelineConfig.devices`` 1); it is added, so the step is the
    data-parallel one at every host size."""
    if wire.meta.ndim == 3:
        return dataclasses.replace(wire, edges=wire.edges[:, None],
                                   meta=wire.meta[:, None])
    r = multihost.local_rank()
    return dataclasses.replace(wire, edges=wire.edges[:, r:r + 1],
                               meta=wire.meta[:, r:r + 1])
