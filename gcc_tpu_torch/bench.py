"""Pre-training throughput of the port on one card, in edge-messages/s.

Counterpart of the repository root's ``bench.py`` (the reference's
throughput line): the canonical MoCo config (batch 32, queue K=16384,
5-layer GIN, rw_hops 256) or the E2E headline (batch 256, K = 255
in-batch negatives) over a synthetic corpus of the reference corpus's
shape, through the production path: C++ RWR sampling on a host thread,
stacked compact-wire items, one ``train_dispatch`` of K steps each
(featurize on the hand-written kernels, encoder forward and backward,
InfoNCE, Adam, EMA, enqueue), queued on the card asynchronously.

Usage:

    python -m gcc_tpu_torch.bench moco
    python -m gcc_tpu_torch.bench e2e [--measure-steps 480] [--corpus DIR]

Metric: edge_messages/s/chip = real (unpadded) edges aggregated across
the GIN conv layers per second, Σ_batch (E_q + E_k) × (L − 1) / time, on
the host clock around dispatches that end in a sync on the last loss.
12 chunks of at least ~1 s each, the first 4 dropped, the median of the
rest; beside it the device-resident step: one uploaded item dispatched
again and again, no sampling and no upload in the loop (median of 5
trials).

vs_baseline: the denominator is ``bench.py``'s documented estimate of
the reference's own GPU pipeline's ceiling (1 GPU + 12 CPU sampler
workers), 2e6 edge-messages/s. vs_roofline and vs_roofline_device are
null: ``bench.py`` prints null for a config without a profiled count of
bytes and operations a step, and no such count exists for this card yet.

The knobs that ``bench.py`` reads from ``GCC_TPU_BENCH_*`` variables are
flags here, with the same defaults. Progress goes to stderr as
``[bench +Ns] ...``; the last line of stdout is the JSON line.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

from gcc_tpu_torch.config import (
    ContrastConfig,
    EncoderConfig,
    SamplerConfig,
    TrainConfig,
)
from gcc_tpu_torch.device import resolve_device
from gcc_tpu_torch.graph.corpus import CorpusStore, synthetic_corpus
from gcc_tpu_torch.paths import BUILD_DIR
from gcc_tpu_torch.sampling.pipeline import PipelineConfig, PretrainPipeline
from gcc_tpu_torch.training.pretrain import (
    create_pretrain_state,
    train_dispatch,
)
from gcc_tpu_torch.wire import wire_to_device

REFERENCE_EDGE_MSGS_PER_S = 2.0e6
DEFAULT_CORPUS = os.path.join(BUILD_DIR, "bench_corpus")
# Buckets sized to the subgraph distribution at rw_hops 256 / restart 0.8
# (p99: 141 nodes / 282 edges): 256 nodes truncate < 0.1% of samples,
# 2048 edges none (``bench.py:58-63``).
N_MAX, E_MAX, N_SMALL, RW_HOPS = 256, 2048, 128, 256
NUM_SAMPLES = 10_000
WARMUP_STEPS = 16
N_CHUNKS, WARM_CHUNKS = 12, 4
DEVICE_TRIALS = 5


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """One throughput configuration (``bench.py:51-94``).

    measure_steps sets the chunk as ``bench.py`` does: max(1,
    measure_steps // steps_per_call // 8) dispatches a chunk, so that a
    chunk lasts at least ~1 s. ``bench.py``'s 15,360 MoCo steps were
    sized for ~1,000 steps/s; the port's MoCo step is tens of ms, so
    512 steps keep one 64-step dispatch a chunk, ~2-4 s. device_dispatches:
    dispatches a device-resident trial (``bench.py``'s 24 would take a
    minute a trial at the port's rates)."""

    name: str
    batch_size: int
    nce_k: int
    steps_per_call: int
    measure_steps: int
    emit: str
    device_dispatches: int
    threads: int = 1

    @property
    def moco(self) -> bool:
        return self.name == "moco"


CONFIGS = {
    "moco": BenchConfig("moco", batch_size=32, nce_k=16384,
                        steps_per_call=64, measure_steps=512, emit="routed",
                        device_dispatches=1),
    # The reference's E2E headline: batch 256, so K = 255 in-batch
    # negatives. Routed emission would make the in-batch negatives
    # size-class-correlated, so it stays stacked.
    "e2e": BenchConfig("e2e", batch_size=256, nce_k=255, steps_per_call=8,
                       measure_steps=480, emit="stacked", device_dispatches=3),
}


def train_config(bc: BenchConfig,
                 encoder: EncoderConfig | None = None) -> TrainConfig:
    return TrainConfig(
        batch_size=bc.batch_size,
        sampler=SamplerConfig(rw_hops=RW_HOPS),
        contrast=ContrastConfig(moco=bc.moco, nce_k=bc.nce_k),
        **({"encoder": encoder} if encoder is not None else {}),
    )


def pipeline_config(bc: BenchConfig) -> PipelineConfig:
    """One sampler thread (thread mode), a prefetch of 4 items, one
    stacked item per K-step dispatch (``bench.py:128-136``)."""
    return PipelineConfig(
        batch_size=bc.batch_size, n_max=N_MAX, e_max=E_MAX,
        num_samples=NUM_SAMPLES, num_workers=1, prefetch=4,
        threads_per_worker=bc.threads, mode="thread", emit=bc.emit,
        super_batch=bc.steps_per_call, n_small=N_SMALL,
    )


def edge_messages(wire_q, wire_k, num_conv_layers: int) -> int:
    """Real edges of a dispatch's query and key views, times the conv
    layers that aggregate over them (``bench.py:161-163``)."""
    return (int(np.asarray(wire_q.meta)[:, 1, :].sum(dtype=np.int64))
            + int(np.asarray(wire_k.meta)[:, 1, :].sum(dtype=np.int64))
            ) * num_conv_layers


def steady_median(chunks, warm_chunks: int):
    """The median chunk of the steady ones by rate (``bench.py:220-222``):
    drop the first warm_chunks, sort the rest by messages / seconds, take
    the one at index len // 2. chunks: (edge_messages, seconds) pairs."""
    steady = sorted(chunks[warm_chunks:], key=lambda ms: ms[0] / ms[1])
    return steady[len(steady) // 2]


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def ensure_corpus(path: str) -> CorpusStore:
    """The bench corpus (``bench.py:110-112``), built once under path."""
    if not os.path.exists(os.path.join(path, "manifest.json")):
        synthetic_corpus(path, num_graphs=6, nodes_per_graph=100_000,
                         avg_degree=12, seed=0)
    return CorpusStore.open(path)


def _sync_loss(metrics) -> float:
    return float(metrics["loss"][-1].item())


def run(bc: BenchConfig, corpus: str = DEFAULT_CORPUS, device="cuda",
        n_chunks: int = N_CHUNKS, warm_chunks: int = WARM_CHUNKS,
        encoder: EncoderConfig | None = None, out=sys.stdout) -> dict:
    """Measure ``bc`` and print its JSON line to ``out``; returns it.

    encoder: the encoder configuration (default: the canonical GIN 5 x
    64); the tests pass a narrow one."""
    device = resolve_device(device)
    gpu = gpu_line() if device.type == "cuda" else None
    store = ensure_corpus(corpus)
    cfg = train_config(bc, encoder)
    num_conv_layers = cfg.encoder.num_layers - 1
    k = bc.steps_per_call
    t_start = time.time()

    def note(msg):
        print(f"[bench +{time.time() - t_start:.0f}s] {msg}", file=sys.stderr,
              flush=True)

    with PretrainPipeline(store, cfg.sampler, pipeline_config(bc),
                          seed=0) as pipe:
        state = create_pretrain_state(cfg, total_steps=100_000, seed=0,
                                      device=device)
        note("pipeline up, state ready; warming up")

        def next_call():
            sq, sk = next(pipe)
            return sq, sk, edge_messages(sq, sk, num_conv_layers)

        for _ in range(max(1, WARMUP_STEPS // k)):
            sq, sk, _ = next_call()
            metrics = train_dispatch(state, sq, sk, n_max=N_MAX)
        _sync_loss(metrics)
        if bc.emit == "routed" and sq.n_max != N_MAX:
            # Eager PyTorch compiles nothing per bucket, but the first
            # bucket-n_max dispatch is where the caching allocator and
            # cuBLAS first meet its shapes; large items only assemble
            # after ~100 small ones, so that first meeting would land in a
            # measured chunk. One dispatch of edge-free large-bucket graphs
            # (zero edges, zero edge counts: valid content at the real
            # shapes) on a copy of the state takes it now and leaves the
            # measured state where it was (``bench.py:171-194``).
            meta0 = np.asarray(sq.meta).copy()
            meta0[..., 1, :] = 0
            fake = dataclasses.replace(
                sq, n_max=N_MAX, meta=meta0,
                edges=np.zeros((sq.edges.shape[0], pipe.pcfg.e_tot_large),
                               np.uint16))
            scratch = copy.deepcopy(state)
            _sync_loss(train_dispatch(scratch, fake, fake, n_max=N_MAX))
            del scratch
        note("warmup done; measuring")

        calls_per_chunk = max(1, bc.measure_steps // k // 8)
        steps_per_chunk = calls_per_chunk * k
        chunks = []  # (edge_messages, seconds) per chunk
        last_loss = 0.0
        for c in range(n_chunks):
            msgs = 0
            t0 = time.perf_counter()
            for _ in range(calls_per_chunk):
                sq, sk, m = next_call()
                msgs += m
                metrics = train_dispatch(state, sq, sk, n_max=N_MAX)
            last_loss = _sync_loss(metrics)
            chunks.append((msgs, time.perf_counter() - t0))
            note(f"chunk {c}: {msgs / chunks[-1][1] / 1e6:.2f}M edge-msgs/s")
        med_msgs, med_secs = steady_median(chunks, warm_chunks)

        # The device-resident step: one item uploaded once and dispatched
        # again and again, no host sampling or upload in the loop
        # (``bench.py:224-248``). Routed MoCo measures the small bucket,
        # which ~99% of its dispatches take.
        note("measuring device-resident step")
        want_n = N_SMALL if bc.moco else N_MAX
        while True:
            sq, sk, _ = next_call()
            if bc.emit != "routed" or sq.n_max == want_n:
                break

        def uploaded(wire):
            edges, meta = wire_to_device(wire, device)
            return dataclasses.replace(wire, edges=edges, meta=meta)

        dq, dk = uploaded(sq), uploaded(sk)
        _sync_loss(train_dispatch(state, dq, dk, n_max=N_MAX))  # settle
        trials = []
        for _ in range(DEVICE_TRIALS):
            t0 = time.perf_counter()
            for _ in range(bc.device_dispatches):
                metrics = train_dispatch(state, dq, dk, n_max=N_MAX)
            _sync_loss(metrics)
            trials.append((time.perf_counter() - t0)
                          / (bc.device_dispatches * k))
        device_step_s = sorted(trials)[len(trials) // 2]

    value = med_msgs / med_secs
    enc = cfg.encoder
    line = {
        "metric": "edge_messages/s/chip",
        "value": round(value, 1),
        "unit": "edge-messages/s",
        "vs_baseline": round(value / REFERENCE_EDGE_MSGS_PER_S, 2),
        "vs_roofline": None,
        "detail": {
            "step_ms": round(med_secs / steps_per_chunk * 1000, 2),
            "device_step_ms": round(device_step_s * 1000, 3),
            "device_step_trials_ms": [round(t * 1000, 3) for t in trials],
            "vs_roofline_device": None,
            "steps_per_s": round(steps_per_chunk / med_secs, 2),
            "chunk_rates_M": [round(m / s / 1e6, 2) for m, s in chunks],
            "loss": round(last_loss, 4),
            "config": f"{bc.name} k={bc.nce_k} b={bc.batch_size} "
                      f"{enc.model}{enc.num_layers}x{enc.hidden_size} "
                      f"rw{RW_HOPS} bucket({N_MAX},{E_MAX}) "
                      f"scan{k}"
                      + ("" if bc.moco else
                         f" split[{cfg.contrast.e2e_split or 'off'}]"),
            "gpu": gpu,
        },
    }
    print(json.dumps(line), file=out, flush=True)
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Pre-training throughput of the port, edge-messages/s.")
    ap.add_argument("config", nargs="?", default="moco", choices=CONFIGS)
    ap.add_argument("--corpus", default=DEFAULT_CORPUS,
                    help="bench corpus directory, built there if missing")
    ap.add_argument("--steps-per-call", type=int, default=None,
                    help="steps a dispatch (moco 64, e2e 8)")
    ap.add_argument("--measure-steps", type=int, default=None,
                    help="sets the chunk: max(1, this // steps-per-call // "
                         "8) dispatches (moco 512, e2e 480)")
    ap.add_argument("--emit", default=None, choices=("routed", "stacked"),
                    help="wire emission (moco routed, e2e stacked)")
    ap.add_argument("--threads", type=int, default=1,
                    help="sampler threads of the one worker")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bc = CONFIGS[args.config]
    bc = dataclasses.replace(bc, threads=args.threads, **{
        name: val for name, val in (
            ("steps_per_call", args.steps_per_call),
            ("measure_steps", args.measure_steps), ("emit", args.emit))
        if val is not None})
    run(bc, corpus=args.corpus, device=args.device)


if __name__ == "__main__":
    main()
