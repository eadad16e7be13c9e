#!/usr/bin/env python3
"""Chip smoke test of gcc_tpu_torch, the PyTorch/CUDA port, on one card.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the three CUDA kernels (one nvcc per source, in parallel, in
   the background while the host sampler is built and step 3 makes and
   samples the corpus).
3. Samples real wire batches with the port's routed pipeline on a
   synthetic corpus (bucket-128 dispatches, and the first bucket-256
   dispatches, which hold the pairs with a subgraph of more than 128
   nodes) and holds each kernel against its plain PyTorch version on
   them at the main path's shapes, timing both (CUDA events):
   featurize at N = 128 and 256 (4096 graphs), the PE subspace
   iteration at (4096, 128, 128, k=32) and (4096, 256, 256, 32), the
   Jacobi Rayleigh-Ritz finish at (4096, 32, 32), 3 sweeps (beside
   torch.linalg.eigh on the same batch). Also, untimed in the kernels
   line: the PE iteration at k=48 on the N=256 batch (its largest
   shared-memory shape) and on 1037 graphs (a batch that is no multiple
   of the card's SM count), and Jacobi at n=48. Each time is printed
   beside the first port's time for the same shape and as a share of
   its bound.
4. Holds the PE iteration against its plain version at the shapes of
   embedding generation (eval profile, 32 + 16 guard columns): (64, 512,
   512, k=48) and (64, 832, 832, k=48) — the streamed launch plan — and
   (128, 256, 256, k=48), on entire-graph batches of seeded random
   graphs; and the Jacobi kernel at (64, 48, 48) and (128, 48, 48) on
   the Gram and Rayleigh-Ritz matrices of those outputs. (The Jacobi
   launches are timed queued behind a few ms of other work: they are
   shorter than the host takes to enqueue them.)
5. Runs the training path at full width — MoCo, batch 32, queue 16384,
   GIN 5x64, PE 32, rw_hops 256, routed buckets n_small 128 / n_max 256,
   e_max 2048, 64 steps per dispatch: one routed dispatch in bucket 128
   and one in bucket 256 — with the kernels' launch counters zeroed just
   before each and read just after; then times the featurize of one
   routed dispatch alone and profiles the first 8 steps of one more
   routed dispatch (torch.profiler: wall, device busy time, top kernels).
6. Runs the serve path at full width through the entry points:
   run_pretrain (an epoch of 4 routed dispatches, checkpoint) →
   load_checkpoint (restored parameters equal the live ones bit for bit)
   → node_subgraphs (two RWR views of every node of a 4096-node
   community graph; the PE iteration is also held against its plain
   version and timed on the first batch of 64 views in the 512 bucket)
   → generate_embeddings (n_max 512, e_max 8192, batch 64: 128 encode
   calls) → generate_graph_embeddings (score and
   composite readouts of 256 graphs of 100-500 nodes), plus the readouts
   at the 256 bucket and graphs of 520-832 nodes at n_max 832. Launch
   counters are zeroed before each stretch and read after it (per encode
   call: Kernel 2 once, Kernel 3 twice; no plain version is called on
   the card). The first 64 node embeddings are held against the same
   call on the CPU; a stretch of 8 encode calls is profiled.
7. Runs one routed MoCo dispatch in bucket 128 at full width with each
   alternate encoder (GAT, MPNN, GIN with SELayer): finite losses,
   parameters moved, queue advanced.
8. Runs the reference's E2E headline (bench.py e2e: batch 256, in-batch
   negatives, n_max 256, e_max 2048, stacked, 8 steps per dispatch, the
   size split "128:240"): run_pretrain for an epoch of 2 dispatches (a
   checkpoint), one dispatch with the launch counters zeroed (Kernels 2
   and 3 once per size class) and the first 2 steps of one profiled,
   Kernels 2 and 3 held
   against their plain versions at the two classes' shapes, and one
   step's features and loss on the card against the CPU (the PE's row
   cosines held to Kernel 2's bf16 limits; its coordinates printed
   beside the CPU's own change under a 1-ulp change of m_shift).
9. Finetunes from the serve path's checkpoint: entire graphs of
   two structural classes at n_max 512, batch 32, 3 epochs (micro-F1 on
   held-out graphs above 0.7), Kernels 2 and 3 held at that shape; then
   1 epoch on the community graph's nodes through the finetune command
   (`gcc_tpu_torch.cli finetune`, the graph written as a dataset).
9b. Runs the downstream instruments (`gcc_tpu_torch.instruments`) on the
   serve path's checkpoint, which is depth-cut, so their accuracies are
   printed and not held: the role v2 (blocks 120 and 60), graph-family
   and sim-pair fixtures held to the hashes the tests pin; `embed` of all
   three with the launch counters zeroed (Kernel 2 once and Kernel 3
   twice per encode call, no plain-version call), the embeddings finite,
   one-view rows unit; 128 role-v2 node embeddings card vs CPU by step
   6's rule beside the CPU path's own 1-ulp change; the finetune
   instrument at blocks=60, 1 epoch, fold 0, both arms (F1 finite; Kernel
   2 once, Kernel 3 twice per call); Kernels 2 and 3 held against their
   plain versions at the instruments' shapes: (64, 256, 256) and (32,
   256, 256) at k = 48 on RWR views of role v2, (64, 48, 48) and (32, 48,
   48) on their Rayleigh-Ritz matrices, and untimed on 64 family graphs.
10. Runs entire graphs beyond the dense bucket through
   generate_graph_embeddings (from the serve path's checkpoint, n_max
   512): 3 graphs within n_max, 16 REDDIT-shaped graphs of 1,000-3,782
   nodes, one of 8,000 nodes at the dense envelope's density (all on the
   dense schedule) and one at com-DBLP's size (317,080 nodes, 1,049,866
   edges; ring schedule) in one call, Kernel 3 launched twice per giant
   graph; then each giant graph alone against the port's CPU path: the
   span of the iterated PE basis and the PE itself (row cosines, sampled
   above 8,192 nodes; each graph's mean held to 3x the CPU path's own
   change under a 1-ulp change of the edge weights, its witness, plus
   1e-4), giant_gin_encode on identical features, the embeddings beside
   their witness, row order; times by schedule, the com-DBLP-size
   graph's PE and encode, two profiles; Kernel 3 held at (1, 48, 48) with
   5 sweeps on the matrices of the largest REDDIT-shaped graph's finish.
11. Runs run_pretrain for 16 steps over the padded pairs wire
   (compact_wire=False) with two forked sampler processes at the
   training path's width (n_max 128), Kernels 2 and 3 held against
   their plain versions (timed) on the first step's operator, (64, 128,
   128) at k = 32, and its Rayleigh-Ritz matrices, (64, 32, 32) with 3
   sweeps; and one forward and one MoCo step of an encoder without
   degree input.
12. PE 64 (Kernel 2's wide plan, Kernel 3 beyond n = 48): Kernel 2 against its
   plain version at k = 64 on the training buckets' operators ((4096,
   128, 128), (4096, 256, 256)) and at k = 80 (64 + 16 guards) at the
   eval shapes ((128, 256, 256), (64, 512, 512)) — at (128, 256, 256)
   also on six more seeded graph sets, untimed — Kernel 3 at (4096, 64,
   64) and (64, 80, 80), 3 sweeps, error 0, beside torch.linalg.eigh;
   then with positional_embedding_size 64 through the entry points: one
   routed MoCo dispatch per bucket and one generate_embeddings encode
   call at n_max 512 and at 256 (launch counters zeroed before each),
   the PE's row cosines card vs CPU on the train profile (Kernel 2's
   bf16 limits) and the eval profile (3x the CPU path's own 1-ulp
   change + 1e-4); the giant PE of a REDDIT-shaped graph at PE 64 (its
   finish: Kernel 3 at (1, 80, 80)), card vs CPU.
13. Wide widths (Kernel 2 above k = 80, Kernel 3 above n = 118): Kernel
   2's general plan against its plain version at (128, 256, 256), k = 96,
   (64, 512, 512), k = 128 and (16, 832, 832), k = 256 (clusters of 1, 2
   and 6 blocks a graph, each printed with its plan's variant and how many
   such clusters the card holds at once); Kernel 3's two-barrier block
   kernel at (128, 96, 96) (the PE-80 call's Rayleigh-Ritz matrices) and
   its device-memory variant at (64, 120, 120), (64, 128, 128) and (16,
   256, 256), 3 sweeps, error 0, beside torch.linalg.eigh; encode calls
   through generate_embeddings at PE 112 (n_max 512, batch 64: Kernel 2
   at k = 128, Kernel 3 at n = 128; the PE's row cosines card vs CPU by
   the eval-profile rules), PE 80 (n_max 256), PE 104 (Kernel 3 at n =
   120) and PE 240 (n_max 832, batch 16: k = 256), launch counters zeroed
   before each.
14. Data parallel at world size 1 over NCCL (one card: no scaling is
   measured): run_pretrain of 2 routed dispatches at the training path's
   width on one device, then initialize_multihost and the same run
   through run_pretrain's data-parallel branch (the wire's device axis,
   the BatchNorm and gradient all-reduces, the key all-gather, rank-0
   writes); equal loss trajectories (1e-5), the collective calls
   counted. In the same process group, phase 10's graphs through
   generate_graph_embeddings(group=...): each giant graph's partition
   axis across the ranks (the rank's shard placed alone, every row sum
   all-reduced), launch counters zeroed before the call (Kernel 3 twice
   per giant graph, no plain-version call); the dense-bucket rows equal
   to phase 10's bit for bit, each giant graph's PE held to phase 10's
   card PE by its witness rule (row cosines, mean within 3x the 1-ulp
   witness's + 1e-4), the giant rows in order; ms and collective calls per
   giant graph by schedule beside phase 10's, the com-DBLP-size graph's
   PE and encode; Kernel 3 at (1, 48, 48), 5 sweeps, held on the
   matrices of the finish across ranks.
15. Prints one {"kernels": [...]} JSON line (one entry per kernel and
   shape, with the path that runs it), the nvidia-smi line again, and as
   the last line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository; any failed check exits non-zero.
"""

from __future__ import annotations

import ast
import contextlib
import copy
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32
# outside the tensor cores, HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

BATCH, NCE_K, RW_HOPS = 32, 16384, 256
N_SMALL, N_MAX, E_MAX, STEPS = 128, 256, 2048, 64
RR_SWEEPS = 3
ODD_BATCH = 1037  # no multiple of the 132 SMs, nor of a block's 4 warps

# Times of each kernel's predecessor at the same shape, timed the same way
# (CUDA events around the wrapper), for the lines that print a time beside
# it; none of them enters the kernels line. FIRST: the port's first kernels
# (PE: one block per graph on the CUDA cores; Jacobi: one block per matrix;
# featurize is unchanged since). Eval shapes: the streamed plan's first
# version (one block per graph, every product an f32 FMA, Q^T in a device
# scratch) and the block-per-matrix Jacobi kernel with two barriers a
# round, timed without work queued ahead of it. PE 64's Jacobi widths:
# that kernel, queued behind other work (at (1, 80, 80), 5 sweeps, timed
# by ops/kernel_parts.py on random matrices: a fixed count of rounds, so
# the time does not depend on the data; so too its device-scratch variant
# at (4, 512, 512)).
FIRST = "the port's first kernels, H100 80GB HBM3, 700 W"
STREAMED_V1 = ("the streamed plan's first version (one block per graph, f32 "
               "FMAs), H100 80GB HBM3, 700 W")
BLOCK_JACOBI = ("the block-per-matrix kernel (not queued behind other "
                "work), H100 80GB HBM3, 700 W")
WIDE_V1 = ("the wide plan's first version (every product an f32 FMA on the "
           "CUDA cores, Q in device memory), H100 80GB HBM3, 700 W")
BLOCK_JACOBI_PE64 = ("the two-barrier block-per-matrix kernel (queued behind "
                     "other work), H100 80GB HBM3, 700 W")
GENERAL_V1 = ("the general plan's first version (f32 FMAs on bf16-rounded "
              "operands, Q in device memory), H100 80GB HBM3, 700 W")
DEVICE_JACOBI = ("the block-per-matrix kernel over a device scratch (queued "
                 "behind other work), H100 80GB HBM3, 700 W")
EARLIER_MS = {("pe", 128): (20.28, FIRST), ("pe", 256): (66.61, FIRST),
              ("jacobi", 32): (0.951, FIRST),
              ("featurize", 128): (0.1915, FIRST),
              ("featurize", 256): (0.8022, FIRST),
              ("pe", 512): (2.8744, STREAMED_V1),
              ("pe", 832): (7.6530, STREAMED_V1),
              ("jacobi", 64): (0.1981, BLOCK_JACOBI),
              ("jacobi", 128): (0.2126, BLOCK_JACOBI),
              ("pe", "128k64"): (13.8251, WIDE_V1),
              ("pe", "256k64"): (47.9811, WIDE_V1),
              ("pe", "256k80"): (3.9861, WIDE_V1),
              ("pe", "512k80"): (6.6312, WIDE_V1),
              ("jacobi", "n64"): (6.3719, BLOCK_JACOBI_PE64),
              ("jacobi", "n80"): (0.6657, BLOCK_JACOBI_PE64),
              ("jacobi", "giant80"): (1.0912, BLOCK_JACOBI_PE64),
              ("pe", "256k96"): (5.0374, GENERAL_V1),
              ("pe", "512k128"): (8.7633, GENERAL_V1),
              ("pe", "832k256"): (44.3354, GENERAL_V1),
              ("jacobi", "n96"): (1.0980, BLOCK_JACOBI_PE64),
              ("jacobi", "n120"): (1.8889, DEVICE_JACOBI),
              ("jacobi", "n128"): (2.0684, DEVICE_JACOBI),
              ("jacobi", "n256"): (16.0637, DEVICE_JACOBI),
              ("jacobi", "n512"): (125.4365, DEVICE_JACOBI)}
MAX_ROUTED_ITEMS = 2000  # bucket-256 dispatches are ~1 in 100 here

# The serve path: generate's defaults (gcc_tpu_torch/cli.py generate).
GEN_N_MAX, GEN_E_MAX, GEN_BATCH = 512, 8192, 64
K_EVAL = 48              # 32 PE columns + 16 guard columns
COMMUNITY_NODES = 4096
# Embeddings on the card against the same call on the CPU (plain
# versions), first 64 nodes. The outputs are unit vectors. The two differ
# by the bf16 rounds of Kernel 2 (a rounding flips on a last-bit
# difference of an f32 sum), carried through a 3-sweep Jacobi finish that
# is not converged at width 48 and through Ritz columns of near-equal
# eigenvalues, so equality to the bit is out of reach; the limits are set
# from the first measured run (PERF.md).
CPU_MIN_MEAN_COS, CPU_MAX_ABS = 0.995, 0.1
# E2E, one step on the card against the CPU from equal weights (dropout
# off). The train profile's PE (no guard columns) is not a well-
# conditioned function of m_shift coordinate by coordinate: its 32 Ritz
# vectors rotate among themselves on a bf16 rounding flip (views of
# fewer than 32 nodes make the block rank-deficient, and sampled views
# have near-degenerate spectra — none has its top k_b + 1 eigenvalues
# 0.02 apart), so the CPU plain path's own coordinates move by up to a
# whole row under a 1-ulp change of m_shift (PERF.md). What the rows
# span is well conditioned: the row cosines pos·posᵀ (blind to those
# rotations and to column signs) of every view are held to Kernel 2's
# bf16 limits; the coordinates are printed beside that 1-ulp witness.
# The loss limit is the first measurement (0.00667; PERF.md) times
# three.
PE_MEAN_LIMIT, PE_MAX_LIMIT, PROJECTOR_LIMIT = 1e-4, 2e-2, 1e-2
E2E_LOSS_DIFF = 0.02

# The reference's E2E headline (bench.py e2e): batch 256, in-batch
# negatives, n_max 256, e_max 2048, stacked emission, 8 steps per
# dispatch, the size split "128:240" (ContrastConfig.e2e_split's default).
E2E_BATCH, E2E_STEPS, E2E_SPEC, E2E_DISPATCHES = 256, 8, "128:240", 2
# The giant path (generate_graph_embeddings beyond n_max 512): REDDIT-
# shaped graphs (1,000-3,782 nodes, mean degree ~2.3; dense schedule),
# one graph of 8,000 nodes at the dense envelope's density (>= 0.4%:
# 136,000 undirected edges, 0.425%) and one at com-DBLP's size (317,080
# nodes, 1,049,866 undirected edges, GCC paper Table 1; ring schedule).
REDDIT_COUNT, REDDIT_NODES, REDDIT_CHORDS = 16, (1000, 3782), 0.15
DENSE_GIANT = (8000, 136_000)
DBLP_GIANT = (317_080, 1_049_866)
GIANT_COS_SAMPLE = 4096   # rows whose cosines are compared above 8k nodes
GIANT_ENCODE_LIMIT = 1e-4
# The giant PE's row cosines, card vs CPU, mean per graph: the CPU path's
# own change under a 1-ulp change of the edge weights (its witness) is one
# draw of the rounding noise the card's other order of summation also
# draws, so each graph's mean is held to WITNESS_FACTOR x its witness's
# + PE_MEAN_LIMIT. (A fixed 1e-4 fails on graphs whose own witness is
# larger: the 5-sweep f32 Jacobi finish mixes near-degenerate Ritz pairs.
# In the runs PERF.md records the card's mean was 0.12-2.9x its witness's.)
WITNESS_FACTOR = 3
GIANT_SWEEPS = 5          # Kernel 3 in the giant PE's finish
PADDED_STEPS = 16         # run_pretrain steps over the padded pairs wire
# Steps of the profiled training and E2E dispatches: reading a profile
# takes ~0.5 ms of host time per kernel launch it holds (a whole routed
# dispatch holds ~100k), so a profile covers the first steps only.
PROFILED_STEPS, E2E_PROFILED_STEPS = 8, 2
# Finetuning: the graph path at n_max 512, batch 32 (entire graphs, eval
# PE profile), 3 epochs; the node path 1 epoch.
FT_BATCH, FT_EPOCHS, FT_MIN_F1 = 32, 3, 0.7
# PE 64: Kernel 2 at k = 64 (train) and 80 (eval, 64 + 16 guards),
# Kernel 3 at n = 64 and 80.
PE64 = 64
# Every width the reference computes: Kernel 2's general plan (k > 80) and
# Kernel 3's cluster pair kernel (every n but 32, 48, 64, 80). (PE size,
# n_max, graphs, their fewest nodes) of the encode calls through
# generate_embeddings, eval profile (k = min(n_max, PE + 16)): PE 112 (k =
# 128, Kernel 3 at n = 128 on clusters of 2; its PE held card vs CPU), PE
# 80 (k = 96, one block a matrix), PE 104 (n = 120), PE 240 at n_max 832
# (k = 256, clusters of 6), PE 42 (n = 58: h = 29 pairs, odd) and PE 496 at
# n_max 832 (n = 512, A and V^T in the device scratch, clusters of 8).
WIDE_CALLS = ((112, 512, 64, 260), (80, 256, 128, 100), (104, 512, 64, 260),
              (240, 832, 16, 520), (42, 256, 64, 100), (496, 832, 4, 520))
# Kernel 3 rows taken from the matrices an encode call hands it: PE size ->
# the row's key.
RECORDED_JACOBI = {42: "n58", 496: "n512"}
# Further seeds of random_graphs at (128, 256, 256), k = 80, where the
# wide plan's bf16 mean error sits nearest its limit: held untimed.
PE_SPREAD_SEEDS = (1, 2, 3, 4, 5, 6)
# A library call or a plain version slower than this is timed once, not
# several times after a warm-up.
SLOW_LIBRARY_MS = 1000.0
# Data parallel at world size 1: routed dispatches of each run.
DP_DISPATCHES = 2


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    return 1


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int, warmup: int = 1, run_ahead: bool = False) -> float:
    """Mean device time of fn() over reps calls (CUDA events). A launch
    shorter than the host takes to enqueue it (~50 us through a wrapper)
    would be timed at the host's rate: run_ahead first queues a few ms of
    other work, so the launches are all enqueued before the card reaches
    them and the card's own time is read."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if run_ahead:
        busy = torch.empty(4096, 4096, device="cuda")
        for _ in range(2):
            torch.mm(busy, busy)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Checks:
    def __init__(self):
        self.failed = []

    def __call__(self, ok: bool, what: str):
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.failed.append(what)


def wire_segments(item, device):
    """(edges (2K, E_tot), meta (2K, 3, B)) of a stacked (query, key)
    item, in the order featurize_stacked uses."""
    import torch

    from gcc_tpu_torch.wire import wire_to_device

    eq, mq = wire_to_device(item[0], device)
    ek, mk = wire_to_device(item[1], device)
    k = mq.shape[0]
    return (torch.stack([eq, ek], 1).reshape(2 * k, -1),
            torch.stack([mq, mk], 1).reshape(2 * k, 3, -1))


def check_featurize(edges, meta, n_max, check):
    import torch

    from gcc_tpu_torch.ops.aggregate import (
        fused_adjacency_featurize,
        fused_adjacency_featurize_plain,
    )

    adj, ms, deg = fused_adjacency_featurize(edges, meta, n_max, 8)
    torch.cuda.synchronize()
    adj0, ms0, deg0 = fused_adjacency_featurize_plain(edges, meta, n_max, 8)
    err = (ms - ms0).abs().max().item()
    check(torch.equal(adj, adj0) and torch.equal(deg, deg0),
          f"featurize N={n_max}: adjacency and degrees equal the plain version")
    check(err <= 1e-6, f"featurize N={n_max}: m_shift max abs err {err:.3g}"
          " <= 1e-6")
    g = adj.shape[0]
    ms_k = timed_ms(lambda: fused_adjacency_featurize(edges, meta, n_max, 8),
                    20)
    ms_p = timed_ms(lambda: fused_adjacency_featurize_plain(
        edges, meta, n_max, 8), 5)
    nbytes = edges.numel() * edges.element_size() + meta.numel() * 4 \
        + g * n_max * n_max * 8 + g * n_max * 4
    ops = 3 * g * n_max * n_max
    bound = max(nbytes / PEAK_BYTES, ops / PEAK_F32) * 1e3
    print(f"featurize N={n_max} graphs={g}: kernel {ms_k:.4f} ms, plain "
          f"{ms_p:.4f} ms, bound {bound:.4f} ms (bytes)"
          + versus("featurize", n_max, ms_k, bound), flush=True)
    return dict(ms=ms_k, plain_ms=ms_p, bound_ms=bound, max_abs_err=err,
                bound_by="bytes" if nbytes / PEAK_BYTES >= ops / PEAK_F32
                else "operations", shape=f"({g}, {n_max}, {n_max})"), \
        (adj, ms, deg)


def pe_flops(n: int, k: int, iters=16, orth_every=4, ns_steps=4, polish=2,
             final_ns=8):
    """(bf16-input, f32) operations of one graph's subspace iteration, as
    the function needs them: a power step 2·n²·k; a Newton-Schulz step
    one symmetric Gram matrix (its k(k+1)/2 distinct entries, n·k(k+1))
    and one (k, k)·(k, n) product (2·n·k²). Terms of order n·k (column
    norms, scaling, the 1.5·Q - 0.5·GQ update) are left out."""
    rounds = max(1, iters // orth_every)
    ns = n * k * (k + 1) + 2 * n * k * k
    bf16 = 2 * n * n * k * iters + rounds * ns_steps * ns
    f32 = 2 * n * n * k * polish + final_ns * ns
    return bf16, f32


def versus(name, key, ms, bound) -> str:
    """' — x.x% of its bound[; earlier t ms (which), s.sx faster]'."""
    out = f" — {100 * bound / ms:.1f}% of its bound"
    if (name, key) in EARLIER_MS:
        old, which = EARLIER_MS[(name, key)]
        out += f"; {old} ms with {which}: {old / ms:.2f}x"
    return out


def check_pe(m_shift, n_nodes, k, check, timed=True, key=None, small=False,
             require_well=True):
    """Kernel 2 vs its plain version on every graph of the batch; `key`
    names the row (EARLIER_MS) where it is not N at k = 32. `small`: a
    batch of graphs with fewer nodes than 2k (the node path's RWR views in
    a large bucket) — no projector is compared, and the mean error is
    taken over the live rows only (the padding is exact zeros in both
    versions and would dilute it). The bound of every row counts each
    graph's live nodes, rounded up to 32, in place of the padded N: the
    kernels run their products over the live rows and columns only. Its
    bytes are M and q0 read at that size and the whole output written.

    f32 rounds: the same arithmetic with the f32 sums in another order —
    max abs err <= 1e-5. bf16 rounds (production): both round the same
    values to bf16, but a sum that differs in its last f32 bit can round
    to the neighbouring bf16 value, a 2^-8 relative step the iteration
    carries on — mean abs err <= 1e-4, max abs err <= 2e-2, and on
    graphs of at least 2k nodes (where the k-column block is well
    conditioned) the spanned subspaces, as projectors QQᵀ, within 1e-2.
    Orthonormality is a property of the algorithm on each graph, the
    same in both versions: reported, not checked. `require_well` False:
    a batch may hold no graph of 2k nodes (k = 64 in the 128 bucket);
    the projector is then compared on none."""
    import torch

    from gcc_tpu_torch.features.positional import subspace_start
    from gcc_tpu_torch.ops.pe import (
        pe_subspace_iterate,
        pe_subspace_iterate_plain,
    )

    g, n, _ = m_shift.shape
    mask = (torch.arange(n, device=n_nodes.device)[None, :]
            < n_nodes[:, None]).float()
    q0 = subspace_start(n, k, mask)
    well = n_nodes >= 2 * k
    if not small and require_well:
        check(bool(well.any()), f"pe N={n}: batch has graphs of >= 2k nodes")
    out = {}
    for lo in (False, True):
        q = pe_subspace_iterate(m_shift, q0, iters=16, power_lo=lo)
        torch.cuda.synchronize()
        q_ref = pe_subspace_iterate_plain(m_shift, q0, iters=16, power_lo=lo)
        diff = (q - q_ref).abs()
        err = diff.max().item()
        mean = ((diff * mask[:, :, None]).sum() / (mask.sum() * k)).item() \
            if small else diff.mean().item()
        proj = (torch.bmm(q[well], q[well].transpose(1, 2))
                - torch.bmm(q_ref[well], q_ref[well].transpose(1, 2))
                ).abs().max().item() if bool(well.any()) else 0.0
        eye = torch.eye(k, device=q.device)
        orth = (torch.bmm(q.transpose(1, 2), q) - eye).abs().amax((1, 2))
        orth_ref = (torch.bmm(q_ref.transpose(1, 2), q_ref) - eye
                    ).abs().amax((1, 2))
        tag = ("bf16" if lo else "f32") + ("" if timed else f" k={k} g={g}")
        print(f"pe N={n} {tag} rounds, {g} graphs ({int(well.sum())} of >= "
              f"2k nodes): max abs err {err:.3g}, mean {mean:.3g}"
              f"{' (live rows)' if small else ''}, "
              f"projector err (>= 2k nodes) {proj:.3g}; orthonormal to 1e-3: "
              f"kernel {int((orth <= 1e-3).sum())}, plain "
              f"{int((orth_ref <= 1e-3).sum())} graphs", flush=True)
        check(bool(torch.isfinite(q).all()), f"pe N={n} {tag}: finite")
        if lo:
            check(mean <= PE_MEAN_LIMIT and err <= PE_MAX_LIMIT
                  and proj <= PROJECTOR_LIMIT,
                  f"pe N={n} {tag}: mean {mean:.3g} <= {PE_MEAN_LIMIT}, max "
                  f"{err:.3g} <= {PE_MAX_LIMIT}, projector {proj:.3g} <= "
                  f"{PROJECTOR_LIMIT}")
            out.update(max_abs_err=err, mean=mean)
        else:
            check(err <= 1e-5,
                  f"pe N={n} {tag}: max abs err {err:.3g} <= 1e-5")
    if not timed:
        return out, q
    ms_k = timed_ms(lambda: pe_subspace_iterate(m_shift, q0, iters=16), 3)
    ms_p = timed_ms(lambda: pe_subspace_iterate_plain(m_shift, q0, iters=16),
                    2)
    live = [min(n, -(-int(v) // 32) * 32) for v in n_nodes.tolist()]
    t_ops = sum(lo_ops / PEAK_BF16 + f32_ops / PEAK_F32
                for lo_ops, f32_ops in (pe_flops(v, k) for v in live))
    t_bytes = sum(v * v + v * k + n * k for v in live) * 4 / PEAK_BYTES
    bound = max(t_ops, t_bytes) * 1e3
    print(f"pe N={n}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, bound "
          f"{bound:.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'})"
          + versus("pe", key if key is not None else n if k == 32 else None,
                   ms_k, bound), flush=True)
    out.update(ms=ms_k, plain_ms=ms_p, bound_ms=bound,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               shape=f"({g}, {n}, {n}), k={k}")
    return out, q


def check_jacobi(t, check, timed=True, key=None, sweeps=RR_SWEEPS,
                 exact=False):
    import torch

    from gcc_tpu_torch.ops.jacobi import jacobi_eigh, jacobi_eigh_plain

    b, n, _ = t.shape
    w, v = jacobi_eigh(t, sweeps=sweeps, descending=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    w0, v0 = jacobi_eigh_plain(t, sweeps=sweeps, descending=True)
    end.record()
    torch.cuda.synchronize()
    check_ms = start.elapsed_time(end)
    err = max((w - w0).abs().max().item(), (v - v0).abs().max().item())
    # Same rounds, every operation correctly rounded in both versions
    # (`exact`: held to 0, the rule of the widths PE 64 adds).
    limit = 0.0 if exact else 1e-6
    check(err <= limit, f"jacobi ({b}, {n}, {n}): max abs err {err:.3g} "
          f"<= {limit:g}")
    check(bool(torch.isfinite(w).all() and torch.isfinite(v).all()),
          f"jacobi ({b}, {n}, {n}): finite")
    if not timed:
        return None
    ms_k = timed_ms(lambda: jacobi_eigh(t, sweeps=sweeps, descending=True),
                    20, run_ahead=True)
    # The plain version takes seconds at (4, 512, 512): its checking call
    # is then its measurement, and else its warm-up.
    ms_p = check_ms
    if ms_p < SLOW_LIBRARY_MS:
        ms_p = timed_ms(lambda: jacobi_eigh_plain(t, sweeps=sweeps,
                                                  descending=True), 3,
                        warmup=0)
    # torch.linalg.eigh takes seconds at (4096, 64, 64): one call is then
    # its measurement (its solver is warm from the smaller shapes before).
    ms_l = timed_ms(lambda: torch.linalg.eigh(t), 1, warmup=0)
    if ms_l < SLOW_LIBRARY_MS:
        ms_l = timed_ms(lambda: torch.linalg.eigh(t), 5, run_ahead=True)
    # Operations per round, f32: the row mix and the column mix of A and
    # the V^T update, 3 n^2 each (two products and a sum per entry), and
    # about 20 per pivot pair for the rotation; sweeps (n-1) rounds.
    ops = b * sweeps * (n - 1) * (9 * n * n + 10 * n)
    nbytes = b * (2 * n * n + n) * 4
    bound = max(ops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3
    print(f"jacobi ({b}, {n}, {n}) sweeps={sweeps}: kernel {ms_k:.4f} ms, "
          f"plain {ms_p:.4f} ms, torch.linalg.eigh {ms_l:.4f} ms, bound "
          f"{bound:.4f} ms (operations)"
          + versus("jacobi", key if key is not None else n, ms_k, bound),
          flush=True)
    return dict(ms=ms_k, plain_ms=ms_p, library_ms=ms_l, bound_ms=bound,
                bound_by="operations" if ops / PEAK_F32 >= nbytes / PEAK_BYTES
                else "bytes", max_abs_err=err,
                shape=f"({b}, {n}, {n})"
                + ("" if sweeps == RR_SWEEPS else f", {sweeps} sweeps"))


def rr_matrices(m_shift, q):
    """The Rayleigh-Ritz matrices T = Qᵀ M Q the PE finish hands to the
    Jacobi kernel (features/positional.py subspace_topk)."""
    import torch

    q = torch.nan_to_num(q, nan=0.0, posinf=0.0, neginf=0.0)
    t = torch.bmm(q.transpose(1, 2), torch.bmm(m_shift, q))
    return 0.5 * (t + t.transpose(1, 2))


def profiled_idle_share(fn, label: str) -> None:
    """Wall time, kernel launches, device busy time and idle share of
    fn() under torch.profiler (kernel records only), and its top
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t_all = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # Kernel records only: an operator's device time is its kernels', and
    # a user annotation's device range (the optimizer's
    # "Optimizer.step#Adam.step") spans kernels counted on their own.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"profiled {label}: wall {wall_ms:.1f} ms (profiler on), "
          f"{launches} kernel launches, device busy {busy_ms:.1f} ms, idle "
          f"share {1 - busy_ms / wall_ms:.3f} (the profiler's own set-up and "
          f"reading {time.time() - t_all - wall_ms / 1e3:.1f} s)", flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:90]}",
              flush=True)


def first_steps(wire, steps: int):
    """The first `steps` steps of a stacked wire batch."""
    import dataclasses

    return dataclasses.replace(wire, edges=wire.edges[:steps],
                               meta=wire.meta[:steps])


def where_the_time_goes(state, item, cfg):
    """Split one routed dispatch: featurize alone (CUDA events), then a
    profiled dispatch — wall time, device busy time (sum of kernel self
    times; one stream, so kernels do not overlap) and the kernels that
    take most of it. Runs after the dispatches' launch counts are read."""
    from gcc_tpu_torch.training import featurize_stacked, train_dispatch

    pos = cfg.encoder.positional_embedding_size
    feat_ms = timed_ms(lambda: featurize_stacked(item[0], item[1], pos,
                                                 n_max=N_MAX), 3)
    print(f"featurize of one routed dispatch ({2 * STEPS * BATCH} graphs, "
          f"N={item[0].n_max}): {feat_ms:.3f} ms (CUDA events)", flush=True)
    head = [first_steps(w, PROFILED_STEPS) for w in item]
    profiled_idle_share(lambda: train_dispatch(state, *head, n_max=N_MAX),
                        f"routed dispatch of its first {PROFILED_STEPS} steps")


def random_graphs(seed: int, count: int, lo: int, hi: int):
    """Seeded connected random graphs (a ring plus 2n chords, symmetric)
    of lo..hi nodes, as CSR graphs."""
    import numpy as np

    from gcc_tpu_torch.graph.csr import CSRGraph

    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(count):
        n = int(rng.integers(lo, hi + 1))
        ring = np.arange(n)
        u = np.concatenate([ring, rng.integers(0, n, 2 * n)])
        v = np.concatenate([(ring + 1) % n, rng.integers(0, n, 2 * n)])
        keep = u != v
        graphs.append(CSRGraph.from_edges(u[keep], v[keep], num_nodes=n,
                                          symmetrize=True))
    return graphs


def reddit_graphs(seed: int, count: int):
    """Seeded graphs shaped like REDDIT-BINARY's and REDDIT-MULTI-5K's
    large threads: lo..hi nodes (the last one exactly hi), a random
    recursive tree (each node replies to an earlier one) plus 0.15·n
    random chords, mean degree ~2.3."""
    import numpy as np

    from gcc_tpu_torch.graph.csr import CSRGraph

    rng = np.random.default_rng(seed)
    lo, hi = REDDIT_NODES
    graphs = []
    for i in range(count):
        n = hi if i == count - 1 else int(rng.integers(lo, hi + 1))
        parent = (rng.random(n - 1) * np.arange(1, n)).astype(np.int64)
        chords = int(REDDIT_CHORDS * n)
        u = np.concatenate([np.arange(1, n), rng.integers(0, n, chords)])
        v = np.concatenate([parent, rng.integers(0, n, chords)])
        keep = u != v
        graphs.append(CSRGraph.from_edges(u[keep], v[keep], num_nodes=n,
                                          symmetrize=True))
    return graphs


def uniform_graph(seed: int, n: int, undirected_edges: int):
    """A seeded graph of n nodes and exactly `undirected_edges` distinct
    undirected edges drawn uniformly (no self-loops), both directions
    stored."""
    import numpy as np

    from gcc_tpu_torch.graph.csr import CSRGraph

    rng = np.random.default_rng(seed)
    draw = int(undirected_edges * 1.05) + 1024
    u, v = rng.integers(0, n, draw), rng.integers(0, n, draw)
    keep = u != v
    key = np.unique(np.minimum(u, v)[keep] * n + np.maximum(u, v)[keep])
    key = rng.permutation(key)[:undirected_edges]
    if len(key) < undirected_edges:
        raise ValueError("too few distinct edges drawn")
    return CSRGraph.from_edges(key // n, key % n, num_nodes=n,
                               symmetrize=True)


def community_graph(seed: int, n_comm: int, size: int):
    """Communities of alternating density joined by sparse links: the
    structure-derived label task of the repository's end-to-end test, at
    n_comm * size nodes."""
    import numpy as np

    from gcc_tpu_torch.graph.csr import CSRGraph

    rng = np.random.default_rng(seed)
    src, dst = [], []
    for c in range(n_comm):
        ring = np.arange(size)
        extra = 3 * size if c % 2 == 0 else size // 2
        src += [ring, rng.integers(0, size, extra)]
        dst += [(ring + 1) % size, rng.integers(0, size, extra)]
        src[-2:] = [x + c * size for x in src[-2:]]
        dst[-2:] = [x + c * size for x in dst[-2:]]
    src.append(rng.integers(0, n_comm * size, 2 * n_comm))
    dst.append(rng.integers(0, n_comm * size, 2 * n_comm))
    src, dst = np.concatenate(src), np.concatenate(dst)
    keep = src != dst
    return CSRGraph.from_edges(src[keep], dst[keep], num_nodes=n_comm * size,
                               symmetrize=True)


def subgraph_operator(subgraphs, n_max, e_max, device):
    """(m_shift (B, N, N), n_nodes (B,)) of a batch of subgraphs, as
    featurize_batch derives them on the generate path."""
    import torch

    from gcc_tpu_torch.graph.batch import batch_subgraphs
    from gcc_tpu_torch.ops.aggregate import (
        build_dense_adjacency,
        normalized_adjacency,
        shifted_operator,
    )

    batch = batch_subgraphs(subgraphs, n_max=n_max, e_max=e_max)
    up = lambda x: torch.as_tensor(x).to(device)  # noqa: E731
    mask = up(batch.node_mask)
    adj = build_dense_adjacency(up(batch.edges_src), up(batch.edges_dst),
                                up(batch.edge_weight), len(subgraphs), n_max)
    return (shifted_operator(normalized_adjacency(adj, mask), mask),
            up(batch.n_nodes))


def entire_graph_operator(graphs, n_max, e_max, device):
    from gcc_tpu_torch.generate import graph_subgraphs

    return subgraph_operator(graph_subgraphs(graphs), n_max, e_max, device)


def guarded_rr_matrices(m_shift, q):
    """The two matrices the eval profile hands to the Jacobi kernel per
    encode call (features/positional.py subspace_topk): the regularized
    Gram S of the guarded basis, and T = (QW)ᵀ M (QW) of the basis
    whitened by S's eigenpairs."""
    import torch

    from gcc_tpu_torch.ops.jacobi import jacobi_eigh

    q = torch.nan_to_num(q, nan=0.0, posinf=0.0, neginf=0.0)
    s_g = torch.bmm(q.transpose(1, 2), q)
    s_g = 0.5 * (s_g + s_g.transpose(1, 2))
    s_g = s_g + 1e-5 * torch.eye(q.shape[2], device=q.device)
    sv, v = jacobi_eigh(s_g, sweeps=RR_SWEEPS, descending=True)
    floor = 0.1 * sv[:, :1]
    w = v * (torch.rsqrt(torch.maximum(sv, floor))
             * (sv > floor).float())[:, None, :]
    return s_g, rr_matrices(m_shift, torch.bmm(q, w))


@contextlib.contextmanager
def jacobi_inputs(module):
    """A list that gets a copy of every matrix module.jacobi_eigh is
    handed while the block runs (the giant PE's finish looks it up in its
    module)."""
    recorded, real = [], module.jacobi_eigh
    module.jacobi_eigh = lambda a, **kw: (recorded.append(a.clone())
                                          or real(a, **kw))
    try:
        yield recorded
    finally:
        module.jacobi_eigh = real


@contextlib.contextmanager
def giant_pes(module):
    """A list that gets a copy (on the device, no sync) of every PE that
    module.giant_input_features is handed while the block runs: the
    rows of the PE inside giant_graph_embedding."""
    recorded, real = [], module.giant_input_features

    def recording(model, g, pe, *args):
        recorded.append(pe.clone())
        return real(model, g, pe, *args)

    module.giant_input_features = recording
    try:
        yield recorded
    finally:
        module.giant_input_features = real


@contextlib.contextmanager
def plain_version_calls():
    """Count calls of the kernels' plain versions while the block runs
    (the wrappers look them up in their modules, so wrapping the module
    attributes sees every call)."""
    from gcc_tpu_torch.ops import aggregate, jacobi, pe

    targets = ((aggregate, "fused_adjacency_featurize_plain"),
               (pe, "pe_subspace_iterate_plain"),
               (jacobi, "jacobi_eigh_plain"))
    calls = {name: 0 for _, name in targets}
    originals = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for mod, name, fn in originals:
        setattr(mod, name, counting(name, fn))
    try:
        yield calls
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


def counted(ops, fn):
    """fn() with the launch counters zeroed just before and read just
    after: (result, launches, plain-version calls, seconds)."""
    import torch

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with plain_version_calls() as plain:
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        dt = time.time() - t0
    return out, ops.launch_counts(), dict(plain), dt


def serve_path(ops, cfg, corpus_dir, out_dir, check, results):
    """pre-train → checkpoint → restore → generate, through the entry
    points, at full width. Returns ({shape key: launches} of the eval
    shapes of Kernels 2 and 3, the checkpoint's path, its configuration);
    adds to `results` the row of Kernel 2 on a batch of the node path
    (RWR views in the 512 bucket)."""
    import dataclasses

    import numpy as np
    import torch

    from gcc_tpu_torch import generate
    from gcc_tpu_torch.sampling.pipeline import PipelineConfig
    from gcc_tpu_torch.training import checkpoint, loop
    from gcc_tpu_torch.training.pretrain import create_pretrain_state

    # -- run_pretrain: one epoch of 4 routed dispatches, a checkpoint ----
    dispatches = 4
    run_cfg = dataclasses.replace(
        cfg, epochs=1, num_workers=1,
        num_samples=dispatches * STEPS * BATCH)
    pcfg = PipelineConfig(batch_size=BATCH, n_max=N_MAX, e_max=E_MAX,
                          num_samples=run_cfg.num_samples, num_workers=1,
                          prefetch=4, emit="routed", n_small=N_SMALL)
    live = {}
    save = loop.save_checkpoint

    def save_and_keep(path, state, cfg_, step=None):
        # The live state at the moment the checkpoint is written.
        live["model"] = copy.deepcopy(state.model.state_dict())
        live["ema"] = copy.deepcopy(state.ema_model.state_dict())
        live["queue"] = state.queue.memory.clone()
        live["step"] = state.step
        return save(path, state, cfg_, step)

    loop.save_checkpoint = save_and_keep
    try:
        summary, launches, plain, dt = counted(ops, lambda: loop.run_pretrain(
            run_cfg, corpus_dir, out_dir, pcfg, log_fn=lambda s: None,
            steps_per_call=STEPS))
    finally:
        loop.save_checkpoint = save
    steps = dispatches * STEPS
    print(f"run_pretrain: {summary['steps']} steps in {dt:.1f} s with "
          f"pipeline start-up (training wall {summary['wall']:.2f} s, "
          f"{summary['wall'] / steps * 1e3:.3f} ms/step), avg loss "
          f"{summary['avg_loss']:.4f}; kernel launches {launches}, "
          f"plain-version calls {plain}", flush=True)
    check(summary["steps"] == steps and summary["epoch"] == 1
          and summary["steps_per_epoch_skipped"] == 0,
          f"run_pretrain took {summary['steps']} steps in whole dispatches")
    check(all(c == dispatches for c in launches.values()),
          f"run_pretrain: one launch of each kernel per dispatch {launches}")
    check(not any(plain.values()), "run_pretrain: no plain-version call")
    with open(os.path.join(summary["run_dir"], "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    check(len(lines) == steps and all(math.isfinite(r["loss"]) for r in lines),
          f"metrics.jsonl: {len(lines)} finite lines")

    # -- checkpoint round trip ------------------------------------------
    ckpt = os.path.join(summary["run_dir"], "current")
    cfg2 = checkpoint.load_config(summary["run_dir"])
    check(cfg2 == run_cfg, "config sidecar restores the configuration")
    state = checkpoint.load_checkpoint(
        ckpt, create_pretrain_state(cfg2, steps, seed=123, device="cuda"))
    same = (all(torch.equal(v, live["model"][k])
                for k, v in state.model.state_dict().items())
            and all(torch.equal(v, live["ema"][k])
                    for k, v in state.ema_model.state_dict().items())
            and torch.equal(state.queue.memory, live["queue"]))
    check(same and state.step == live["step"] == steps,
          "restored encoders and queue equal the live ones bit for bit")

    # -- generate: node embeddings, two RWR views ------------------------
    g = community_graph(0, 32, COMMUNITY_NODES // 32)
    t0 = time.time()
    subs, subs_k = generate.node_subgraphs(g, cfg2, GEN_N_MAX, GEN_E_MAX,
                                           two_views=True)
    sizes = np.array([s.num_nodes for s in subs + subs_k])
    print(f"node_subgraphs: 2 x {len(subs)} RWR views in "
          f"{time.time() - t0:.1f} s; nodes mean {sizes.mean():.1f}, max "
          f"{sizes.max()}", flush=True)
    # Kernel 2 on the first batch of the node path: mostly padding, so the
    # streamed plan's time is its chain of steps on one or two live warps.
    m_node, n_node = subgraph_operator(subs[:GEN_BATCH], GEN_N_MAX, GEN_E_MAX,
                                       "cuda")
    print(f"node-path batch in bucket {GEN_N_MAX}: {GEN_BATCH} RWR views, "
          f"nodes mean {n_node.float().mean().item():.1f}, max "
          f"{int(n_node.max())}", flush=True)
    results[("pe", "512node")], _ = check_pe(m_node, n_node, K_EVAL, check,
                                             key="512node", small=True)
    del m_node
    gen = dict(n_max=GEN_N_MAX, e_max=GEN_E_MAX, batch_size=GEN_BATCH)
    generate.generate_embeddings(cfg2, state, subs[:GEN_BATCH], **gen)  # warm
    emb, launches, plain, dt = counted(ops, lambda: generate.generate_embeddings(
        cfg2, state, subs, subgraphs_k=subs_k, **gen))
    calls = 2 * len(subs) // GEN_BATCH
    print(f"generate_embeddings: {len(subs)} nodes, {calls} encode calls of "
          f"{GEN_BATCH} graphs at N={GEN_N_MAX} in {dt * 1e3:.1f} ms: "
          f"{dt * 1e3 / calls:.3f} ms per encode call, {len(subs) / dt:.1f} "
          f"embeddings/s (two views each; host clock, synchronized); kernel "
          f"launches {launches}, plain-version calls {plain}", flush=True)
    check(emb.shape == (g.num_nodes, cfg2.encoder.output_size)
          and bool(np.isfinite(emb).all()),
          f"node embeddings {emb.shape} finite")
    check(launches == {"featurize": 0, "pe": calls, "jacobi": 2 * calls},
          f"generate: Kernel 2 once and Kernel 3 twice per encode call "
          f"{launches}")
    check(not any(plain.values()), "generate: no plain-version call")
    # The node path's launches of Kernel 2 count for its own row; the
    # graph path's below for the row of full 512 buckets.
    eval_launches = {("pe", "512node"): launches["pe"],
                     ("pe", GEN_N_MAX): 0,
                     ("jacobi", GEN_BATCH): launches["jacobi"]}

    # The same call on the CPU (the plain versions), first 64 nodes.
    t0 = time.time()
    ref = generate.generate_embeddings(
        cfg2, state, subs[:GEN_BATCH], subgraphs_k=subs_k[:GEN_BATCH],
        device="cpu", **gen)
    got = emb[:GEN_BATCH]
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1)
                                 * np.linalg.norm(ref, axis=-1))
    max_abs = float(np.abs(got - ref).max())
    print(f"card vs CPU, first {GEN_BATCH} node embeddings: max abs "
          f"{max_abs:.4g}, cosine mean {cos.mean():.6f} min {cos.min():.6f} "
          f"({time.time() - t0:.1f} s on the CPU)", flush=True)
    check(cos.mean() >= CPU_MIN_MEAN_COS and max_abs <= CPU_MAX_ABS,
          f"card vs CPU: mean cosine {cos.mean():.4f} >= {CPU_MIN_MEAN_COS}, "
          f"max abs {max_abs:.3g} <= {CPU_MAX_ABS}")

    # -- generate: graph embeddings, both readouts -----------------------
    graphs = random_graphs(1, 256, 100, 500)
    for readout, width in (("score", cfg2.encoder.output_size),
                           ("composite", cfg2.encoder.node_input_dim
                            + (cfg2.encoder.num_layers - 1)
                            * cfg2.encoder.hidden_size)):
        gemb, launches, plain, dt = counted(
            ops, lambda: generate.generate_graph_embeddings(
                cfg2, state, graphs, readout=readout, **gen))
        calls = len(graphs) // GEN_BATCH
        print(f"generate_graph_embeddings readout={readout}: {gemb.shape} in "
              f"{dt * 1e3:.1f} ms ({dt * 1e3 / calls:.3f} ms per encode "
              f"call); kernel launches {launches}", flush=True)
        check(gemb.shape == (len(graphs), width)
              and bool(np.isfinite(gemb).all()),
              f"graph embeddings ({readout}) {gemb.shape} finite")
        check(launches == {"featurize": 0, "pe": calls, "jacobi": 2 * calls}
              and not any(plain.values()),
              f"graph embeddings ({readout}): launches {launches}, no "
              "plain-version call")
        eval_launches[("pe", GEN_N_MAX)] += launches["pe"]
        eval_launches[("jacobi", GEN_BATCH)] += launches["jacobi"]

    # -- the other eval shapes, through the entry points -----------------
    small = [s for s in subs if s.num_nodes <= N_MAX][:512]
    check(len(small) == 512, f"512 RWR views fit the {N_MAX} bucket")
    ro, launches, plain, dt = counted(
        ops, lambda: generate.generate_subgraph_readouts(
            cfg2, state, small, n_max=N_MAX, e_max=GEN_E_MAX,
            batch_size=128))
    check(ro["score"].shape == (len(small), cfg2.encoder.output_size)
          and bool(np.isfinite(ro["score"]).all())
          and launches == {"featurize": 0, "pe": 4, "jacobi": 8}
          and not any(plain.values()),
          f"readouts at (128, {N_MAX}): finite, launches {launches}")
    eval_launches[("pe", f"{N_MAX}k{K_EVAL}")] = launches["pe"]
    eval_launches[("jacobi", 128)] = launches["jacobi"]
    big = random_graphs(2, GEN_BATCH, 520, 832)
    gemb, launches, plain, dt = counted(
        ops, lambda: generate.generate_graph_embeddings(
            cfg2, state, big, n_max=832, e_max=GEN_E_MAX,
            batch_size=GEN_BATCH))
    print(f"generate_graph_embeddings at n_max=832: {gemb.shape} in "
          f"{dt * 1e3:.1f} ms; kernel launches {launches}", flush=True)
    check(bool(np.isfinite(gemb).all())
          and launches == {"featurize": 0, "pe": 1, "jacobi": 2}
          and not any(plain.values()),
          f"graph embeddings at n_max=832: finite, launches {launches}")
    eval_launches[("pe", 832)] = launches["pe"]
    eval_launches[("jacobi", GEN_BATCH)] += launches["jacobi"]

    profiled_idle_share(lambda: generate.generate_embeddings(
        cfg2, state, subs[:8 * GEN_BATCH], **gen), "stretch of 8 encode calls")
    return eval_launches, ckpt, cfg2


def pe_errors(a, b, mask):
    """Per graph of two PE batches (G, N, pos) with node mask (G, N): the
    sum of |a - b| over the live rows' first k_b = min(n - 2, pos)
    columns (the others are zero in both), their count, and the max."""
    import torch

    pos = a.shape[-1]
    k_b = (mask.sum(1) - 2).clamp(0, pos)
    live = mask[:, :, None] * (torch.arange(pos) < k_b[:, None])[:, None, :]
    d = (a - b).abs() * live
    return d.sum((1, 2)), live.sum((1, 2)), d.amax((1, 2))


def separated_spectra(adj, mask, pos, gap=0.02) -> int:
    """How many graphs have their top k_b + 1 eigenvalues of D^-1/2 A
    D^-1/2 (float64, live block) at least `gap` apart, k_b > 0."""
    import numpy as np

    count = 0
    for a, m in zip(adj.double().numpy(), mask.numpy()):
        n = int(m.sum())
        k_b = min(max(n - 2, 0), pos)
        if k_b == 0:
            continue
        a = a[:n, :n]
        d = np.sqrt(np.maximum(a.sum(1), 1.0))
        lam = np.linalg.eigvalsh(a / d[:, None] / d[None, :])[::-1][:k_b + 1]
        count += bool(np.min(-np.diff(lam)) >= gap)
    return count


def pe_card_vs_cpu(got, ref, classes, pos, profile="train",
                   nudges=(math.inf, -math.inf)):
    """One E2E step's features on the card (`got`) against the CPU's
    (`ref`), class by class: whether adjacency, degrees, masks and seed
    flags are equal; the PE's coordinate errors (pe_errors: mean over
    live rows x k_b columns, max) and its row cosines' errors (pos·posᵀ:
    mean over pairs of live rows, max); the same for the witness, the
    CPU plain path against itself under a 1-ulp change of every nonzero
    m_shift entry, up and down (`nudges`; the PE at `profile`); and how
    many views have separated spectra."""
    import torch

    from gcc_tpu_torch.features.positional import (
        laplacian_positional_embedding,
    )
    from gcc_tpu_torch.ops.aggregate import normalized_adjacency, shifted_operator

    def cosine_errors(a, b, mask):
        d = (torch.bmm(a, a.transpose(1, 2))
             - torch.bmm(b, b.transpose(1, 2))).abs()
        return (d.sum((1, 2)), mask.sum(1) ** 2, d.amax((1, 2)))

    exact = True
    errs = {"": [], "cos_": [], "ulp_": [], "ulp_cos_": []}
    views = separated = 0
    for (n_b, _), g, r in zip(classes, got, ref):
        for name in ("adj", "degrees", "node_mask", "seed_flag"):
            exact &= torch.equal(getattr(g, name).cpu(), getattr(r, name))
        mask = r.node_mask.reshape(-1, n_b)
        adj = r.adj.reshape(-1, n_b, n_b)
        base = r.pos.reshape(-1, n_b, pos)
        on_card = g.pos.cpu().reshape(base.shape)
        errs[""].append(pe_errors(on_card, base, mask))
        errs["cos_"].append(cosine_errors(on_card, base, mask))
        m_shift = shifted_operator(normalized_adjacency(adj, mask), mask)
        for to in nudges:
            nudged = laplacian_positional_embedding(
                mask, mask.sum(1).to(torch.int32), pos,
                m_shift=torch.where(m_shift != 0, torch.nextafter(
                    m_shift, torch.full_like(m_shift, to)), m_shift),
                profile=profile)
            errs["ulp_"].append(pe_errors(nudged, base, mask))
            errs["ulp_cos_"].append(cosine_errors(nudged, base, mask))
        views += mask.shape[0]
        separated += separated_spectra(adj, mask, pos)
    out = dict(views=views, separated=separated)
    for key, parts in errs.items():
        total, count, worst = (torch.cat(x) for x in zip(*parts))
        out[key + "mean"] = (total.sum() / count.sum()).item()
        out[key + "max"] = worst.max().item()
    return exact, out


def e2e_path(ops, corpus_dir, out_dir, check, results):
    """The reference's E2E headline through the entry points: run_pretrain
    (an epoch of E2E_DISPATCHES size-split dispatches, a checkpoint), then
    one dispatch with the launch counters zeroed, then one step's features
    and loss on the card against the CPU's. Adds the rows of Kernels 2 and
    3 at the two classes' shapes to `results`; returns their launches."""
    import dataclasses

    import torch

    from gcc_tpu_torch.config import ContrastConfig, SamplerConfig, TrainConfig
    from gcc_tpu_torch.graph.corpus import CorpusStore
    from gcc_tpu_torch.ops.aggregate import normalized_adjacency, shifted_operator
    from gcc_tpu_torch.sampling.pipeline import PipelineConfig, PretrainPipeline
    from gcc_tpu_torch.training import loop
    from gcc_tpu_torch.training.pretrain import (
        create_pretrain_state,
        e2e_split_step,
        featurize_e2e_split,
        parse_e2e_split,
        train_dispatch,
    )

    cfg = TrainConfig(batch_size=E2E_BATCH,
                      sampler=SamplerConfig(rw_hops=RW_HOPS),
                      contrast=ContrastConfig(moco=False, nce_k=E2E_BATCH - 1,
                                              e2e_split=E2E_SPEC))
    classes = parse_e2e_split(E2E_SPEC, E2E_BATCH, N_MAX)
    pcfg = PipelineConfig(batch_size=E2E_BATCH, n_max=N_MAX, e_max=E_MAX,
                          num_samples=E2E_DISPATCHES * E2E_STEPS * E2E_BATCH,
                          num_workers=1, prefetch=2, emit="stacked",
                          super_batch=E2E_STEPS)
    run_cfg = dataclasses.replace(cfg, epochs=1, num_workers=1,
                                  num_samples=pcfg.num_samples)
    summary, launches, plain, dt = counted(ops, lambda: loop.run_pretrain(
        run_cfg, corpus_dir, out_dir, pcfg, log_fn=lambda s: None,
        steps_per_call=E2E_STEPS))
    steps = E2E_DISPATCHES * E2E_STEPS
    with open(os.path.join(summary["run_dir"], "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    over = [r["e2e_split_overflow"] for r in lines if "e2e_split_overflow"
            in r]
    print(f"E2E run_pretrain (batch {E2E_BATCH}, split {classes}): "
          f"{summary['steps']} steps in {dt:.1f} s with pipeline start-up "
          f"(training wall {summary['wall']:.2f} s, "
          f"{summary['wall'] / steps * 1e3:.3f} ms/step), avg loss "
          f"{summary['avg_loss']:.4f}, overflow per step {over}; kernel "
          f"launches {launches}, plain-version calls {plain}", flush=True)
    check(summary["steps"] == steps and len(lines) == steps
          and len(over) == steps
          and all(math.isfinite(r["loss"]) for r in lines),
          f"E2E run_pretrain: {len(lines)} finite metric lines with the "
          "split's overflow")
    check(launches == {"featurize": 0, "pe": 2 * E2E_DISPATCHES,
                       "jacobi": 2 * E2E_DISPATCHES}
          and not any(plain.values()),
          f"E2E run_pretrain: Kernels 2 and 3 once per class and dispatch "
          f"{launches}, no plain-version call")
    check(os.path.exists(os.path.join(summary["run_dir"], "current")),
          "E2E run_pretrain wrote its checkpoint")

    with PretrainPipeline(CorpusStore.open(corpus_dir), cfg.sampler, pcfg,
                          seed=1) as pipe:
        wq, wk = next(pipe)
    state = create_pretrain_state(cfg, total_steps=1000, seed=0,
                                  device="cuda")
    metrics, launches, plain, dt = counted(
        ops, lambda: train_dispatch(state, wq, wk, n_max=N_MAX))
    loss = metrics["loss"].cpu()
    print(f"E2E dispatch: {E2E_STEPS} steps in {dt * 1e3:.1f} ms "
          f"({dt * 1e3 / E2E_STEPS:.3f} ms/step), loss first "
          f"{loss[0].item():.4f} last {loss[-1].item():.4f}, "
          f"e2e_split_overflow {metrics['e2e_split_overflow'].tolist()}; "
          f"kernel launches {launches}, plain-version calls {plain}",
          flush=True)
    check(loss.shape == (E2E_STEPS,) and bool(torch.isfinite(loss).all()),
          f"E2E dispatch: {E2E_STEPS} finite losses")
    check(launches == {"featurize": 0, "pe": 2, "jacobi": 2}
          and not any(plain.values()),
          f"E2E dispatch: Kernels 2 and 3 twice each {launches}, no "
          "plain-version call")
    e2e_launches = {name: launches[name] // len(classes)
                    for name in ("pe", "jacobi")}
    head = [first_steps(w, E2E_PROFILED_STEPS) for w in (wq, wk)]
    profiled_idle_share(lambda: train_dispatch(state, *head, n_max=N_MAX),
                        f"E2E dispatch of its first {E2E_PROFILED_STEPS} "
                        "steps")

    # Kernels 2 and 3 at the classes' shapes, on this dispatch's features.
    pos = cfg.encoder.positional_embedding_size
    feats, _ = featurize_e2e_split(wq, wk, pos, "subspace", classes,
                                   n_max=N_MAX)
    for (n_b, _), f in zip(classes, feats):
        mask = f.node_mask.reshape(-1, n_b)
        adj = f.adj.reshape(-1, n_b, n_b)
        m_shift = shifted_operator(normalized_adjacency(adj, mask), mask)
        n_nodes = mask.sum(1).to(torch.int32)
        print(f"E2E class {n_b}: {mask.shape[0]} graphs, nodes mean "
              f"{n_nodes.float().mean().item():.1f}, max "
              f"{int(n_nodes.max())}", flush=True)
        results[("pe", f"e2e{n_b}")], q = check_pe(m_shift, n_nodes, pos,
                                                   check, key=f"e2e{n_b}")
        results[("jacobi", f"e2e{n_b}")] = check_jacobi(
            rr_matrices(m_shift, q), check, key=f"e2e{n_b}")
        del m_shift, q
    del feats
    torch.cuda.empty_cache()

    # One step's features and loss, card against CPU, from equal weights.
    one = [dataclasses.replace(w, edges=w.edges[:1], meta=w.meta[:1])
           for w in (wq, wk)]
    got, over_c = featurize_e2e_split(*one, pos, "subspace", classes,
                                      n_max=N_MAX)
    ref, over_h = featurize_e2e_split(*one, pos, "subspace", classes,
                                      n_max=N_MAX, device="cpu")
    exact, pe = pe_card_vs_cpu(got, ref, classes, pos)
    check(exact and torch.equal(over_c.cpu(), over_h),
          "E2E features card vs CPU: overflow, adjacency, degrees, masks "
          "and seed flags equal")
    nodrop = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, final_dropout=0.0))
    losses = []
    for feats_, dev in ((got, "cuda"), (ref, "cpu")):
        st = create_pretrain_state(nodrop, total_steps=1000, seed=0,
                                   device=dev)
        losses.append(e2e_split_step(st, tuple(
            f.map(lambda x: x[0]) for f in feats_))["loss"].item())
    loss_diff = abs(losses[0] - losses[1])
    print(f"E2E card vs CPU, one step ({pe['views']} views, "
          f"{pe['separated']} with their top k_b + 1 eigenvalues >= 0.02 "
          f"apart): pos row cosines mean abs err {pe['cos_mean']:.4g}, max "
          f"{pe['cos_max']:.4g}; coordinates mean {pe['mean']:.4g}, max "
          f"{pe['max']:.4g}. Witness, the CPU plain path under a 1-ulp "
          f"change of m_shift: row cosines mean {pe['ulp_cos_mean']:.4g}, "
          f"max {pe['ulp_cos_max']:.4g}; coordinates mean "
          f"{pe['ulp_mean']:.4g}, max {pe['ulp_max']:.4g}. Loss "
          f"{losses[0]:.6f} vs {losses[1]:.6f} (diff {loss_diff:.3g})",
          flush=True)
    check(pe["cos_mean"] <= PE_MEAN_LIMIT and pe["cos_max"] <= PE_MAX_LIMIT,
          f"E2E card vs CPU: pos row cosines of all {pe['views']} views mean "
          f"abs err {pe['cos_mean']:.3g} <= {PE_MEAN_LIMIT}, max "
          f"{pe['cos_max']:.3g} <= {PE_MAX_LIMIT}")
    check(loss_diff <= E2E_LOSS_DIFF,
          f"E2E card vs CPU: loss diff {loss_diff:.3g} <= {E2E_LOSS_DIFF}")
    return e2e_launches


def alt_encoders(ops, cfg, item, check):
    """One routed MoCo dispatch in bucket 128 at full width with each
    alternate encoder: finite losses, parameters moved, queue advanced,
    each kernel launched once."""
    import dataclasses

    import torch

    from gcc_tpu_torch.training import create_pretrain_state, train_dispatch

    for name, kw in (("gat", dict(model="gat")), ("mpnn", dict(model="mpnn")),
                     ("gin+selayer", dict(use_selayer=True))):
        alt = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, **kw))
        state = create_pretrain_state(alt, total_steps=100_000, seed=0,
                                      device="cuda")
        p0 = [p.detach().clone() for p in state.model.parameters()]
        idx0 = int(state.queue.index)
        metrics, launches, plain, dt = counted(
            ops, lambda: train_dispatch(state, *item, n_max=N_MAX))
        loss = metrics["loss"].cpu()
        moved = sum(not torch.equal(a, b) for a, b in
                    zip(p0, state.model.parameters()))
        advanced = (int(state.queue.index) - idx0) % NCE_K
        print(f"alternate encoder {name}: {STEPS} routed MoCo steps in "
              f"{dt * 1e3:.1f} ms ({dt * 1e3 / STEPS:.3f} ms/step), loss "
              f"first {loss[0].item():.4f} last {loss[-1].item():.4f}; "
              f"{moved} of {len(p0)} parameter tensors moved; kernel "
              f"launches {launches}", flush=True)
        check(bool(torch.isfinite(loss).all()) and moved > 0
              and advanced == STEPS * BATCH % NCE_K,
              f"{name}: finite losses, parameters moved, queue advanced by "
              f"{advanced}")
        check(all(c == 1 for c in launches.values())
              and not any(plain.values()),
              f"{name}: every kernel launched once {launches}, no "
              "plain-version call")
        del state
    torch.cuda.empty_cache()


def two_class_graphs(seed: int, count: int, lo: int, hi: int):
    """Seeded graphs of lo..hi nodes in two structural classes, alternating:
    a ring with n/2 random chords (average degree ~3) and a ring with 5n
    (~12, under e_max 8192 at 500 nodes). Returns (graphs, labels)."""
    import numpy as np

    from gcc_tpu_torch.graph.csr import CSRGraph

    rng = np.random.default_rng(seed)
    graphs = []
    for i in range(count):
        n = int(rng.integers(lo, hi + 1))
        ring = np.arange(n)
        chords = n // 2 if i % 2 == 0 else 5 * n
        u = np.concatenate([ring, rng.integers(0, n, chords)])
        v = np.concatenate([(ring + 1) % n, rng.integers(0, n, chords)])
        keep = u != v
        graphs.append(CSRGraph.from_edges(u[keep], v[keep], num_nodes=n,
                                          symmetrize=True))
    return graphs, np.arange(count) % 2


def finetune_path(ops, cfg, ckpt, check, results):
    """Finetuning from the serve path's checkpoint (BatchNorm statistics
    reset): the graph path (entire graphs at n_max 512, batch 32, 3
    epochs, micro-F1 on held-out graphs) and the node path through the
    finetune command (RWR views of the community graph, labels =
    community, 1 epoch of fold 0). Adds the rows of
    Kernels 2 and 3 at the finetune shapes; returns their launches."""
    import dataclasses

    import numpy as np
    import torch

    from gcc_tpu_torch import cli
    from gcc_tpu_torch.training import checkpoint, finetune

    pretrained = checkpoint.load_checkpoint(ckpt)["model"]
    ft_cfg = dataclasses.replace(cfg, epochs=FT_EPOCHS, batch_size=FT_BATCH)
    graphs, labels = two_class_graphs(3, 256, 100, 500)
    data = finetune.GraphLabeledData(graphs, labels, n_max=GEN_N_MAX,
                                     e_max=GEN_E_MAX)
    perm = np.random.default_rng(0).permutation(len(labels))
    train_idx, test_idx = perm[:224], perm[224:]
    f1, launches, plain, dt = counted(ops, lambda: finetune.run_finetune_fold(
        ft_cfg, data, train_idx, test_idx, pretrained,
        log_fn=lambda s: print(f"  {s}", flush=True)))
    steps = FT_EPOCHS * len(train_idx) // FT_BATCH
    calls = steps + len(test_idx) // FT_BATCH
    print(f"finetune, graph path: {steps} steps + {calls - steps} eval "
          f"call(s) of {FT_BATCH} graphs at N={GEN_N_MAX} in {dt:.1f} s "
          f"({dt * 1e3 / calls:.1f} ms per call); micro-F1 {f1:.4f}; kernel "
          f"launches {launches}, plain-version calls {plain}", flush=True)
    check(f1 > FT_MIN_F1, f"finetune graph path: micro-F1 {f1:.4f} > "
          f"{FT_MIN_F1}")
    check(launches == {"featurize": 0, "pe": calls, "jacobi": 2 * calls}
          and not any(plain.values()),
          f"finetune graph path: Kernel 2 once, Kernel 3 twice per call "
          f"{launches}, no plain-version call")
    ft_launches = {("pe", "ft512"): launches["pe"],
                   ("jacobi", "ft32"): launches["jacobi"]}

    m_shift, n_nodes = entire_graph_operator(
        [graphs[i] for i in train_idx[:FT_BATCH]], GEN_N_MAX, GEN_E_MAX,
        "cuda")
    results[("pe", "ft512")], q = check_pe(m_shift, n_nodes, K_EVAL, check,
                                           key="ft512")
    s_g, t_rr = guarded_rr_matrices(m_shift, q)
    check_jacobi(s_g, check, timed=False)
    results[("jacobi", "ft32")] = check_jacobi(t_rr, check, key="ft32")
    del m_shift, q, s_g, t_rr
    torch.cuda.empty_cache()

    # The node path through the finetune command: the community graph
    # written as the usa_airport dataset, labels = its 32 communities,
    # fold 0 of the command's 10 stratified folds.
    g = community_graph(0, 32, COMMUNITY_NODES // 32)
    labels = np.arange(g.num_nodes) // (g.num_nodes // 32)
    data_root = os.path.join(os.path.dirname(os.path.dirname(ckpt)),
                             "ft_data")
    prefix = os.path.join(data_root, "struc2vec", "usa-airports")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    with open(prefix + ".edgelist", "w") as f:
        for u in range(g.num_nodes):
            f.writelines(f"{u} {v}\n" for v in g.neighbors(u) if u < v)
    with open(prefix + ".nodelabel", "w") as f:
        f.writelines(f"{u} {c}\n" for u, c in enumerate(labels))
    printed = io.StringIO()
    argv = ["finetune", "--ckpt", ckpt, "--dataset", "usa_airport",
            "--data-root", data_root, "--epochs", "1", "--batch-size",
            str(FT_BATCH), "--n-max", str(GEN_N_MAX), "--e-max",
            str(GEN_E_MAX)]
    with contextlib.redirect_stdout(printed):
        _, launches, plain, dt = counted(ops, lambda: cli.main(argv))
    res = ast.literal_eval(printed.getvalue().strip().splitlines()[-1])
    train_idx, test_idx = finetune.stratified_kfold(labels, 10, 0)[0]
    calls = -(-len(train_idx) // FT_BATCH) + -(-len(test_idx) // FT_BATCH)
    print(f"finetune, node path (`cli finetune --dataset usa_airport`, "
          f"{g.num_nodes} nodes, fold 0): 1 epoch of "
          f"{-(-len(train_idx) // FT_BATCH)} steps + "
          f"{-(-len(test_idx) // FT_BATCH)} eval calls in {dt:.1f} s; "
          f"micro-F1 {res['mean']:.4f} (32 communities); kernel launches "
          f"{launches}, plain-version calls {plain}", flush=True)
    check(math.isfinite(res["mean"]) and len(res["folds"]) == 1
          and launches == {"featurize": 0, "pe": calls, "jacobi": 2 * calls}
          and not any(plain.values()),
          f"finetune node path (CLI): launches {launches}, no plain-version "
          "call")
    return ft_launches


def instruments_path(ops, ckpt, out_dir, check, results):
    """The downstream instruments (``python -m gcc_tpu_torch.instruments``)
    on the serve path's checkpoint, which is depth-cut: its accuracies are
    printed, never held. The four fixtures are built and held to the
    hashes the tests pin; ``embed`` writes role v2, the graph families and
    the sim pair with the launch counters zeroed (Kernel 2 once and
    Kernel 3 twice per encode call, no plain-version call); every
    embedding is finite, the one-view rows unit, the two-view means of
    norm <= 1; 128 role-v2 nodes are held card vs CPU by the serve path's
    rule, printed beside the CPU path's own change under a 1-ulp change of
    every nonzero m_shift entry (its witness); the finetune instrument
    runs both arms at blocks=60, 1 epoch, fold 0. Adds the rows of
    Kernels 2 and 3 at the instruments' shapes; returns their launches."""
    import numpy as np
    import torch

    from gcc_tpu_torch import generate
    from gcc_tpu_torch.features import positional
    from gcc_tpu_torch.instruments import __main__ as instr
    from gcc_tpu_torch.instruments import finetune as ft_instr
    from gcc_tpu_torch.instruments import graph_families, role, similarity
    from gcc_tpu_torch.training import checkpoint, finetune

    t0 = time.time()
    g, _ = role.build_role_graph_v2()
    g60, y60 = role.build_role_graph_v2(blocks=60)
    graphs, _ = graph_families.build_graph_benchmark(60)
    g1, g2, d1, d2 = similarity.build_sim_pair(1000, rewire=similarity.REWIRE)
    hashes = {
        "role v2": (role.role_hash(g), role.ROLE_V2_HASH),
        "role v2 blocks=60": (role.role_hash(g60), role.ROLE_V2_60_HASH),
        "graph families": (graph_families.families_hash(graphs),
                           graph_families.FAMILIES_HASH),
        "sim pair": (similarity.sim_hash(g1, g2, similarity.correspondence(
            d1, d2, g1.num_nodes)[1]), similarity.SIM_HASH)}
    print(f"instrument fixtures built in {time.time() - t0:.1f} s: role v2 "
          f"{g.num_nodes} nodes, blocks=60 {g60.num_nodes}, {len(graphs)} "
          f"family graphs, sim pair 2 x {g1.num_nodes}", flush=True)
    for name, (got, pin) in hashes.items():
        check(got == pin, f"{name} fixture hashes to its pin {pin} ({got})")

    # -- embed: the three frozen-embedding instruments -------------------
    bucket, bsz = instr.ROLE_BUCKET, 64        # generate's batch
    emb_dir = os.path.join(out_dir, "emb")
    done, launches, plain, dt = counted(ops, lambda: instr.embed(
        ckpt, emb_dir, log_fn=lambda s: print(f"  {s}", flush=True)))
    calls = (2 * -(-g.num_nodes // bsz) + -(-len(graphs) // bsz)
             + 2 * 4 * -(-g1.num_nodes // bsz))
    print(f"instruments embed: {calls} encode calls in {dt:.1f} s; kernel "
          f"launches {launches}, plain-version calls {plain}", flush=True)
    check(launches == {"featurize": 0, "pe": calls, "jacobi": 2 * calls}
          and not any(plain.values()),
          f"embed: Kernel 2 once and Kernel 3 twice per encode call "
          f"{launches}, no plain-version call")
    z = {name: np.load(v["path"]) for name, v in done.items()}

    def norms(e):
        return np.linalg.norm(e, axis=1)

    two_view = [z["role"]["emb"], z["sim"]["emb_1"], z["sim"]["emb_2"]]
    one_view = [z["graph"]["score"]]
    others = [z["graph"]["composite"], z["sim"]["comp_1"],
              z["sim"]["comp_2"]]
    check(all(np.isfinite(e).all() for e in two_view + one_view + others),
          "instrument embeddings and readouts finite")
    check(all(float(np.abs(norms(e) - 1).max()) <= 1e-5 for e in one_view)
          and all(0 < norms(e).min() and norms(e).max() <= 1 + 1e-5
                  for e in two_view),
          "one-view rows unit, two-view means of norm in (0, 1]")

    # -- 128 role-v2 nodes on the card against the CPU -------------------
    cfg = checkpoint.load_config(os.path.dirname(ckpt))
    enc = checkpoint.load_encoder(ckpt, cfg, device="cpu")
    subs_q, subs_k = generate.node_subgraphs(g, cfg, *bucket, two_views=True)
    kw = dict(n_max=bucket[0], e_max=bucket[1], device="cpu",
              subgraphs_k=subs_k[:2 * bsz])
    t0 = time.time()
    ref = generate.generate_embeddings(cfg, enc, subs_q[:2 * bsz], **kw)
    real = positional.shifted_operator

    def nudged(*a, **k):
        m = real(*a, **k)
        return torch.where(m != 0, torch.nextafter(
            m, torch.full_like(m, math.inf)), m)

    positional.shifted_operator = nudged
    try:
        witness = generate.generate_embeddings(cfg, enc, subs_q[:2 * bsz],
                                               **kw)
    finally:
        positional.shifted_operator = real

    def versus_ref(e):
        cos = (e * ref).sum(-1) / (norms(e) * norms(ref))
        return float(np.abs(e - ref).max()), float(cos.mean())

    card = z["role"]["emb"][:2 * bsz]
    (max_abs, cos), (w_abs, w_cos) = versus_ref(card), versus_ref(witness)
    print(f"card vs CPU, first {2 * bsz} role-v2 node embeddings: max abs "
          f"{max_abs:.4g}, cosine mean {cos:.6f} (the CPU path's 1-ulp "
          f"witness: max abs {w_abs:.4g}, cosine mean {w_cos:.6f}; "
          f"{time.time() - t0:.1f} s on the CPU)", flush=True)
    check(cos >= CPU_MIN_MEAN_COS and max_abs <= CPU_MAX_ABS,
          f"role v2 card vs CPU: mean cosine {cos:.4f} >= "
          f"{CPU_MIN_MEAN_COS}, max abs {max_abs:.3g} <= {CPU_MAX_ABS}")
    out_launches = {("pe", "instr_embed"): launches["pe"],
                    ("jacobi", "instr_embed"): launches["jacobi"]}

    # -- the finetune instrument, both arms, 1 epoch ---------------------
    train_idx, test_idx = finetune.stratified_kfold(y60.argmax(1), 10,
                                                    cfg.seed)[0]
    per_arm = (-(-len(train_idx) // cfg.batch_size)
               + -(-len(test_idx) // cfg.batch_size))
    rec, launches, plain, dt = counted(
        ops, lambda: ft_instr.run_finetune_instrument(
            ckpt, blocks=60, epochs=1, folds=[0],
            out=os.path.join(out_dir, "finetune.json"),
            log_fn=lambda s: print(f"  {s}", flush=True)))
    f1 = {arm: r["mean"] for arm, r in rec["results"].items()}
    print(f"finetune instrument (role v2 blocks=60, 1 epoch, fold 0; a "
          f"depth-cut checkpoint, so the F1 is printed only): {f1}, "
          f"{2 * per_arm} calls in {dt:.1f} s; kernel launches {launches}, "
          f"plain-version calls {plain}", flush=True)
    check(set(f1) == {"pretrained", "scratch"}
          and all(math.isfinite(v) for v in f1.values()),
          "finetune instrument: both arms' micro-F1 finite")
    check(launches == {"featurize": 0, "pe": 2 * per_arm,
                       "jacobi": 4 * per_arm} and not any(plain.values()),
          f"finetune instrument: Kernel 2 once, Kernel 3 twice per call "
          f"{launches}, no plain-version call")
    out_launches.update({("pe", "instr_ft"): launches["pe"],
                         ("jacobi", "instr_ft"): launches["jacobi"]})

    # -- Kernels 2 and 3 at the instruments' shapes ----------------------
    m_shift, n_nodes = subgraph_operator(subs_q[:bsz], *bucket, "cuda")
    results[("pe", "instr_embed")], q = check_pe(
        m_shift, n_nodes, K_EVAL, check, key="instr_embed", small=True)
    s_g, t_rr = guarded_rr_matrices(m_shift, q)
    check_jacobi(s_g, check, timed=False)
    results[("jacobi", "instr_embed")] = check_jacobi(t_rr, check,
                                                      key="instr_embed")
    m_shift, n_nodes = entire_graph_operator(graphs[:bsz], 256,
                                             instr.GRAPH_BUCKET[1], "cuda")
    _, q = check_pe(m_shift, n_nodes, K_EVAL, check, timed=False)
    s_g, t_rr = guarded_rr_matrices(m_shift, q)
    check_jacobi(s_g, check, timed=False)
    check_jacobi(t_rr, check, timed=False)
    data = finetune.NodeLabeledData(g60, y60, cfg, *bucket)
    m_shift, n_nodes = subgraph_operator(
        data.subgraphs_for(train_idx[:cfg.batch_size], epoch_seed=1000),
        *bucket, "cuda")
    results[("pe", "instr_ft")], q = check_pe(
        m_shift, n_nodes, K_EVAL, check, key="instr_ft", small=True)
    s_g, t_rr = guarded_rr_matrices(m_shift, q)
    check_jacobi(s_g, check, timed=False)
    results[("jacobi", "instr_ft")] = check_jacobi(t_rr, check,
                                                   key="instr_ft")
    del m_shift, q, s_g, t_rr
    torch.cuda.empty_cache()
    return out_launches


def row_cosine_errors(a, b, n, seed=0):
    """Mean and max |a·aᵀ - b·bᵀ| over the first n rows (pairs of rows of
    two (N, k) blocks, on the card), or over a seeded sample of
    GIANT_COS_SAMPLE rows where n is larger than 8192."""
    import numpy as np
    import torch

    a, b = a.to("cuda", torch.float32), b.to("cuda", torch.float32)
    if n > 8192:
        idx = torch.as_tensor(np.sort(np.random.default_rng(seed).choice(
            n, GIANT_COS_SAMPLE, replace=False)), device="cuda")
        a, b = a[idx], b[idx]
    else:
        a, b = a[:n], b[:n]
    d = (a @ a.T - b @ b.T).abs()
    return d.mean().item(), d.max().item()


def span_rows(q):
    """Row-normalized orthonormal basis of the span of q's columns (f64
    QR): its row cosines are those of any basis of the span."""
    import torch

    basis = torch.linalg.qr(q.double()).Q
    norm = torch.linalg.vector_norm(basis, dim=1, keepdim=True)
    return basis / torch.where(norm == 0, torch.ones_like(norm), norm)


def nudged(pg):
    """The host PE partition with every nonzero edge weight moved up by
    one ulp (the witness input)."""
    import numpy as np

    field = "adj" if hasattr(pg, "adj") else "weight"
    a = getattr(pg, field)
    return pg._replace(**{field: np.where(
        a != 0, np.nextafter(a, np.float32(np.inf)), a).astype(np.float32)})


def giant_path(ops, cfg, ckpt, check, results):
    """Entire graphs beyond the dense bucket through
    generate_graph_embeddings at full width (from the serve path's
    checkpoint): a few graphs within n_max, REDDIT-shaped graphs, an
    8,000-node graph at the dense envelope and one at com-DBLP's size, in
    one call (launch counters zeroed just before it). Then each giant
    graph on its own, card against the port's CPU path on the same
    graph and weights: the iterated PE span and the PE (row cosines),
    giant_gin_encode on identical features, the embeddings beside the
    CPU path's own change under a 1-ulp change of the edge weights; and
    the rows of the call held to these, in order. Adds Kernel 3's row at
    (1, 48, 48), 5 sweeps (the giant PE's finish); returns its launches
    and what the run across ranks (phase 14) is held to: the graphs, the
    call's embeddings, each giant graph's card PE with its witness limit,
    its embedding witness and times."""
    import numpy as np
    import torch

    from gcc_tpu_torch import generate
    from gcc_tpu_torch.parallel import giant_features as gf
    from gcc_tpu_torch.parallel.giant import giant_gin_encode
    from gcc_tpu_torch.training.checkpoint import load_encoder

    card = load_encoder(ckpt, cfg, device="cuda").eval()
    host = load_encoder(ckpt, cfg, device="cpu").eval()
    small = random_graphs(4, 3, 100, 500)
    reddit = reddit_graphs(5, REDDIT_COUNT)
    dense = uniform_graph(6, *DENSE_GIANT)
    dblp = uniform_graph(7, *DBLP_GIANT)
    giant = reddit + [dense, dblp]
    names = [f"REDDIT-shaped {i}" for i in range(len(reddit))] + [
        "dense 8k", "com-DBLP size"]
    graphs = ([reddit[0], small[0]] + reddit[1:8] + [dense, small[1]]
              + reddit[8:] + [dblp, small[2]])
    rows = [next(i for i, x in enumerate(graphs) if x is g) for g in giant]
    gen = dict(n_max=GEN_N_MAX, e_max=GEN_E_MAX, batch_size=GEN_BATCH)
    generate.generate_graph_embeddings(cfg, card, graphs[:2], **gen)  # warm
    emb, launches, plain, dt = counted(
        ops, lambda: generate.generate_graph_embeddings(cfg, card, graphs,
                                                        **gen))
    print(f"generate_graph_embeddings, {len(small)} graphs within n_max "
          f"{GEN_N_MAX} and {len(giant)} beyond ({len(reddit)} "
          f"REDDIT-shaped of {min(g.num_nodes for g in reddit)}-"
          f"{max(g.num_nodes for g in reddit)} nodes, {dense.num_nodes} "
          f"nodes / {dense.num_edges} edges, {dblp.num_nodes} nodes / "
          f"{dblp.num_edges} edges): {dt:.2f} s; kernel launches "
          f"{launches}, plain-version calls {plain}", flush=True)
    check(launches == {"featurize": 0, "pe": 1, "jacobi": 2 + 2 * len(giant)}
          and not any(plain.values()),
          f"giant routing: Kernel 2 once and Kernel 3 twice for the small "
          f"graphs' encode call, Kernel 3 twice per giant graph {launches}, "
          "no plain-version call")
    norms = np.linalg.norm(emb, axis=1)
    check(bool(np.isfinite(emb).all()) and np.abs(norms - 1).max() <= 1e-5,
          f"all {len(graphs)} graph embeddings finite and of unit norm (max "
          f"|norm - 1| {np.abs(norms - 1).max():.3g})")
    small_rows = [i for i in range(len(graphs)) if i not in rows]
    direct = generate.generate_graph_embeddings(cfg, card, small, **gen)
    check(np.array_equal(emb[small_rows], direct),
          "rows of the graphs within n_max equal their own call's, in order")

    # Each giant graph alone: timed on the card, then card against CPU.
    alone, timings = [], []
    worst = {"span": (0.0, 0.0), "pe_max": 0.0, "encode": 0.0}
    pe_means, recorded, cpu_s, emb_witness = [], [], 0.0, []
    card_pes, card_vs_cpu = [], []
    for name, g in zip(names, giant):
        schedule = ("dense" if gf.dense_schedule_wins(g.num_edges,
                                                      g.num_nodes, 1)
                    else "ring")
        torch.cuda.synchronize()
        t0 = time.time()
        alone.append(gf.giant_graph_embedding(card, g).cpu().numpy())
        timings.append((schedule, time.time() - t0))
        n = g.num_nodes
        pg_pe, pg_enc = gf.giant_partitions(g)
        out = {}
        t_cpu = time.time()
        for dev, model in (("cuda", card), ("cpu", host)):
            pe_dev = gf.place_giant_partition(pg_pe, 1, dev)
            enc_dev = gf.place_giant_partition(pg_enc, 1, dev)
            n_pad = pe_dev.num_nodes
            q0 = torch.as_tensor(gf.giant_pe_basis(n_pad, n, 32, 16),
                                 device=dev)
            mask = (torch.arange(n_pad, device=dev) < n).to(torch.float32)
            with torch.no_grad():
                q = gf.giant_pe_iterate(pe_dev, q0)
                if dev == "cuda" and g is reddit[-1]:
                    # The two matrices Kernel 3 gets in the finish.
                    with jacobi_inputs(gf) as recorded:
                        pe = gf.giant_pe_finish(pe_dev, q, mask, n)
                else:
                    pe = gf.giant_pe_finish(pe_dev, q, mask, n)
            out[dev] = (q, pe, pe_dev, enc_dev, mask, q0)
        q_c, pe_c, _, enc_c, mask_c, _ = out["cuda"]
        q_h, pe_h, _, enc_h, mask_h, q0_h = out["cpu"]
        with torch.no_grad():
            pe_w = gf.giant_laplacian_pe(gf.place_giant_partition(
                nudged(pg_pe), 1, "cpu"), q0_h, mask_h, n)
            feats_h = gf.giant_input_features(host, g, pe_h)
            emb_h = giant_gin_encode(host, enc_h, feats_h, mask_h)
            emb_w = giant_gin_encode(host, enc_h, gf.giant_input_features(
                host, g, pe_w), mask_h)
            same_in = giant_gin_encode(card, enc_c, feats_h.cuda(),
                                       mask_c).cpu()
            emb_c = giant_gin_encode(card, enc_c, gf.giant_input_features(
                card, g, pe_c), mask_c).cpu()
        span = row_cosine_errors(span_rows(q_c[:n]), span_rows(q_h[:n]), n)
        cos = row_cosine_errors(pe_c, pe_h, n)
        cos_w = row_cosine_errors(pe_w, pe_h, n)
        enc_err = (same_in - emb_h).abs().max().item()
        e2e, e2e_w = ((e - emb_h).abs().max().item() for e in (emb_c, emb_w))
        emb_witness.append(e2e_w)
        card_vs_cpu.append(e2e)
        card_pes.append(pe_c[:n].cpu())
        cpu_s += time.time() - t_cpu
        worst["span"] = tuple(map(max, worst["span"], span))
        worst["pe_max"] = max(worst["pe_max"], cos[1])
        worst["encode"] = max(worst["encode"], enc_err)
        pe_means.append((name, cos[0], WITNESS_FACTOR * cos_w[0]
                         + PE_MEAN_LIMIT))
        print(f"giant {name} ({n} nodes, {g.num_edges} edges, {schedule}): "
              f"{timings[-1][1] * 1e3:.1f} ms alone; card vs CPU: iterated "
              f"span row cosines mean {span[0]:.3g} max {span[1]:.3g}; PE "
              f"row cosines mean {cos[0]:.3g} max {cos[1]:.3g} (witness "
              f"{cos_w[0]:.3g}, {cos_w[1]:.3g}; mean limit "
              f"{pe_means[-1][2]:.3g}); encode on identical features "
              f"{enc_err:.3g}; embedding max abs {e2e:.4g} (witness "
              f"{e2e_w:.4g}); both sides with the witness "
              f"{time.time() - t_cpu:.1f} s", flush=True)
        if g is dblp:
            dblp_card = out["cuda"][2:]
        del out, q_c, pe_c, enc_c
        torch.cuda.empty_cache()
    print(f"giant graphs, card vs CPU with the witnesses: {cpu_s:.1f} s "
          f"(host clock; torch on {torch.get_num_threads()} CPU threads)",
          flush=True)
    check(worst["span"][0] <= PE_MEAN_LIMIT
          and worst["span"][1] <= PE_MAX_LIMIT,
          f"giant PE, card vs CPU: iterated span row cosines of every graph "
          f"mean <= {worst['span'][0]:.3g} <= {PE_MEAN_LIMIT}, max "
          f"<= {worst['span'][1]:.3g} <= {PE_MAX_LIMIT}")
    over = [(nm, m, lim) for nm, m, lim in pe_means if m > lim]
    check(not over and worst["pe_max"] <= PE_MAX_LIMIT,
          f"giant PE, card vs CPU: PE row cosines of every graph mean <= "
          f"{WITNESS_FACTOR} x its witness's + {PE_MEAN_LIMIT} (largest "
          f"share of its limit {max(m / lim for _, m, lim in pe_means):.3f}"
          f"{'; over: ' + str(over) if over else ''}), max <= "
          f"{worst['pe_max']:.3g} <= {PE_MAX_LIMIT}")
    check(worst["encode"] <= GIANT_ENCODE_LIMIT,
          f"giant_gin_encode on identical features, card vs CPU: max abs "
          f"{worst['encode']:.3g} <= {GIANT_ENCODE_LIMIT}")
    alone = np.stack(alone)
    own = np.abs(emb[rows] - alone).max(axis=1)
    dist = np.abs(emb[rows][:, None, :] - alone[None, :, :]).max(axis=2)
    other = (dist + np.eye(len(giant)) * 9).min(axis=1)
    check(bool((dist.argmin(axis=1) == np.arange(len(giant))).all()),
          f"giant rows in order: each nearest its own graph's embedding "
          f"computed alone (own max abs {own.max():.3g}; smallest margin "
          f"to another graph's {(other - own).min():.3g})")
    for schedule in ("dense", "ring"):
        ts = [t for s_, t in timings if s_ == schedule]
        print(f"giant graphs on the {schedule} schedule: {len(ts)}, "
              f"{np.mean(ts) * 1e3:.1f} ms a graph on average (min "
              f"{min(ts) * 1e3:.1f}, max {max(ts) * 1e3:.1f}; host clock, "
              "synchronized)", flush=True)
    # The com-DBLP-size graph's PE and encode on the card, on their own
    # (its partitions as the comparison placed them).
    pg_pe, pg_enc, mask, q0 = dblp_card
    with torch.no_grad():
        pe_ms = timed_ms(lambda: gf.giant_laplacian_pe(
            pg_pe, q0, mask, dblp.num_nodes), 2)
        feats = gf.giant_input_features(card, dblp, gf.giant_laplacian_pe(
            pg_pe, q0, mask, dblp.num_nodes))
        enc_ms = timed_ms(lambda: giant_gin_encode(card, pg_enc, feats,
                                                   mask), 3)
    print(f"com-DBLP-size graph on the card: PE {pe_ms:.2f} ms, encode "
          f"{enc_ms:.2f} ms (CUDA events)", flush=True)
    del pg_pe, pg_enc, q0, feats, dblp_card
    torch.cuda.empty_cache()
    profiled_idle_share(lambda: gf.giant_graph_embedding(card, reddit[-1]),
                        f"giant graph of {reddit[-1].num_nodes} nodes "
                        "(dense schedule)")
    profiled_idle_share(lambda: gf.giant_graph_embedding(card, dblp),
                        "com-DBLP-size graph (ring schedule)")

    check(len(recorded) == 2 and all(a.shape == (1, 48, 48)
                                     for a in recorded),
          f"the giant PE's finish hands Kernel 3 two (1, 48, 48) matrices "
          f"{[tuple(a.shape) for a in recorded]}")
    check_jacobi(recorded[0], check, timed=False, sweeps=GIANT_SWEEPS)
    results[("jacobi", "giant")] = check_jacobi(
        recorded[1], check, key="giant", sweeps=GIANT_SWEEPS)
    info = dict(graphs=graphs, rows=rows, names=names, emb=emb,
                card_pes=card_pes, pe_limits=[lim for _, _, lim in pe_means],
                emb_witness=emb_witness, card_vs_cpu=card_vs_cpu,
                timings=timings, pe_ms=pe_ms, enc_ms=enc_ms,
                largest_reddit=reddit[-1], dblp=dblp)
    return {("jacobi", "giant"): launches["jacobi"] - 2}, info


def loose_ends(ops, cfg, corpus_dir, out_dir, item, check, results):
    """run_pretrain over the padded pairs wire (compact_wire=False) with
    two forked sampler processes, at the training path's width (batch
    32, queue 16384, n_max 128), and Kernels 2 and 3 held against their
    plain versions on the operator of the run's first step; one forward
    and one MoCo step of an encoder without degree input. Adds the
    kernels' rows of the padded path; returns their launches."""
    import dataclasses

    import torch

    from gcc_tpu_torch.features import positional
    from gcc_tpu_torch.sampling.pipeline import PipelineConfig
    from gcc_tpu_torch.training import (
        create_pretrain_state,
        featurize_stacked,
        loop,
        train_dispatch,
    )

    steps, workers = PADDED_STEPS, 2
    pcfg = PipelineConfig(batch_size=BATCH, n_max=N_SMALL, e_max=E_MAX,
                          num_samples=steps * BATCH // workers,
                          num_workers=workers, prefetch=8,
                          compact_wire=False, mode="process")
    run_cfg = dataclasses.replace(cfg, epochs=1, num_workers=workers,
                                  num_samples=pcfg.num_samples)
    # The operator and node mask the run's first step hands the PE.
    real_topk, first = positional.subspace_topk, []

    def recording(m_shift, node_mask, *args, **kwargs):
        if not first:
            first.append((m_shift.clone(), node_mask.sum(1).long()))
        return real_topk(m_shift, node_mask, *args, **kwargs)

    positional.subspace_topk = recording
    try:
        summary, launches, plain, dt = counted(
            ops, lambda: loop.run_pretrain(run_cfg, corpus_dir, out_dir, pcfg,
                                           log_fn=lambda s: None,
                                           steps_per_call=steps))
    finally:
        positional.subspace_topk = real_topk
    with open(os.path.join(summary["run_dir"], "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    print(f"run_pretrain over the padded pairs wire, {workers} forked "
          f"sampler processes: {summary['steps']} steps in {dt:.1f} s with "
          f"pipeline start-up (training wall {summary['wall']:.2f} s, "
          f"{summary['wall'] / steps * 1e3:.3f} ms/step), avg loss "
          f"{summary['avg_loss']:.4f}; kernel launches {launches}, "
          f"plain-version calls {plain}", flush=True)
    check(summary["steps"] == steps and len(lines) == steps
          and [r["step"] for r in lines] == list(range(steps))
          and all(math.isfinite(r["loss"]) for r in lines),
          f"padded pairs wire, process mode: {len(lines)} finite metric "
          "lines, step counter advancing")
    check(launches == {"featurize": 0, "pe": steps, "jacobi": steps}
          and not any(plain.values()),
          f"padded pairs wire: Kernels 2 and 3 once a step {launches}, no "
          "plain-version call")
    m_shift, n_nodes = first[0]
    k_pos = cfg.encoder.positional_embedding_size
    print(f"padded pairs wire, first step: {m_shift.shape[0]} views at "
          f"n_max {m_shift.shape[1]}, nodes mean "
          f"{n_nodes.float().mean().item():.1f}", flush=True)
    results[("pe", "padded")], q = check_pe(m_shift, n_nodes, k_pos, check,
                                            key="padded")
    results[("jacobi", "padded")] = check_jacobi(rr_matrices(m_shift, q),
                                                 check, key="padded")
    del m_shift, q, first

    no_deg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, degree_input=False))
    state = create_pretrain_state(no_deg, total_steps=1000, seed=0,
                                  device="cuda")
    one = [dataclasses.replace(w, edges=w.edges[:1], meta=w.meta[:1])
           for w in item]
    with torch.no_grad():
        feats = featurize_stacked(
            *one, cfg.encoder.positional_embedding_size, n_max=N_MAX)
        state.model.eval()
        out = state.model(feats.map(lambda x: x[0]))
    idx0 = int(state.queue.index)
    metrics = train_dispatch(state, *one, n_max=N_MAX)
    print(f"encoder without degree input: input width "
          f"{no_deg.encoder.node_input_dim}, forward {tuple(out.shape)}, "
          f"one MoCo step loss {metrics['loss'].item():.4f}", flush=True)
    check(bool(torch.isfinite(out).all()) and state.model.degree_embedding
          is None and bool(torch.isfinite(metrics["loss"]).all())
          and int(state.queue.index) == (idx0 + BATCH) % NCE_K
          and state.step == 1,
          "degree_input=False: finite forward and MoCo step, queue and "
          "step advanced")
    return {("pe", "padded"): launches["pe"],
            ("jacobi", "padded"): launches["jacobi"]}


def pe64_path(ops, cfg, small_items, large_items, check, results):
    """PE 64, the widths ROADMAP Queue 3 opened: Kernel 2 against its
    plain version at k = 64 on the training buckets' operators ((4096,
    128, 128) and (4096, 256, 256)) and at k = 80 (64 + 16 guards) at the
    eval shapes ((128, 256, 256), (64, 512, 512)); Kernel 3 at (4096, 64,
    64) and (64, 80, 80), 3 sweeps, error 0, beside torch.linalg.eigh.
    Then through the entry points with positional_embedding_size 64: one
    routed MoCo dispatch in each bucket, and one generate_embeddings
    encode call at n_max 512 (batch 64) and at 256 (batch 128), the
    launch counters zeroed before each; the PE's row cosines card vs CPU
    on the first step's views (train profile: Kernel 2's bf16 limits) and
    on the 512 call's graphs (eval profile: WITNESS_FACTOR x the CPU
    path's own 1-ulp change + PE_MEAN_LIMIT, max PE_MAX_LIMIT); and the
    giant PE of the smallest REDDIT-shaped graph at PE 64 (its finish:
    Kernel 3 twice at (1, 80, 80), 5 sweeps, both matrices recorded and
    held to error 0, the second timed), card vs CPU by the giant
    phase's rules. Adds the rows; returns {row key: launches}."""
    import dataclasses

    import torch

    from gcc_tpu_torch import generate
    from gcc_tpu_torch.features.featurize import featurize_batch
    from gcc_tpu_torch.graph.batch import batch_subgraphs
    from gcc_tpu_torch.models import GraphEncoder
    from gcc_tpu_torch.ops.aggregate import fused_adjacency_featurize
    from gcc_tpu_torch.training import (
        create_pretrain_state,
        featurize_stacked,
        train_dispatch,
    )

    dev = torch.device("cuda")
    pos = PE64
    k_eval = pos + K_EVAL - cfg.encoder.positional_embedding_size
    # -- the kernels at the new widths -----------------------------------
    for n_b, item in ((N_SMALL, small_items[0]), (N_MAX, large_items[0])):
        edges, meta = wire_segments(item, dev)
        _, m_shift, _ = fused_adjacency_featurize(edges, meta, n_b, 8)
        results[("pe", f"{n_b}k{pos}")], q = check_pe(
            m_shift, meta[:, 0, :].reshape(-1), pos, check,
            key=f"{n_b}k{pos}", require_well=False)
        if n_b == N_SMALL:
            results[("jacobi", f"n{pos}")] = check_jacobi(
                rr_matrices(m_shift, q), check, key=f"n{pos}", exact=True)
        del edges, meta, m_shift, q
        torch.cuda.empty_cache()
    for n_b, count, lo in ((N_MAX, 128, 100), (GEN_N_MAX, GEN_BATCH, 260)):
        m_shift, n_nodes = entire_graph_operator(
            random_graphs(n_b, count, lo, n_b), n_b, GEN_E_MAX, dev)
        results[("pe", f"{n_b}k{k_eval}")], q = check_pe(
            m_shift, n_nodes, k_eval, check, key=f"{n_b}k{k_eval}")
        if n_b == GEN_N_MAX:
            s_g, t_rr = guarded_rr_matrices(m_shift, q)
            check_jacobi(s_g, check, timed=False, exact=True)
            results[("jacobi", f"n{k_eval}")] = check_jacobi(
                t_rr, check, key=f"n{k_eval}", exact=True)
            del s_g, t_rr
        del m_shift, q
        torch.cuda.empty_cache()
    means = []
    for seed in PE_SPREAD_SEEDS:
        m_shift, n_nodes = entire_graph_operator(
            random_graphs(seed, 128, 100, N_MAX), N_MAX, GEN_E_MAX, dev)
        means.append(check_pe(m_shift, n_nodes, k_eval, check,
                              timed=False)[0]["mean"])
    print(f"pe N={N_MAX} k={k_eval} bf16 mean abs err on seeds "
          f"{PE_SPREAD_SEEDS}: {', '.join(f'{v:.4g}' for v in means)}",
          flush=True)
    del m_shift, n_nodes

    # -- one routed MoCo dispatch per bucket at PE 64 ----------------------
    cfg64 = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, positional_embedding_size=pos))
    state = create_pretrain_state(cfg64, total_steps=100_000, seed=0,
                                  device="cuda")
    launches = {}
    for n_b, item in ((N_SMALL, small_items[1]), (N_MAX, large_items[1])):
        metrics, got, plain, dt = counted(
            ops, lambda: train_dispatch(state, *item, n_max=N_MAX))
        launches[("train", n_b)] = got
        loss = metrics["loss"].cpu()
        print(f"PE {pos} routed dispatch {n_b}: {STEPS} steps in "
              f"{dt * 1e3:.1f} ms ({dt * 1e3 / STEPS:.3f} ms/step), loss "
              f"first {loss[0].item():.4f} last {loss[-1].item():.4f}; "
              f"kernel launches {got}", flush=True)
        check(bool(torch.isfinite(loss).all()),
              f"PE {pos} routed {n_b}: loss finite")
        check(all(c == 1 for c in got.values()) and not any(plain.values()),
              f"PE {pos} routed {n_b}: every kernel launched once {got}, no "
              "plain-version call")
    del state
    head = [first_steps(w, 1) for w in small_items[1]]
    on_card = featurize_stacked(*head, pos, n_max=N_MAX, device="cuda")
    on_cpu = featurize_stacked(*head, pos, n_max=N_MAX, device="cpu")
    exact, e = pe_card_vs_cpu([on_card.map(lambda x: x[0])],
                              [on_cpu.map(lambda x: x[0])],
                              [(N_SMALL, None)], pos)
    print(f"PE {pos} train profile, card vs CPU on {e['views']} views: row "
          f"cosines mean {e['cos_mean']:.4g}, max {e['cos_max']:.4g} (1-ulp "
          f"witness {e['ulp_cos_mean']:.4g}, {e['ulp_cos_max']:.4g}); "
          f"coordinates mean {e['mean']:.4g}, max {e['max']:.4g}", flush=True)
    check(exact and e["cos_mean"] <= PE_MEAN_LIMIT
          and e["cos_max"] <= PE_MAX_LIMIT,
          f"PE {pos} train profile card vs CPU: adjacency, degrees, masks "
          f"equal; row cosines mean {e['cos_mean']:.3g} <= {PE_MEAN_LIMIT}, "
          f"max {e['cos_max']:.3g} <= {PE_MAX_LIMIT}")

    # -- generate_embeddings, eval profile (k = 80) ------------------------
    model = GraphEncoder(cfg64.encoder)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev).eval()
    for n_b, count, lo in ((GEN_N_MAX, GEN_BATCH, 260), (N_MAX, 128, 100)):
        subs = generate.graph_subgraphs(random_graphs(n_b + 1, count, lo,
                                                      n_b))
        emb, got, plain, dt = counted(ops, lambda: generate.generate_embeddings(
            cfg64, model, subs, n_max=n_b, e_max=GEN_E_MAX, batch_size=count))
        launches[("eval", n_b)] = got
        print(f"PE {pos} generate_embeddings at n_max {n_b}: one encode call "
              f"of {count} graphs in {dt * 1e3:.1f} ms; kernel launches "
              f"{got}", flush=True)
        check(got["pe"] == 1 and got["jacobi"] == 2 and not any(
            plain.values()) and bool(torch.isfinite(torch.as_tensor(emb))
                                     .all()),
              f"PE {pos} generate at {n_b}: Kernel 2 once, Kernel 3 twice, no "
              "plain-version call, finite embeddings")
        if n_b != GEN_N_MAX:
            continue
        batch = batch_subgraphs(subs, n_b, GEN_E_MAX)
        exact, e = pe_card_vs_cpu(
            [featurize_batch(batch, pos, profile="eval", device="cuda")],
            [featurize_batch(batch, pos, profile="eval", device="cpu")],
            [(n_b, None)], pos, profile="eval", nudges=(math.inf,))
        limit = WITNESS_FACTOR * e["ulp_cos_mean"] + PE_MEAN_LIMIT
        print(f"PE {pos} eval profile, card vs CPU on {e['views']} graphs: "
              f"row cosines mean {e['cos_mean']:.4g}, max {e['cos_max']:.4g} "
              f"(1-ulp witness {e['ulp_cos_mean']:.4g}, "
              f"{e['ulp_cos_max']:.4g}); coordinates mean {e['mean']:.4g}, "
              f"max {e['max']:.4g}", flush=True)
        check(exact and e["cos_mean"] <= limit
              and e["cos_max"] <= PE_MAX_LIMIT,
              f"PE {pos} eval profile card vs CPU: row cosines mean "
              f"{e['cos_mean']:.3g} <= {limit:.3g} ({WITNESS_FACTOR} x witness "
              f"+ {PE_MEAN_LIMIT}), max {e['cos_max']:.3g} <= {PE_MAX_LIMIT}")
    # -- the giant PE's finish at PE 64 (Kernel 3 at (1, 80, 80)) --------
    from gcc_tpu_torch.parallel import giant_features as gf

    g = min(reddit_graphs(5, REDDIT_COUNT), key=lambda x: x.num_nodes)
    n = g.num_nodes
    pg_pe, _ = gf.giant_partitions(g)
    out = {}
    for dev in ("cuda", "cpu"):
        placed = gf.place_giant_partition(pg_pe, 1, dev)
        n_pad = placed.num_nodes
        q0 = torch.as_tensor(gf.giant_pe_basis(n_pad, n, pos, 16), device=dev)
        mask = (torch.arange(n_pad, device=dev) < n).to(torch.float32)
        with torch.no_grad():
            if dev == "cuda":
                q, got, _, _ = counted(ops, lambda: gf.giant_pe_iterate(
                    placed, q0))
                # The two matrices Kernel 3 gets in the finish.
                with jacobi_inputs(gf) as recorded:
                    pe, got, plain, _ = counted(
                        ops, lambda: gf.giant_pe_finish(placed, q, mask, n,
                                                        pos_size=pos))
                launches["giant"] = got
            else:
                q = gf.giant_pe_iterate(placed, q0)
                pe = gf.giant_pe_finish(placed, q, mask, n, pos_size=pos)
                witness = gf.giant_laplacian_pe(gf.place_giant_partition(
                    nudged(pg_pe), 1, "cpu"), q0, mask, n, pos_size=pos)
        out[dev] = (q, pe)
    span = row_cosine_errors(span_rows(out["cuda"][0][:n]),
                             span_rows(out["cpu"][0][:n]), n)
    cos = row_cosine_errors(out["cuda"][1], out["cpu"][1], n)
    cos_w = row_cosine_errors(witness, out["cpu"][1], n)
    limit = WITNESS_FACTOR * cos_w[0] + PE_MEAN_LIMIT
    print(f"PE {pos} giant PE ({n} nodes, {q.shape[1]} columns), card vs "
          f"CPU: iterated span row cosines mean {span[0]:.3g} max "
          f"{span[1]:.3g}; PE row cosines mean {cos[0]:.3g} max {cos[1]:.3g} "
          f"(witness {cos_w[0]:.3g}, {cos_w[1]:.3g}); finish launches {got}",
          flush=True)
    check(got["jacobi"] == 2 and not any(plain.values()),
          f"PE {pos} giant finish: Kernel 3 twice at (1, {q.shape[1]}, "
          f"{q.shape[1]}), no plain-version call")
    check(span[0] <= PE_MEAN_LIMIT and span[1] <= PE_MAX_LIMIT
          and cos[0] <= limit and cos[1] <= PE_MAX_LIMIT,
          f"PE {pos} giant PE card vs CPU: span mean {span[0]:.3g} <= "
          f"{PE_MEAN_LIMIT}, max {span[1]:.3g} <= {PE_MAX_LIMIT}; PE row "
          f"cosines mean {cos[0]:.3g} <= {limit:.3g}, max {cos[1]:.3g} <= "
          f"{PE_MAX_LIMIT}")
    check(len(recorded) == 2 and all(a.shape == (1, k_eval, k_eval)
                                     for a in recorded),
          f"PE {pos} giant finish hands Kernel 3 two (1, {k_eval}, "
          f"{k_eval}) matrices {[tuple(a.shape) for a in recorded]}")
    check_jacobi(recorded[0], check, timed=False, sweeps=GIANT_SWEEPS,
                 exact=True)
    results[("jacobi", f"giant{k_eval}")] = check_jacobi(
        recorded[1], check, key=f"giant{k_eval}", sweeps=GIANT_SWEEPS,
        exact=True)
    return {("pe", f"{N_SMALL}k{pos}"): launches[("train", N_SMALL)]["pe"],
            ("pe", f"{N_MAX}k{pos}"): launches[("train", N_MAX)]["pe"],
            ("jacobi", f"n{pos}"): launches[("train", N_SMALL)]["jacobi"],
            ("pe", f"{N_MAX}k{k_eval}"): launches[("eval", N_MAX)]["pe"],
            ("pe", f"{GEN_N_MAX}k{k_eval}"): launches[("eval", GEN_N_MAX)]["pe"],
            ("jacobi", f"n{k_eval}"): launches[("eval", GEN_N_MAX)]["jacobi"],
            ("jacobi", f"giant{k_eval}"): launches["giant"]["jacobi"]}


def wide_widths_path(ops, cfg, check, results):
    """Every width the reference computes: Kernel 2's general plan against
    its plain version at (128, 256, 256), k = 96 (PE 80 + 16 guards),
    (64, 512, 512), k = 128 (PE 112 + 16) and (16, 832, 832), k = 256
    (clusters of 1, 2 and 6 blocks a graph), untimed at k = 120; Kernel
    3's cluster pair kernel at (128, 96, 96) (one block a matrix), (64,
    120, 120), (64, 128, 128) (clusters of 2) and (16, 256, 256) (of 6), 3
    sweeps, on those outputs' Rayleigh-Ritz matrices, error 0, beside
    torch.linalg.eigh, each with its cluster, placement and the clusters
    the card holds at once. Then the WIDE_CALLS encode calls through
    generate_embeddings, the launch counters zeroed before each (Kernel 2
    once, Kernel 3 twice, no plain-version call), the PE 112 call's PE row
    cosines card vs CPU by the eval-profile rules of the PE 64 phase; the
    matrices the PE 42 and PE 496 calls hand Kernel 3 make its rows at
    (64, 58, 58) (h odd, one block a matrix) and (4, 512, 512) (A and V^T
    in the device scratch). Adds the rows; returns {row key: launches}."""
    import dataclasses

    import torch

    from gcc_tpu_torch import generate
    from gcc_tpu_torch.features import positional
    from gcc_tpu_torch.features.featurize import featurize_batch
    from gcc_tpu_torch.graph.batch import batch_subgraphs
    from gcc_tpu_torch.models import GraphEncoder
    from gcc_tpu_torch.ops import jacobi
    from gcc_tpu_torch.ops.pe import general_clusters, pe_launch_plan

    dev = torch.device("cuda")

    def cluster_row(t, key):
        """Kernel 3's row at t's shape, with the plan it launched: blocks
        a matrix, placement, the clusters of that size the card holds at
        once; the batch's clusters fill at most one wave where the plan
        raised them above the least that holds a matrix."""
        b, n, _ = t.shape
        held = jacobi.cluster_held()
        plan = jacobi.jacobi_launch_plan(n, b, held)
        c = plan["cluster"]
        print(f"jacobi ({b}, {n}, {n}): {plan['variant']}, cluster of {c} "
              f"block(s) a matrix, A and V^T in {plan['placement']} memory, "
              f"{plan['items']} 2x2 blocks a thread, {plan['threads']} "
              f"threads, {plan['smem_bytes']} B of shared memory a block; "
              f"the card holds {held[c - 1]} such clusters at once",
              flush=True)
        check(plan["variant"] == jacobi.CLUSTER_VARIANT
              and (c == plan["least_cluster"]
                   or (b * c <= 132 and b <= held[c - 1])),
              f"jacobi ({b}, {n}, {n}): {b} clusters of {c} in one wave")
        row = check_jacobi(t, check, key=key, exact=True)
        row.update(cluster=c, placement=plan["placement"])
        return row

    # -- the kernels at the new widths -------------------------------------
    for n_b, count, lo, k in ((N_MAX, 128, 100, 96),
                              (GEN_N_MAX, GEN_BATCH, 260, 128),
                              (832, 16, 520, 256)):
        m_shift, n_nodes = entire_graph_operator(
            random_graphs(n_b + k, count, lo, n_b), n_b, GEN_E_MAX, dev)
        key = f"{n_b}k{k}"
        plan = pe_launch_plan(n_b, k, count, tuple(
            general_clusters(c) for c in range(1, 9)))
        held = general_clusters(plan["cluster"])
        print(f"pe ({count}, {n_b}, {n_b}) k={k}: plan {plan['plan']}, "
              f"cluster of {plan['cluster']} (the card holds {held} such "
              f"clusters at once); {plan['variant']}", flush=True)
        check(plan["plan"] == "general" and (plan["cluster"] == 1
                                             or held >= count),
              f"pe ({count}, {n_b}, {n_b}) k={k}: the general plan's "
              f"{count} clusters of {plan['cluster']} fit the card at once")
        results[("pe", key)], q = check_pe(m_shift, n_nodes, k, check,
                                           key=key)
        if k == 96:
            s_g, t_rr = guarded_rr_matrices(m_shift, q)
            check_jacobi(s_g, check, timed=False, exact=True)
            results[("jacobi", "n96")] = cluster_row(t_rr, "n96")
            del s_g, t_rr
        elif k == 128:
            s_g, t_rr = guarded_rr_matrices(m_shift, q)
            check_jacobi(s_g, check, timed=False, exact=True)
            results[("jacobi", "n128")] = cluster_row(t_rr, "n128")
            _, q = check_pe(m_shift, n_nodes, 120, check, timed=False)
            results[("jacobi", "n120")] = cluster_row(
                guarded_rr_matrices(m_shift, q)[1], "n120")
            del s_g, t_rr
        elif k == 256:
            results[("jacobi", "n256")] = cluster_row(
                guarded_rr_matrices(m_shift, q)[1], "n256")
        del m_shift, q
        torch.cuda.empty_cache()

    # -- encode calls through the entry point --------------------------------
    launches = {}
    for pos, n_b, count, lo in WIDE_CALLS:
        cfg_w = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, positional_embedding_size=pos))
        model = GraphEncoder(cfg_w.encoder)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(dev).eval()
        subs = generate.graph_subgraphs(random_graphs(n_b + pos, count, lo,
                                                      n_b))
        with jacobi_inputs(positional) as recorded:
            emb, got, plain, dt = counted(
                ops, lambda: generate.generate_embeddings(
                    cfg_w, model, subs, n_max=n_b, e_max=GEN_E_MAX,
                    batch_size=count))
        launches[pos] = got
        k = min(n_b, pos + K_EVAL - cfg.encoder.positional_embedding_size)
        print(f"PE {pos} generate_embeddings at n_max {n_b}: one encode call "
              f"of {count} graphs (k = {k}) in {dt * 1e3:.1f} ms; kernel "
              f"launches {got}", flush=True)
        check(got["pe"] == 1 and got["jacobi"] == 2 and not any(
            plain.values()) and bool(torch.isfinite(torch.as_tensor(emb))
                                     .all()),
              f"PE {pos} generate at {n_b}: Kernel 2 once, Kernel 3 twice, "
              "no plain-version call, finite embeddings")
        if pos in RECORDED_JACOBI:
            check_jacobi(recorded[0], check, timed=False, exact=True)
            results[("jacobi", RECORDED_JACOBI[pos])] = cluster_row(
                recorded[1], RECORDED_JACOBI[pos])
        del recorded
        if pos != WIDE_CALLS[0][0]:
            continue
        batch = batch_subgraphs(subs, n_b, GEN_E_MAX)
        exact, e = pe_card_vs_cpu(
            [featurize_batch(batch, pos, profile="eval", device="cuda")],
            [featurize_batch(batch, pos, profile="eval", device="cpu")],
            [(n_b, None)], pos, profile="eval", nudges=(math.inf,))
        limit = WITNESS_FACTOR * e["ulp_cos_mean"] + PE_MEAN_LIMIT
        print(f"PE {pos} eval profile, card vs CPU on {e['views']} graphs: "
              f"row cosines mean {e['cos_mean']:.4g}, max {e['cos_max']:.4g} "
              f"(1-ulp witness {e['ulp_cos_mean']:.4g}, "
              f"{e['ulp_cos_max']:.4g}); coordinates mean {e['mean']:.4g}, "
              f"max {e['max']:.4g}", flush=True)
        check(exact and e["cos_mean"] <= limit
              and e["cos_max"] <= PE_MAX_LIMIT,
              f"PE {pos} eval profile card vs CPU: row cosines mean "
              f"{e['cos_mean']:.3g} <= {limit:.3g} ({WITNESS_FACTOR} x witness "
              f"+ {PE_MEAN_LIMIT}), max {e['cos_max']:.3g} <= {PE_MAX_LIMIT}")
        del model
    return {("pe", "512k128"): launches[112]["pe"],
            ("jacobi", "n128"): launches[112]["jacobi"],
            ("pe", "256k96"): launches[80]["pe"],
            ("jacobi", "n96"): launches[80]["jacobi"],
            ("jacobi", "n120"): launches[104]["jacobi"],
            ("pe", "832k256"): launches[240]["pe"],
            ("jacobi", "n256"): launches[240]["jacobi"],
            **{("jacobi", key): launches[pos]["jacobi"]
               for pos, key in RECORDED_JACOBI.items()}}


def giant_across_ranks(ops, cfg, ckpt, info, check, results):
    """Phase 10's generate_graph_embeddings call again, with the giant
    graphs' partition axis across the ranks of the process group (world
    size 1 over NCCL: the path's collectives and its shard placement run,
    no scaling is measured), launch counters zeroed just before it: rows
    in order, the dense-bucket rows equal to phase 10's bit for bit, each
    giant graph's PE held to phase 10's one-process card PE by phase 10's
    witness rule (row cosines, mean within WITNESS_FACTOR x the 1-ulp
    witness's + PE_MEAN_LIMIT), the embeddings printed beside their
    witness; Kernel 3 twice per giant graph, no plain-version call. Then
    each giant graph alone (ms and
    collective calls by schedule beside phase 10's one-process ms), the
    com-DBLP-size graph's PE and encode, and Kernel 3 held on the
    matrices of the largest REDDIT-shaped graph's finish across ranks.
    Adds that row; returns its launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gcc_tpu_torch import generate
    from gcc_tpu_torch.parallel import data_parallel
    from gcc_tpu_torch.parallel import giant_features as gf
    from gcc_tpu_torch.parallel.giant import giant_gin_encode
    from gcc_tpu_torch.parallel.partitioned import place_shard
    from gcc_tpu_torch.training.checkpoint import load_encoder

    group = dist.group.WORLD
    card = load_encoder(ckpt, cfg, device="cuda").eval()
    graphs, rows = info["graphs"], info["rows"]
    gen = dict(n_max=GEN_N_MAX, e_max=GEN_E_MAX, batch_size=GEN_BATCH)
    before = data_parallel.launches.count
    with giant_pes(gf) as pes:
        emb, launches, plain, dt = counted(
            ops, lambda: generate.generate_graph_embeddings(
                cfg, card, graphs, group=group, **gen))
    collectives = data_parallel.launches.count - before
    print(f"generate_graph_embeddings across ranks (NCCL, world size "
          f"{dist.get_world_size()}), phase 10's {len(graphs)} graphs: "
          f"{dt:.2f} s; kernel launches {launches}, plain-version calls "
          f"{plain}; {collectives} collective calls "
          f"({collectives / len(rows):.1f} a giant graph)", flush=True)
    check(launches == {"featurize": 0, "pe": 1, "jacobi": 2 + 2 * len(rows)}
          and not any(plain.values()),
          f"giant across ranks: Kernel 2 once and Kernel 3 twice for the "
          f"small graphs' encode call, Kernel 3 twice per giant graph "
          f"{launches}, no plain-version call")
    small_rows = [i for i in range(len(graphs)) if i not in rows]
    check(np.array_equal(emb[small_rows], info["emb"][small_rows]),
          "across ranks: rows of the graphs within n_max equal phase 10's "
          "bit for bit")
    # Phase 10's witness rule on each giant graph's PE: row cosines
    # against phase 10's one-process card PE, mean within WITNESS_FACTOR x
    # the CPU path's 1-ulp witness + PE_MEAN_LIMIT. The embeddings are
    # printed beside their witness and held in order, as phase 10 holds
    # them (card against CPU they differ by up to ~9x their witness: the
    # finish turns last-place differences into rotations of near-degenerate
    # Ritz pairs).
    shares, worst_max, same = [], 0.0, 0
    pe_of_row = dict(zip(sorted(rows), pes))   # the call's input order
    for j, i in enumerate(rows):
        n = graphs[i].num_nodes
        mean, mx = row_cosine_errors(pe_of_row[i], info["card_pes"][j], n)
        shares.append(mean / info["pe_limits"][j])
        worst_max = max(worst_max, mx)
        same += torch.equal(pe_of_row[i][:n].cpu(), info["card_pes"][j])
        print(f"across ranks {info['names'][j]}: PE row cosines vs phase "
              f"10's card PE mean {mean:.3g} max {mx:.3g} (limit "
              f"{info['pe_limits'][j]:.3g}); embedding max abs "
              f"{np.abs(emb[i] - info['emb'][i]).max():.4g} (phase 10's "
              f"card vs CPU {info['card_vs_cpu'][j]:.4g}, witness "
              f"{info['emb_witness'][j]:.4g})", flush=True)
    check(len(pes) == len(rows) and max(shares) <= 1.0
          and worst_max <= PE_MAX_LIMIT,
          f"across ranks: each giant graph's PE row cosines against phase "
          f"10's, mean <= {WITNESS_FACTOR} x its witness's + "
          f"{PE_MEAN_LIMIT} (largest share of its limit "
          f"{max(shares):.3f}), max <= {worst_max:.3g} <= {PE_MAX_LIMIT}; "
          f"{same} of {len(rows)} PEs equal phase 10's bit for bit")
    del pes, pe_of_row
    dist_rows = np.abs(emb[rows][:, None, :]
                       - info["emb"][rows][None, :, :]).max(axis=2)
    check(bool((dist_rows.argmin(axis=1) == np.arange(len(rows))).all()),
          f"across ranks: giant rows in order, each nearest phase 10's row "
          f"of its own graph (max abs "
          f"{np.diag(dist_rows).max():.3g})")

    # Each giant graph alone across ranks, beside phase 10's times.
    timings = []
    for g in info["graphs"]:
        if g.num_nodes <= GEN_N_MAX:
            continue
        schedule = ("dense" if gf.dense_schedule_wins(g.num_edges,
                                                      g.num_nodes, 1)
                    else "ring")
        torch.cuda.synchronize()
        c0, t0 = data_parallel.launches.count, time.time()
        gf.giant_graph_embedding(card, g, group=group)
        torch.cuda.synchronize()
        timings.append((schedule, time.time() - t0,
                        data_parallel.launches.count - c0))
    for schedule in ("dense", "ring"):
        ts = [t for s_, t, _ in timings if s_ == schedule]
        calls = sorted({c for s_, _, c in timings if s_ == schedule})
        one = [t for s_, t in info["timings"] if s_ == schedule]
        print(f"giant graphs on the {schedule} schedule across ranks: "
              f"{len(ts)}, {np.mean(ts) * 1e3:.1f} ms a graph on average "
              f"(min {min(ts) * 1e3:.1f}, max {max(ts) * 1e3:.1f}; one "
              f"process in phase 10: {np.mean(one) * 1e3:.1f}; host clock, "
              f"synchronized), collective calls a graph {calls}", flush=True)
    dblp = info["dblp"]
    n, world, rank = dblp.num_nodes, dist.get_world_size(), dist.get_rank()
    pg_pe, pg_enc = (place_shard(pg, rank, "cuda")
                     for pg in gf.giant_partitions(dblp, world))
    n_pad = pg_pe.num_nodes
    lo, hi = rank * n_pad // world, (rank + 1) * n_pad // world
    q0 = torch.as_tensor(gf.giant_pe_basis(n_pad, n, 32, 16)[lo:hi],
                         device="cuda")
    mask = (torch.arange(lo, hi, device="cuda") < n).to(torch.float32)
    with torch.no_grad():
        pe_ms = timed_ms(lambda: gf.giant_laplacian_pe(
            pg_pe, q0, mask, n, group=group), 2)
        feats = gf.giant_input_features(card, dblp, gf.giant_laplacian_pe(
            pg_pe, q0, mask, n, group=group), lo)
        enc_ms = timed_ms(lambda: giant_gin_encode(card, pg_enc, feats, mask,
                                                   group=group), 3)
    print(f"com-DBLP-size graph across ranks: PE {pe_ms:.2f} ms, encode "
          f"{enc_ms:.2f} ms (CUDA events; one process in phase 10: PE "
          f"{info['pe_ms']:.2f}, encode {info['enc_ms']:.2f})", flush=True)
    del pg_pe, pg_enc, q0, feats
    torch.cuda.empty_cache()

    with torch.no_grad(), jacobi_inputs(gf) as recorded:
        gf.giant_graph_embedding(card, info["largest_reddit"], group=group)
    check(len(recorded) == 2 and all(a.shape == (1, 48, 48)
                                     for a in recorded),
          f"the finish across ranks hands Kernel 3 two (1, 48, 48) "
          f"matrices {[tuple(a.shape) for a in recorded]}")
    check_jacobi(recorded[0], check, timed=False, sweeps=GIANT_SWEEPS)
    results[("jacobi", "giant_dist")] = check_jacobi(
        recorded[1], check, key="giant_dist", sweeps=GIANT_SWEEPS)
    return {("jacobi", "giant_dist"): launches["jacobi"] - 2}


def dp_path(ops, cfg, corpus_dir, out_dir, check, results, giant_cfg,
            ckpt, giant_info):
    """Data parallel at world size 1 over NCCL (one card: NCCL refuses two
    ranks on one device, so no scaling is measured): run_pretrain of 2
    routed dispatches at the canonical width (batch 32, queue 16384, GIN
    5 x 64, 64 steps a dispatch) on one device, then the same run inside
    a process group through run_pretrain's data-parallel branch (the
    wire's device axis, PipelineConfig.devices = 1 explicit, the BN and
    gradient all-reduces, the key all-gather, rank-0 writes). The two
    loss trajectories agree to 1e-5; the collective calls are counted.
    Then, in the same group, :func:`giant_across_ranks` on phase 10's
    graphs (``giant_info``) with the serve path's checkpoint; returns its
    launches."""
    import dataclasses
    import socket

    import numpy as np
    import torch.distributed as dist

    from gcc_tpu_torch.parallel import data_parallel, multihost
    from gcc_tpu_torch.sampling.pipeline import PipelineConfig
    from gcc_tpu_torch.training import loop

    run_cfg = dataclasses.replace(cfg, epochs=1, num_workers=1,
                                  num_samples=DP_DISPATCHES * STEPS * BATCH)
    pcfg = PipelineConfig(batch_size=BATCH, n_max=N_MAX, e_max=E_MAX,
                          num_samples=run_cfg.num_samples, num_workers=1,
                          prefetch=4, emit="routed", n_small=N_SMALL,
                          devices=1)

    def run(name, **kw):
        summary, launches, plain, dt = counted(ops, lambda: loop.run_pretrain(
            run_cfg, corpus_dir, os.path.join(out_dir, name), pcfg,
            log_fn=lambda s: None, steps_per_call=STEPS, **kw))
        with open(os.path.join(summary["run_dir"], "metrics.jsonl")) as f:
            losses = np.array([json.loads(line)["loss"] for line in f])
        print(f"run_pretrain {name}: {summary['steps']} steps, training wall "
              f"{summary['wall']:.2f} s "
              f"({summary['wall'] / summary['steps'] * 1e3:.3f} ms/step), "
              f"kernel launches {launches}, plain-version calls {plain}",
              flush=True)
        check(all(c == DP_DISPATCHES for c in launches.values())
              and not any(plain.values()),
              f"run_pretrain {name}: one launch of each kernel per dispatch")
        return summary, losses

    _, single = run("one device")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    multihost.initialize_multihost(f"localhost:{port}", 1, 0, device="cuda")
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "process group: NCCL, world size 1")
        before = data_parallel.launches.count
        summary, losses = run("data parallel", dp_devices=1)
        collectives = data_parallel.launches.count - before
        giant_launches = giant_across_ranks(ops, giant_cfg, ckpt, giant_info,
                                            check, results)
    finally:
        dist.destroy_process_group()
    steps = DP_DISPATCHES * STEPS
    diff = np.abs(losses - single).max() if len(losses) == len(single) \
        else math.inf
    print(f"data parallel (NCCL, world size 1; no scaling claimed): losses "
          f"first {losses[0]:.6f} last {losses[-1]:.6f} (one device "
          f"{single[0]:.6f}, {single[-1]:.6f}), max diff {diff:.3g}; "
          f"{collectives} collective calls ({collectives / steps:.1f} a "
          f"step)", flush=True)
    check(len(losses) == len(single) == steps
          and bool(np.allclose(losses, single, rtol=1e-5, atol=1e-5)),
          f"data-parallel losses equal the one-device run's to 1e-5 "
          f"({diff:.3g})")
    check(collectives > 0, f"collectives ran ({collectives})")
    check(os.path.exists(os.path.join(summary["run_dir"], "current")),
          "rank 0 wrote the checkpoint")
    return giant_launches


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: needs an NVIDIA "
                    "card")
    sys.path.insert(0, REPO)
    try:
        from gcc_tpu_torch import ops
        from gcc_tpu_torch.config import (
            ContrastConfig,
            SamplerConfig,
            TrainConfig,
        )
        from gcc_tpu_torch.graph.corpus import synthetic_corpus
        from gcc_tpu_torch.ops import build as kernel_build
        from gcc_tpu_torch.paths import BUILD_DIR
        from gcc_tpu_torch.sampling import build as sampler_build
        from gcc_tpu_torch.sampling.pipeline import (
            PipelineConfig,
            PretrainPipeline,
        )
        from gcc_tpu_torch.training import (
            create_pretrain_state,
            train_dispatch,
        )
    except ImportError as e:
        return fail(f"run from a checkout of the repository ({e})")

    smi = gpu_line()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    check = Checks()
    t_start = time.time()
    t_phase = [t_start]

    def phase(name: str) -> None:
        now = time.time()
        print(f"phase {name}: {now - t_phase[0]:.1f} s (at {now - t_start:.1f}"
              " s)", flush=True)
        t_phase[0] = now

    # --- build: nvcc per kernel in parallel, in the background while the
    # sampler is built (g++) and the corpus is made and sampled ----------
    t_build = time.time()
    libs, kernel_err = {}, []

    def build_kernels():
        try:
            libs.update(kernel_build.build())
        except (OSError, RuntimeError) as e:
            kernel_err.append(e)

    kernel_thread = threading.Thread(target=build_kernels)
    kernel_thread.start()
    try:
        sampler_build.build()
    except (OSError, subprocess.CalledProcessError) as e:
        kernel_thread.join()
        return fail(f"sampler build failed: {e}")
    print(f"built the sampler in {time.time() - t_build:.1f} s", flush=True)

    cfg = TrainConfig(batch_size=BATCH, sampler=SamplerConfig(rw_hops=RW_HOPS),
                      contrast=ContrastConfig(moco=True, nce_k=NCE_K))
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        # --- corpus and wire batches from the port's pipeline -----------
        corpus_dir = os.path.join(work, "corpus")
        t0 = time.time()
        store = synthetic_corpus(corpus_dir, num_graphs=6,
                                 nodes_per_graph=100_000, avg_degree=12,
                                 seed=0)
        base = dict(batch_size=BATCH, n_max=N_MAX, e_max=E_MAX,
                    num_workers=1, prefetch=4, super_batch=STEPS,
                    n_small=N_SMALL)
        small_items, large_items, seen = [], [], 0
        with PretrainPipeline(store, cfg.sampler, PipelineConfig(
                emit="routed", **base), seed=0) as routed:
            while ((len(large_items) < 2 or len(small_items) < 2)
                   and seen < MAX_ROUTED_ITEMS):
                item = next(routed)
                seen += 1
                if item[0].n_max == N_MAX:
                    large_items.append(item)
                elif len(small_items) < 2:
                    small_items.append(item)
        if len(large_items) < 2 or len(small_items) < 2:
            return fail(f"{seen} routed dispatches held {len(small_items)} "
                        f"of bucket {N_SMALL} and {len(large_items)} of "
                        f"bucket {N_MAX}")
        print(f"corpus + sampling {time.time() - t0:.1f} s; {seen} routed "
              f"dispatches, {seen - len(small_items) - len(large_items)} "
              f"skipped (bucket-{N_MAX} share {len(large_items) / seen:.4f});"
              f" e_tot {routed.pcfg.e_tot_small} (bucket {N_SMALL})"
              f", {routed.pcfg.e_tot_large} (bucket {N_MAX})", flush=True)
        for item in (small_items[0], large_items[0]):
            n_nodes = item[0].meta[:, 0, :]
            print(f"bucket {item[0].n_max}: nodes per query graph mean "
                  f"{n_nodes.mean():.1f}, max {n_nodes.max()}; edges per "
                  f"query graph mean {item[0].meta[:, 1, :].mean():.1f}",
                  flush=True)
        kernel_thread.join()
        if kernel_err:
            return fail(f"kernel build failed: {kernel_err[0]}")
        print(f"built {sorted(libs)} in {time.time() - t_build:.1f} s (beside "
              "the sampler, the corpus and the sampling)", flush=True)
        phase("build, corpus and sampling")

        # --- kernels vs plain versions at the training shapes -----------
        results = {}
        k_pos = cfg.encoder.positional_embedding_size
        for name_n, item in ((N_SMALL, small_items[0]),
                             (N_MAX, large_items[0])):
            edges, meta = wire_segments(item, dev)
            feat, (adj, m_shift, deg) = check_featurize(edges, meta, name_n,
                                                        check)
            results[("featurize", name_n)] = feat
            n_nodes = meta[:, 0, :].reshape(-1)
            pe_res, q = check_pe(m_shift, n_nodes, k_pos, check)
            results[("pe", name_n)] = pe_res
            if name_n == N_SMALL:
                results[("jacobi", k_pos)] = check_jacobi(
                    rr_matrices(m_shift, q), check)
                # A batch that is no multiple of the SM count or of the
                # Jacobi kernel's four warps per block.
                _, q_odd = check_pe(m_shift[:ODD_BATCH], n_nodes[:ODD_BATCH],
                                    k_pos, check, timed=False)
                check_jacobi(rr_matrices(m_shift[:ODD_BATCH], q_odd), check,
                             timed=False)
            else:
                # The widest block (48) at the largest N of the shared
                # plan: the most shared memory Kernel 2 asks for, and
                # Kernel 3's block kernel.
                _, q48 = check_pe(m_shift, n_nodes, K_EVAL, check,
                                  timed=False)
                check_jacobi(rr_matrices(m_shift, q48), check, timed=False)
            del adj, m_shift, deg, q
            torch.cuda.empty_cache()

        # --- kernels vs plain versions at the eval shapes ---------------
        for key, jkey, count, lo, hi, n_max in (
                (GEN_N_MAX, GEN_BATCH, GEN_BATCH, 260, 512, GEN_N_MAX),
                (f"{N_MAX}k{K_EVAL}", 128, 128, 100, 256, N_MAX),
                (832, None, GEN_BATCH, 520, 832, 832)):
            m_shift, n_nodes = entire_graph_operator(
                random_graphs(n_max, count, lo, hi), n_max, GEN_E_MAX, dev)
            print(f"eval bucket {n_max}: {count} graphs, nodes mean "
                  f"{n_nodes.float().mean().item():.1f}", flush=True)
            results[("pe", key)], q = check_pe(m_shift, n_nodes, K_EVAL,
                                               check, key=key)
            s_g, t_rr = guarded_rr_matrices(m_shift, q)
            check_jacobi(s_g, check, timed=False)
            res = check_jacobi(t_rr, check, timed=jkey is not None, key=jkey)
            if jkey is not None:
                results[("jacobi", jkey)] = res
            del m_shift, q, s_g, t_rr
            torch.cuda.empty_cache()

        phase("kernels at the training and eval shapes")

        # --- training path ----------------------------------------------
        state = create_pretrain_state(cfg, total_steps=100_000, seed=0,
                                      device="cuda")
        n_conv = cfg.encoder.num_layers - 1
        idx0 = int(state.queue.index)
        train_launches = {}
        for n_bucket, item in ((N_SMALL, small_items[1]),
                               (N_MAX, large_items[1])):
            metrics, launches, plain, dt = counted(
                ops, lambda: train_dispatch(state, *item, n_max=N_MAX))
            train_launches[n_bucket] = launches
            msgs = (int(item[0].meta[:, 1, :].sum())
                    + int(item[1].meta[:, 1, :].sum())) * n_conv
            loss = metrics["loss"].cpu()
            print(f"dispatch routed {n_bucket}: {STEPS} steps in "
                  f"{dt * 1e3:.1f} ms ({dt * 1e3 / STEPS:.3f} ms/step), "
                  f"{msgs / dt:.4g} edge-messages/s, loss first "
                  f"{loss[0].item():.4f} last {loss[-1].item():.4f}, "
                  f"grad_norm last {metrics['grad_norm'][-1].item():.4f}; "
                  f"kernel launches {launches}", flush=True)
            check(bool(torch.isfinite(loss).all()),
                  f"routed {n_bucket}: loss finite")
            check(all(c == 1 for c in launches.values())
                  and not any(plain.values()),
                  f"routed {n_bucket}: every kernel launched once "
                  f"{launches}, no plain-version call")
        advanced = (int(state.queue.index) - idx0) % NCE_K
        check(advanced == (2 * STEPS * BATCH) % NCE_K,
              f"queue advanced by {advanced}")
        check(state.step == 2 * STEPS, f"{state.step} optimizer steps")
        where_the_time_goes(state, small_items[-1], cfg)
        del state
        torch.cuda.empty_cache()

        phase("training path")

        # --- serve path ------------------------------------------------
        eval_launches, ckpt, cfg2 = serve_path(
            ops, cfg, corpus_dir, os.path.join(work, "out"), check, results)
        phase("serve path")

        # --- alternate encoders ----------------------------------------
        alt_encoders(ops, cfg, small_items[1], check)
        phase("alternate encoders")

        # --- E2E headline ----------------------------------------------
        e2e_launches = e2e_path(ops, corpus_dir, os.path.join(work, "e2e"),
                                check, results)
        phase("E2E headline")

        # --- finetune --------------------------------------------------
        ft_launches = finetune_path(ops, cfg2, ckpt, check, results)
        phase("finetune")

        # --- the downstream instruments, on the serve path's checkpoint --
        instr_launches = instruments_path(
            ops, ckpt, os.path.join(work, "instruments"), check, results)
        phase("downstream instruments")

        # --- giant graphs beyond the dense bucket -------------------------
        giant_launches, giant_info = giant_path(ops, cfg2, ckpt, check,
                                                results)
        phase("giant graphs")

        # --- padded pairs wire, forked samplers, no degree input ----------
        padded_launches = loose_ends(ops, cfg, corpus_dir,
                                     os.path.join(work, "padded"),
                                     small_items[1], check, results)
        phase("padded pairs wire, no degree input")

        # --- PE 64: the kernels' new widths, through the entry points ----
        pe64_launches = pe64_path(ops, cfg, small_items, large_items, check,
                                  results)
        phase("PE 64")

        # --- every width the reference computes --------------------------
        wide_launches = wide_widths_path(ops, cfg, check, results)
        phase("wide widths")

        # --- data parallel, world size 1 over NCCL ----------------------
        dist_launches = dp_path(ops, cfg, corpus_dir,
                                os.path.join(work, "dp"), check, results,
                                cfg2, ckpt, giant_info)
        phase("data parallel, giant graphs across ranks")

    sources = {"featurize": ("gcc_tpu_torch/csrc/featurize.cu",
                             "gcc_tpu/ops/featurize_pallas.py:92"),
               "pe": ("gcc_tpu_torch/csrc/pe.cu",
                      "gcc_tpu/ops/pe_pallas.py:141"),
               "jacobi": ("gcc_tpu_torch/csrc/jacobi.cu",
                          "gcc_tpu/ops/jacobi_pallas.py:189")}
    # One entry per kernel and shape. launches: of the stretch that runs
    # that shape — the routed dispatch of its bucket for the training
    # shapes, the generate calls of its bucket for the eval shapes.
    rows = [("featurize", N_SMALL, "train", train_launches[N_SMALL]),
            ("featurize", N_MAX, "train", train_launches[N_MAX]),
            ("pe", N_SMALL, "train", train_launches[N_SMALL]),
            ("pe", N_MAX, "train", train_launches[N_MAX]),
            ("jacobi", k_pos, "train", {"jacobi": sum(
                c["jacobi"] for c in train_launches.values())})]
    rows += [(name, key, "serve", {name: n})
             for (name, key), n in eval_launches.items()]
    rows += [(name, f"e2e{n_b}", "e2e", e2e_launches)
             for n_b in (N_SMALL, N_MAX) for name in ("pe", "jacobi")]
    rows += [(name, key, "finetune", {name: n})
             for (name, key), n in ft_launches.items()]
    rows += [(name, key, "instruments", {name: n})
             for (name, key), n in instr_launches.items()]
    rows += [(name, key, "giant", {name: n})
             for (name, key), n in giant_launches.items()]
    rows += [(name, key, "padded", {name: n})
             for (name, key), n in padded_launches.items()]
    rows += [(name, key, "pe64", {name: n})
             for (name, key), n in pe64_launches.items()]
    rows += [(name, key, "wide", {name: n})
             for (name, key), n in wide_launches.items()]
    rows += [(name, key, "giant across ranks", {name: n})
             for (name, key), n in dist_launches.items()]
    kernels = []
    for name, key, path, launches in rows:
        r = results[(name, key)]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            "shape": r["shape"], "path": path,
            **{k: r[k] for k in ("cluster", "placement") if k in r},
            "pass": not any(f.startswith(name) for f in check.failed)})
    for e in kernels:
        check(e["launches"] > 0,
              f"kernel {e['name']} {e['shape']} launched on the {e['path']} "
              f"path ({e['launches']})")
        for k in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            check(math.isfinite(e[k]), f"{e['name']} {e['shape']}: {k} "
                  "measured")
    if check.failed:
        return fail(f"{len(check.failed)} check(s) failed: {check.failed}")
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
