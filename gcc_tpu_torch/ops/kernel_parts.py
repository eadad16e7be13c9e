"""Where Kernel 2's and Kernel 3's time goes, part by part, on the card;
and Kernel 1 by width, dtype and cluster.

Usage (on a machine with an NVIDIA GPU, from the repository root):

    python -m gcc_tpu_torch.ops.kernel_parts [--graphs 4096]
        [--cases all|train|eval|pe64|general|jacobi|featurize]

``--cases featurize`` times ``fused_adjacency_featurize`` in f32 and
bf16 on seeded random wires shaped like the routed pipeline's (32 graphs
a segment, nodes uniform in [1, N], twice as many directed edges as
nodes, both directions of each) at the training shapes (4096 graphs at
N = 128 and 256), at N = 240, and at the E2E size split's class shapes
(3840 graphs at N = 128, 256 at N = 256), each beside its bytes bound;
where the package's plan takes a cluster (``aggregate._launch``), also
at every band cluster that fits. Run it with the parent's package too
(see below) to compare the two on one card.

Times ``pe_subspace_iterate`` (CUDA events, mean of several launches)
under schedules that switch its parts off — the bf16 rounds alone, the
power steps alone, the f32 polish alone, the f32 Newton–Schulz finish
alone — at the training path's shapes and, on fewer graphs, at the
shapes of embedding generation (k = 48; N = 512 and 832 take the
kernel's streamed plan, a cluster of blocks per graph whose size is
printed beside each case; a batch of 64 at N = 512 with 32 and with 384
live nodes stands for the node path's and the graph path's buckets),
at the four shapes of PE 64 (``--cases pe64``: k = 64 on 4096 graphs at
N = 128 and 256, k = 80 on 128 graphs at N = 256 and 64 at N = 512 —
the wide plan — with the mean live nodes of chip_smoke.py's batches
there: 56, 166, 174 and 381), at the three shapes of the general plan
(``--cases general``: k = 96 on 128 graphs at N = 256, k = 128 on 64 at
N = 512, k = 256 on 16 at N = 832 — clusters of 1, 2 and 6 blocks a
graph — with the mean live nodes of chip_smoke.py's seeded graphs there:
174, 381 and 677), and ``jacobi_eigh`` per sweep count (0,
1, 3, 5) on random symmetric matrices at each width's main-path batch —
n = 32 and 48 on 4096, 48 on 128 and 64, PE 64's n = 64 on 4096 and
n = 80 on 64 and one (its giant finish), and the cluster pair kernel's
main shapes, n = 96 on 128 (PE 80), 128 on 64 (PE 112) and 256 on 16 (PE
240), and its device-scratch placement at n = 512 on 4 (PE 496), 64 and
132 (one wave of one-block clusters; these three at 3 launches a sweep
count, the rest at 20), its cluster printed beside them — so that a
round's cost can be read (the Jacobi launches are queued behind a few
ms of other work, so the card's time is read and not the host's rate of
launching). Kernel 2
skips the zero padding of the node axis, so its time depends on how
many nodes are live: the operators are dense (all N live, the most work
a shape can ask for) except one case with 56 live nodes of 128, the
mean of the main path's small bucket. Prints the card's nvidia-smi name and power limit first. The
parts do not add up exactly to the whole: every schedule also loads M
and writes the result.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

import numpy as np

from gcc_tpu_torch.ops import aggregate, jacobi
from gcc_tpu_torch.ops.jacobi import jacobi_eigh
from gcc_tpu_torch.ops.pe import pe_launch_plan, pe_subspace_iterate


def timed_ms(fn, reps: int = 5, run_ahead: bool = False) -> float:
    """Mean device time of fn() over reps calls (CUDA events). A launch
    shorter than the host takes to enqueue it (~50 us through the
    wrappers) would be timed at the host's rate: ``run_ahead`` first
    queues a few ms of other work, so the launches are all enqueued
    before the card reaches them."""
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


def _plan(n: int, k: int, graphs: int) -> dict:
    try:
        return pe_launch_plan(n, k, graphs)
    except TypeError:   # a package whose plan does not take the batch
        return pe_launch_plan(n, k)


def _jacobi_plan(n: int, g: int) -> str:
    """The Jacobi plan's cluster and placement, where the package has
    them."""
    if hasattr(jacobi, "cluster_held"):
        plan = jacobi.jacobi_launch_plan(n, g, jacobi.cluster_held())
    else:               # a package whose plan does not ask the card
        plan = jacobi.jacobi_launch_plan(n, g)
    return (f"cluster={plan.get('cluster', 1)} "
            f"placement={plan.get('placement', '-')} "
            f"items={plan.get('items', '-')}")


PEAK_BYTES = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)


def featurize_wire(graphs: int, n_max: int, b: int = 32, seed: int = 0,
                   device="cuda"):
    """(edges (S, E_tot) int32, meta (S, 3, B) int32) on ``device``: S =
    graphs / b segments; graph j has n_j ~ U[1, N] nodes and n_j random
    undirected edges, both directions stored one after the other (8-bit
    ids); E_tot = 2·b·N."""
    rng = np.random.default_rng(seed)
    s = graphs // b
    n = rng.integers(1, n_max + 1, (s, b))
    gid = np.repeat(np.arange(s * b), n.ravel())
    u = (rng.random(gid.size) * n.ravel()[gid]).astype(np.int64)
    v = (rng.random(gid.size) * n.ravel()[gid]).astype(np.int64)
    packed = np.stack([u | (v << 8), v | (u << 8)], 1).ravel()
    seg = np.repeat(gid // b, 2)
    first = np.concatenate([[0], np.cumsum(2 * n.sum(1))[:-1]])
    e_tot = 2 * b * n_max
    edges = np.zeros((s, e_tot), np.int32)
    edges[seg, np.arange(packed.size) - first[seg]] = packed
    meta = np.stack([n, 2 * n, np.zeros_like(n)], 1).astype(np.int32)
    return (torch.as_tensor(edges, device=device),
            torch.as_tensor(meta, device=device))


def featurize_cases() -> None:
    """Kernel 1 by shape and dtype (and band cluster, where the package's
    wrapper takes one), each beside its bytes bound."""
    plan_of = getattr(aggregate, "featurize_launch_plan", None)
    for graphs, n in ((4096, 128), (4096, 256), (4096, 240), (3840, 128),
                      (256, 256)):
        edges, meta = featurize_wire(graphs, n)
        for dtype in (torch.float32, torch.bfloat16):
            size = 2 if dtype == torch.bfloat16 else 4
            nbytes = edges.numel() * 4 + meta.numel() * 4 \
                + graphs * n * n * 2 * size + graphs * n * 4
            bound = nbytes / PEAK_BYTES * 1e3
            clusters = [0]
            if plan_of is not None:
                base = plan_of(n, edges.shape[1], dtype)
                if base["path"] == "band":
                    clusters += [c for c in range(1, 5) if c != base["cluster"]
                                 and _fits(plan_of, n, edges.shape[1], dtype,
                                           c)]
            for c in clusters:
                def fn():
                    if c:
                        return aggregate._launch(edges, meta, n, 8, dtype, c)
                    return aggregate.fused_adjacency_featurize(
                        edges, meta, n, 8, dtype)

                ms = timed_ms(fn, 20)
                how = (f"path={plan_of(n, edges.shape[1], dtype, c)['path']} "
                       f"cluster={c or base['cluster']}" if plan_of
                       else "per-tile design")
                print(f"featurize ({graphs}, {n}, {n}) {str(dtype)[6:]} {how}"
                      f": {ms:.4f} ms, bound {bound:.4f} ms (bytes), "
                      f"{100 * bound / ms:.1f}%", flush=True)
        del edges, meta
        torch.cuda.empty_cache()


def _fits(plan_of, n: int, e_tot: int, dtype, cluster: int) -> bool:
    try:
        plan_of(n, e_tot, dtype, cluster)
    except ValueError:
        return False
    return True


SCHEDULES = (
    ("whole (train profile)", dict()),
    ("bf16 rounds only", dict(polish=0, final_ns=0)),
    ("16 bf16 power steps, one NS step", dict(orth_every=16, ns_steps=1,
                                               polish=0, final_ns=0)),
    ("one bf16 power step, 16 NS steps", dict(iters=1, orth_every=1,
                                               ns_steps=16, polish=0,
                                               final_ns=0)),
    ("one bf16 power step, no NS step (load + store)",
     dict(iters=1, orth_every=1, ns_steps=0, polish=0, final_ns=0)),
    ("f32 polish only (+1 bf16 step)", dict(iters=1, orth_every=1,
                                            ns_steps=0, polish=2,
                                            final_ns=0)),
    ("f32 NS finish only (+1 bf16 step)", dict(iters=1, orth_every=1,
                                               ns_steps=0, polish=0,
                                               final_ns=8)),
    ("f32 rounds everywhere (power_lo=False)", dict(power_lo=False)),
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graphs", type=int, default=4096)
    ap.add_argument("--cases", default="all",
                    choices=("all", "train", "eval", "pe64", "general",
                             "jacobi", "featurize"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_parts: needs an NVIDIA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    train = ((128, 32, 128, args.graphs), (128, 32, 56, args.graphs),
             (256, 32, 256, args.graphs), (256, 48, 256, args.graphs))
    evals = ((512, 48, 512, 128), (512, 48, 384, 128), (512, 48, 384, 64),
             (512, 48, 32, 64), (832, 48, 832, 64))
    pe64 = ((128, 64, 56, args.graphs), (256, 64, 166, args.graphs),
            (256, 80, 174, 128), (512, 80, 381, 64))
    general = ((256, 96, 174, 128), (512, 128, 381, 64), (832, 256, 677, 16))
    pe_cases = {"all": train + evals + pe64 + general, "train": train,
                "eval": evals, "pe64": pe64, "general": general,
                "jacobi": (), "featurize": ()}[args.cases]
    if args.cases in ("all", "featurize"):
        featurize_cases()
    for n, k, live, g in pe_cases:
        a = torch.rand(g, n, n, device=dev, generator=gen) / n
        m = a + a.transpose(1, 2) + torch.eye(n, device=dev)
        q0 = torch.randn(g, n, k, device=dev, generator=gen)
        m[:, live:, :] = 0
        m[:, :, live:] = 0
        q0[:, live:, :] = 0
        q0 = q0 / q0.norm(dim=1, keepdim=True)
        for name, kw in SCHEDULES:
            kw = dict(dict(iters=16), **kw)
            ms = timed_ms(lambda: pe_subspace_iterate(m, q0, **kw))
            plan = _plan(n, k, g)
            print(f"pe ({g}, {n}, {n}) k={k} live={live} plan={plan['plan']}"
                  f" layout={plan['layout']} cluster={plan['cluster']} "
                  f"{name}: {ms:.4f} ms", flush=True)
        del a, m, q0
    jacobi_cases = ((32, args.graphs), (48, args.graphs), (48, 128), (48, 64),
                    (64, args.graphs), (80, 64), (80, 1), (96, 128),
                    (128, 64), (256, 16), (512, 4), (512, 64), (512, 132))
    for n, g in jacobi_cases if args.cases in ("all", "jacobi") else ():
        t = torch.randn(g, n, n, device=dev, generator=gen)
        t = 0.5 * (t + t.transpose(1, 2))
        plan = _jacobi_plan(n, g)
        for sweeps in (0, 1, 3, 5):
            ms = timed_ms(lambda: jacobi_eigh(t, sweeps=sweeps,
                                              descending=True),
                          20 if n < 512 else 3, run_ahead=True)
            print(f"jacobi ({g}, {n}, {n}) sweeps={sweeps} {plan}: "
                  f"{ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
