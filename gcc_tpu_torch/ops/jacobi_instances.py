"""Kernel 3's pair kernel at other instances than the ones it ships, and
the cluster pair kernel at every cluster and items a thread.

Usage (on a machine with an NVIDIA GPU, from the repository root):

    python -m gcc_tpu_torch.ops.jacobi_instances [--reps 30]
        [--cases all|pair|cluster]

``csrc/jacobi.cu`` builds ``jacobi_pair_kernel`` for n = 48, 64 and 80,
each at a number of 2x2 blocks per thread ("items") and of blocks per SM
(its ``__launch_bounds__``, which caps the registers). This script
builds copies of the source with other choices (into
``build/gcc_tpu_torch/jacobi_instances/``; library 0 is the source as it
is), prints ptxas' registers and spills for every instance, holds each
against ``jacobi_eigh_plain`` bit for bit, and times each (CUDA events,
``run_ahead``) at its width's main-path batches: n = 48 at 64 matrices
(the eval profile) and 4096, n = 64 at 4096 (PE 64's train profile),
n = 80 at 64 (its eval profile, 3 sweeps) and one (its giant finish,
5 sweeps). Libraries run in turn, then in reverse turn; both times are
printed. ``--cases cluster`` times the cluster pair kernel (one library:
its items a thread are instances of the source, the cluster a launch
argument) at (16, 256, 256) on every legal cluster (5 to 8 blocks a
matrix) and at (128, 96, 96) on 1 to 8, each at every items a thread (6,
4, 3, 2), and at every items on the plan's cluster at (64, 128, 128),
(64, 120, 120) and (64, 58, 58), 3 sweeps, held bit for bit to the
plain version, in turn then in reverse turn, the plan's choice marked.
Prints the card's nvidia-smi name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess

import torch

from gcc_tpu_torch.ops import build as _build
from gcc_tpu_torch.ops import jacobi
from gcc_tpu_torch.ops.kernel_parts import timed_ms
from gcc_tpu_torch.paths import BUILD_DIR

# (items, blocks per SM) to try at each width; the first is the shipped one.
CANDIDATES = {48: ((1, 3), (1, 1)),
              64: ((4, 3), (2, 3), (2, 2), (1, 2)),
              80: ((5, 1), (2, 1))}
SHAPES = {48: ((64, 3), (4096, 3)), 64: ((4096, 3),), 80: ((64, 3), (1, 5))}
CONSTANTS = r"constexpr int kPair{n}Items = (\d+), kPair{n}Blocks = (\d+);"


def source_with(src: str, choice: dict) -> str:
    """The source with each width's (items, blocks per SM) replaced."""
    for n, (items, blocks) in choice.items():
        src, hits = re.subn(CONSTANTS.format(n=n),
                            f"constexpr int kPair{n}Items = {items}, "
                            f"kPair{n}Blocks = {blocks};", src)
        if hits != 1:
            raise RuntimeError(f"jacobi.cu: no constants of the n={n} "
                               "instance")
    return src


def ptxas_report(log: str) -> dict:
    """{(n, items, blocks): 'R registers, S bytes spilled'} of the pair
    kernel's instances in an `nvcc -Xptxas -v` log."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"jacobi_pair_kernelILi(\d+)ELi(\d+)ELi(\d+)E", line)
        if "Compiling entry function" in line:
            key = tuple(int(g) for g in m.groups()) if m else None
        elif key and "spill stores" in line:
            out[key] = f"{line.split(',')[1].split()[0]} B spilled"
        elif key and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[key] = f"{regs} registers, {out.get(key, '?')}"
    return out


# The cluster pair kernel's shapes (batch, n): every cluster and items at
# the first two, every items at the plan's cluster at the others.
CLUSTER_SHAPES = ((16, 256), (128, 96))
ITEMS_SHAPES = ((64, 128), (64, 120), (64, 58))


def cluster_sweep(reps: int) -> None:
    """Every legal (cluster, items) of the cluster pair kernel at
    CLUSTER_SHAPES and every items at ITEMS_SHAPES' planned cluster, 3
    sweeps: bit for bit the plain version, timed in turn and in reverse
    turn."""
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    held = jacobi.cluster_held()
    for batch, n in CLUSTER_SHAPES + ITEMS_SHAPES:
        t = torch.randn(batch, n, n, device=dev, generator=gen)
        t = 0.5 * (t + t.transpose(1, 2))
        w0, v0 = jacobi.jacobi_eigh_plain(t, sweeps=3, descending=True)
        plan = jacobi.jacobi_launch_plan(n, batch, held)
        clusters = (range(plan["least_cluster"], jacobi.MAX_CLUSTER + 1)
                    if (batch, n) in CLUSTER_SHAPES else (plan["cluster"],))
        tried = [(c, i) for c in clusters for i in jacobi.CLUSTER_ITEMS]
        times = {}
        for c, i in tried + tried[::-1]:
            run = (lambda c=c, i=i: jacobi._launch(t, 3, 1e-12, True, c, i))
            w, v = run()
            if not (torch.equal(w, w0) and torch.equal(v, v0)):
                raise RuntimeError(f"jacobi ({batch}, {n}, {n}) cluster={c} "
                                   f"items={i}: not equal to the plain "
                                   "version")
            times.setdefault((c, i), []).append(
                timed_ms(run, reps, run_ahead=True))
        for (c, i), ms in times.items():
            p = jacobi.jacobi_launch_plan(n, batch, held, cluster=c, items=i)
            chosen = (c, i) == (plan["cluster"], plan["items"])
            print(f"jacobi ({batch}, {n}, {n}) sweeps=3: cluster={c} "
                  f"items={i} threads={p['threads']} smem={p['smem_bytes']} "
                  f"held={held[c - 1]}{' plan' if chosen else ''}: "
                  + " ".join(f"{x:.4f}" for x in ms) + " ms, equal to the "
                  "plain version", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--cases", default="all",
                    choices=("all", "pair", "cluster"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("jacobi_instances: needs an NVIDIA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    if args.cases in ("all", "cluster"):
        cluster_sweep(args.reps)
    if args.cases == "cluster":
        return
    with open(_build.source_path("jacobi")) as f:
        src = f.read()
    shipped = {n: tuple(int(g) for g in re.search(
        CONSTANTS.format(n=n), src).groups()) for n in CANDIDATES}
    if shipped != {n: c[0] for n, c in CANDIDATES.items()}:
        raise RuntimeError(f"the shipped instances {shipped} are not the "
                           "first candidates")
    choices = [{n: c[min(i, len(c) - 1)] for n, c in CANDIDATES.items()}
               for i in range(max(map(len, CANDIDATES.values())))]
    out_dir = os.path.join(BUILD_DIR, "jacobi_instances")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for i, choice in enumerate(choices):
        path = os.path.join(out_dir, f"jacobi_{i}.cu")
        with open(path, "w") as f:
            f.write(source_with(src, choice))
        procs.append(subprocess.Popen(
            [_build.nvcc_path(), "-Xptxas", "-v", *_build.NVCC_FLAGS, "-o",
             path[:-3] + ".so", path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs, report = [], {}
    for proc, i in zip(procs, range(len(choices))):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc jacobi_{i}.cu failed:\n{log}")
        report.update(ptxas_report(log))
        lib = ctypes.CDLL(os.path.join(out_dir, f"jacobi_{i}.so"))
        lib.gcc_jacobi_launch.argtypes = jacobi._JACOBI_ARGS
        lib.gcc_jacobi_launch.restype = ctypes.c_int
        libs.append(lib)

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    saved = _build._libs.get("jacobi")
    times = {}
    try:
        for n, shapes in SHAPES.items():
            # Library i holds candidate i of every width that has one.
            tried = list(enumerate(CANDIDATES[n]))
            for batch, sweeps in shapes:
                t = torch.randn(batch, n, n, device=dev, generator=gen)
                t = 0.5 * (t + t.transpose(1, 2))
                w0, v0 = jacobi.jacobi_eigh_plain(t, sweeps=sweeps,
                                                  descending=True)
                for i, (items, blocks) in tried + tried[::-1]:
                    _build._libs["jacobi"] = libs[i]
                    w, v = jacobi.jacobi_eigh(t, sweeps=sweeps,
                                              descending=True)
                    if not (torch.equal(w, w0) and torch.equal(v, v0)):
                        raise RuntimeError(
                            f"jacobi ({batch}, {n}, {n}) items={items} "
                            f"blocks={blocks}: not equal to the plain "
                            "version")
                    times.setdefault((n, batch, sweeps, items, blocks),
                                     []).append(timed_ms(
                        lambda: jacobi.jacobi_eigh(t, sweeps=sweeps,
                                                   descending=True),
                        args.reps, run_ahead=True))
    finally:
        _build._libs.pop("jacobi", None)
        if saved is not None:
            _build._libs["jacobi"] = saved
    for (n, batch, sweeps, items, blocks), ms in times.items():
        print(f"jacobi ({batch}, {n}, {n}) sweeps={sweeps}: items={items} "
              f"threads={(n // 2) ** 2 // items} blocks/SM={blocks} "
              f"({report.get((n, items, blocks), '?')})"
              f"{' shipped' if shipped[n] == (items, blocks) else ''}: "
              + " ".join(f"{x:.4f}" for x in ms) + " ms, equal to the "
              "plain version", flush=True)


if __name__ == "__main__":
    main()
