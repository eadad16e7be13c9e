"""Kernel 3's pair kernel at other instances than the ones it ships.

Usage (on a machine with an NVIDIA GPU, from the repository root):

    python -m gcc_tpu_torch.ops.jacobi_instances [--reps 30]

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
printed. Prints the card's nvidia-smi name and power limit first.
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("jacobi_instances: needs an NVIDIA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
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
