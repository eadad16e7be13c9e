"""Build and load the port's CUDA kernels.

Usage: ``python -m gcc_tpu_torch.ops.build`` (builds every kernel).

Each kernel source ``gcc_tpu_torch/csrc/<name>.cu`` has a plain C
interface and is compiled by ``nvcc`` for Hopper (``sm_90a``) into its
own shared library, ``build/gcc_tpu_torch/lib<name>-<digest>.so``, which
the op modules load with ctypes. The digest covers the source and the
flags, so an edited source is rebuilt and a stale library is never
loaded. Building happens at first use, from the repository's sources
only; :func:`build` starts one ``nvcc`` per missing library, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys

from gcc_tpu_torch.paths import BUILD_DIR, PACKAGE_DIR

CSRC = os.path.join(PACKAGE_DIR, "csrc")
KERNELS = ("featurize", "pe", "jacobi")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("gcc_tpu_torch: nvcc not found (set CUDA_HOME); the "
                       "CUDA kernels are built from source at first use")


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    with open(source_path(name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=KERNELS, verbose: bool = False) -> dict[str, str]:
    """Compile every library in ``names`` that is missing, one ``nvcc``
    per source, all started together. Returns {name: library path}.
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory, spills)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = {name: library_path(name) for name in names}
    procs = {}
    for name, path in out.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        if verbose and log:
            print(f"--- nvcc {name}.cu:\n{log}", file=sys.stderr)
        os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("gcc_tpu_torch: kernel build failed\n"
                           + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built if needed (cached per process)."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build((name,))[name])
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"gcc_tpu_torch: {what} launch failed with CUDA "
                           f"error {err}")


if __name__ == "__main__":
    for name, path in build(verbose="--verbose" in sys.argv).items():
        print(name, path)
