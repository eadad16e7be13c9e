"""Build the native sampler shared library for the port.

Usage: ``python -m gcc_tpu_torch.sampling.build``

Compiles the repository's shared host sampler ``csrc/sampler.cpp`` with
g++ (one translation unit, no external deps) into the port's own build
directory, ``build/gcc_tpu_torch/libgccsampler.so``.
"""

from __future__ import annotations

import os
import subprocess
import sys

from gcc_tpu_torch.paths import BUILD_DIR, REPO_ROOT

SRC = os.path.join(REPO_ROOT, "csrc", "sampler.cpp")
OUT = os.path.join(BUILD_DIR, "libgccsampler.so")


def build(force: bool = False) -> str:
    """Compile csrc/sampler.cpp → build/gcc_tpu_torch/libgccsampler.so
    (skipped while the library is newer than the source)."""
    if not force and os.path.exists(OUT) and (
        os.path.getmtime(OUT) >= os.path.getmtime(SRC)
    ):
        return OUT
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Compile to a private name and rename: concurrent first uses (test
    # workers, pipeline threads) never load a half-written library.
    tmp = f"{OUT}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        "-fno-exceptions", "-o", tmp, SRC,
    ]
    subprocess.run(cmd, check=True)
    os.replace(tmp, OUT)
    return OUT


if __name__ == "__main__":
    path = build(force="--force" in sys.argv)
    print(path)
