"""Kernel 3, the batched Jacobi eigensolver of the Rayleigh-Ritz finish,
for ``batch`` symmetric n × n matrices: each of the sweeps·(n - 1) rounds
mixes the rows and the columns of A and the rows of Vᵀ (3n² products and
sums each, 9n² in all) and computes n/2 rotations (about 20 operations
each, 10n). Bytes: A read, V and the n eigenvalues written (float32)."""

from __future__ import annotations


def work(n: int, batch: int, sweeps: int = 3) -> dict:
    ops = float(batch) * sweeps * (n - 1) * (9.0 * n * n + 10.0 * n)
    return {"f32": ops, "bf16": 0.0,
            "bytes": float(batch) * (2.0 * n * n + n) * 4.0}
