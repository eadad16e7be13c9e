"""Kernel 2, the PE's block subspace iteration, for each graph at its real
n nodes with a block of k columns: 16 power steps of 2n²k operations on
bf16 operands, a Newton-Schulz orthonormalization of 4 steps after every
4 (each step one symmetric Gram, n·k(k+1), and one (k, k)·(k, n) product,
2nk², also on bf16 operands), then 2 float32 polish steps (2n²k each) and
an 8-step float32 Newton-Schulz finish. Bytes: the n² operator (float32)
read once, the (n, k) start read and the (n, k) basis written."""

from __future__ import annotations

import numpy as np

ITERS, ORTH_EVERY, NS_STEPS, POLISH, FINAL_NS = 16, 4, 4, 2, 8


def work(n_nodes, k: int) -> dict:
    n = np.asarray(n_nodes, np.float64)
    ns = n * k * (k + 1) + 2.0 * n * k * k
    rounds = max(1, ITERS // ORTH_EVERY)
    bf16 = 2.0 * n * n * k * ITERS + rounds * NS_STEPS * ns
    f32 = 2.0 * n * n * k * POLISH + FINAL_NS * ns
    nbytes = 4.0 * n * n + 2.0 * 4.0 * n * k
    return {"f32": float(np.sum(f32)), "bf16": float(np.sum(bf16)),
            "bytes": float(np.sum(nbytes))}
