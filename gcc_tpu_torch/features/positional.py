"""Laplacian-eigenvector positional embeddings, computed on the device.

Counterpart of ``gcc_tpu/features/positional.py`` along its production
branch: the subspace method on the shifted operator m_shift (Kernel 1's
output), with the fused subspace iteration (Kernel 2) and the Jacobi
Rayleigh–Ritz finish (Kernel 3).

Per graph b with n_b real nodes the embedding holds the
k_b = min(n_b - 2, pos_size) leading eigenvectors of
M = D^-1/2 A D^-1/2 (k_b ≤ 0 → zeros), columns in descending eigenvalue
order, signs canonicalized (largest-|entry| component positive),
columns beyond k_b zeroed, rows L2-normalized (zero rows stay zero),
padding rows zeroed.

Only the train profile (no guard columns) is on this path; the eval
profile's guarded generalized Rayleigh–Ritz comes with embedding
generation. ``normalized_adjacency`` and the shift that makes m_shift
live in ``ops/aggregate.py``, beside Kernel 1's plain version, which
composes them.
"""

from __future__ import annotations

import numpy as np
import torch

from gcc_tpu_torch.ops.jacobi import jacobi_eigh
from gcc_tpu_torch.ops.pe import pe_subspace_iterate

# The train profile's subspace iteration (positional.py:81, 373-388):
# 16 iterations re-orthonormalized every 4, no guard columns, and a
# 3-sweep parallel-order Jacobi Rayleigh–Ritz finish (3 sweeps converge
# the Ritz vectors at the canonical config, positional.py:416-429).
PE_ITERS = 16
PE_ORTH_EVERY = 4
RR_SWEEPS = 3


def subspace_start(n: int, k: int, node_mask: torch.Tensor) -> torch.Tensor:
    """Deterministic start basis: ``np.random.default_rng(2)`` normals
    (n, k), masked to real nodes and column-normalized
    (positional.py:214-223)."""
    q0 = torch.as_tensor(
        np.random.default_rng(2).standard_normal((n, k)).astype(np.float32),
        device=node_mask.device)
    q = q0[None] * node_mask[:, :, None]
    norm = torch.linalg.vector_norm(q, dim=1, keepdim=True)
    return q / torch.clamp_min(norm, 1e-20)


def subspace_topk(m_shift: torch.Tensor, node_mask: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Top-k (algebraic) eigenvectors of M from m_shift = M + I off the
    padding (spectrum shifted to [0, 2], padding at shifted 0), by the
    fused subspace iteration and a Rayleigh–Ritz finish
    (positional.py:169-370, kernel branch, train profile)."""
    n = node_mask.shape[1]
    q = pe_subspace_iterate(m_shift, subspace_start(n, k, node_mask),
                            iters=PE_ITERS, orth_every=PE_ORTH_EVERY)
    q = torch.nan_to_num(q, nan=0.0, posinf=0.0, neginf=0.0)
    # Rayleigh–Ritz on m_shift: the +I shift changes neither eigenvectors
    # nor order, and q is zero on padding rows.
    mq = torch.bmm(m_shift, q)
    t = torch.bmm(q.transpose(1, 2), mq)
    t = 0.5 * (t + t.transpose(1, 2))
    if t.shape[-1] % 2 == 0:
        _, u = jacobi_eigh(t, sweeps=RR_SWEEPS, descending=True)
    else:
        _, u = torch.linalg.eigh(t)   # odd width: the JAX eigh branch
        u = u.flip(-1)
    return torch.bmm(q, u)


def laplacian_positional_embedding(node_mask: torch.Tensor,
                                   n_nodes: torch.Tensor, pos_size: int,
                                   m_shift: torch.Tensor) -> torch.Tensor:
    """(B, N, pos_size) positional embeddings from m_shift (see module
    docstring; positional.py:76-166, subspace method)."""
    n_max = node_mask.shape[1]
    n_vec = min(pos_size, n_max)
    top = subspace_topk(m_shift, node_mask, n_vec)
    if n_vec < pos_size:
        top = torch.nn.functional.pad(top, (0, pos_size - n_vec))
    # Canonical sign: the entry of max |value| positive (ties of opposite
    # sign, or an all-zero column, keep +).
    absv = top.abs()
    mx = torch.amax(absv, dim=1, keepdim=True)
    ref = torch.sum(torch.where(absv == mx, top, torch.zeros_like(top)),
                    dim=1, keepdim=True)
    top = top * torch.sign(torch.where(ref == 0, torch.ones_like(ref), ref))
    # Zero columns >= k_b = min(n_b - 2, pos_size).
    k_b = torch.clamp(n_nodes - 2, 0, pos_size)
    col = torch.arange(pos_size, device=top.device)
    top = top * (col[None, None, :] < k_b[:, None, None])
    # Row-L2 normalize (sklearn normalize semantics: zero rows -> zero).
    norm = torch.linalg.vector_norm(top, dim=-1, keepdim=True)
    top = top / torch.where(norm == 0, torch.ones_like(norm), norm)
    return top * node_mask[:, :, None]
