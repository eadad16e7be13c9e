"""Laplacian-eigenvector positional embeddings, computed on the device.

Counterpart of ``gcc_tpu/features/positional.py``. Per graph b with n_b
real nodes the embedding holds the k_b = min(n_b - 2, pos_size) leading
eigenvectors of M = D^-1/2 A D^-1/2 (k_b ≤ 0 → zeros), columns in
descending eigenvalue order, signs canonicalized (largest-|entry|
component positive), columns beyond k_b zeroed, rows L2-normalized (zero
rows stay zero), padding rows zeroed.

Two methods: ``"eigh"`` (exact, ``torch.linalg.eigh``; oracle tests and
small buckets) and ``"subspace"`` — block subspace iteration on the
shifted operator m_shift (Kernel 2) with a Jacobi Rayleigh–Ritz finish
(Kernel 3). Two profiles of the subspace method
(``positional.py:373-388``): ``"train"`` iterates exactly ``pos_size``
columns; ``"eval"`` (embedding generation) iterates 16 guard columns
more, whitens the guarded basis by a generalized Rayleigh–Ritz (a second
Jacobi solve, on the Gram matrix) and drops the guards after the
rotation. The reference reads its switches from the environment
(``GCC_TPU_PE_GUARDS``, ``GCC_TPU_PE_RR``, ``GCC_TPU_PE_RR_SWEEPS``);
here they are the keyword arguments ``guards``, ``rr`` and ``rr_sweeps``
with the same defaults. (``GCC_TPU_JACOBI_LAYOUT`` picks between two
numerically identical memory layouts of the reference's Jacobi; the
port's Jacobi has one layout and no such argument.)

``normalized_adjacency`` and the shift that makes m_shift live in
``ops/aggregate.py``, beside Kernel 1's plain version, which composes
them.
"""

from __future__ import annotations

import numpy as np
import torch

from gcc_tpu_torch.ops.aggregate import normalized_adjacency, shifted_operator
from gcc_tpu_torch.ops.jacobi import jacobi_eigh
from gcc_tpu_torch.ops.pe import MAX_NODES, _bf16_round, pe_subspace_iterate

# The subspace iteration's schedule (positional.py:81): 16 iterations
# re-orthonormalized every 4, and a 3-sweep parallel-order Jacobi
# Rayleigh–Ritz finish (3 sweeps converge the Ritz vectors at the
# canonical config, positional.py:416-429).
PE_ITERS = 16
PE_ORTH_EVERY = 4
RR_SWEEPS = 3
EVAL_GUARDS = 16


def pe_guards(profile: str = "train") -> int:
    """Guard columns of the subspace PE per profile: "train" → 0 (the
    guarded path triples the featurize cost and training-time fidelity
    does not move transfer), "eval" → 16 (generation runs once per
    dataset, and 16 guards restore the eigenvector fidelity where the
    embeddings are consumed; positional.py:373-388)."""
    if profile not in ("train", "eval"):
        raise ValueError(f"unknown PE profile: {profile!r}")
    return EVAL_GUARDS if profile == "eval" else 0


def subspace_start(n: int, k: int, node_mask: torch.Tensor) -> torch.Tensor:
    """Deterministic start basis: ``np.random.default_rng(2)`` normals
    (n, k), masked to real nodes and column-normalized
    (positional.py:214-223)."""
    q0 = torch.as_tensor(
        np.random.default_rng(2).standard_normal((n, k)).astype(np.float32),
        device=node_mask.device)
    return _colnorm(q0[None] * node_mask[:, :, None])


def _colnorm(q: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(q, dim=1, keepdim=True)
    return q / torch.clamp_min(norm, 1e-20)


def _finite(q: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(q, nan=0.0, posinf=0.0, neginf=0.0)


def _gram(q: torch.Tensor) -> torch.Tensor:
    return torch.bmm(q.transpose(1, 2), q)


def _eye_like(k: int, ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(k, dtype=ref.dtype, device=ref.device)


def _dense_iterate(m_shift: torch.Tensor, q: torch.Tensor, iters: int,
                   orth_every: int) -> torch.Tensor:
    """The subspace iteration for buckets beyond Kernel 2's reach
    (N > 832), as plain batched products — the branch the reference runs
    outside any kernel (positional.py:275-296): CholeskyQR, power steps
    with bf16 inputs and f32 sums re-orthonormalized by Newton–Schulz
    every ``orth_every`` steps, two f32 polish steps, CholeskyQR."""

    def orth_ns(q, steps: int = 4):
        q = _colnorm(q)
        gram = _gram(q)
        bound = torch.amax(torch.sum(gram.abs(), dim=2), dim=1)
        scale = torch.rsqrt(torch.clamp_min(bound, 1e-20))
        q = q * scale[:, None, None]
        gram = gram * (scale * scale)[:, None, None]
        for i in range(steps):
            if i:
                gram = _gram(q)
            q = 1.5 * q - 0.5 * torch.bmm(q, gram)
        return _finite(q)

    def orth_chol(q):
        q = _colnorm(q)
        low = torch.linalg.cholesky(_gram(q) + 1e-5 * _eye_like(q.shape[2], q))
        # X Lᵀ = Q
        return _finite(torch.linalg.solve_triangular(
            low.transpose(1, 2), q, upper=True, left=False))

    m_lo = _bf16_round(m_shift)
    q = orth_chol(q)
    for i in range(iters):
        q = torch.bmm(m_lo, _bf16_round(q))
        if (i + 1) % orth_every == 0 and i != iters - 1:
            q = orth_ns(q)
    for _ in range(2):
        q = _colnorm(torch.bmm(m_shift, q))
    return orth_chol(q)


def _small_eigh(a: torch.Tensor, rr: str, sweeps: int):
    """Eigenpairs of a batch of small symmetric matrices, descending: the
    Jacobi kernel for an even width, ``torch.linalg.eigh`` for an odd one
    or on request (the reference's ``GCC_TPU_PE_RR=eigh`` oracle)."""
    if rr not in ("jacobi", "eigh"):
        raise ValueError(f"unknown Rayleigh-Ritz method: {rr!r}")
    if rr == "jacobi" and a.shape[-1] % 2 == 0:
        return jacobi_eigh(a, sweeps=sweeps, descending=True)
    w, v = torch.linalg.eigh(a)
    return w.flip(-1), v.flip(-1)


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def guarded_whitening(q: torch.Tensor, jitter: float, eigh,
                      all_sum=_same) -> torch.Tensor:
    """Generalized Rayleigh–Ritz whitening of a guarded (B, N, k) basis.

    A guarded basis is ill-conditioned in the guard directions (they sit
    in the clustered spectral bulk), and Rayleigh–Ritz on a
    non-orthonormal basis mixes eigenvectors: solve the generalized
    problem instead. Eigendecompose the Gram S + jitter·I = V·s·Vᵀ with
    ``eigh`` (descending) and whiten with W = V·s^-1/2, so (QW)ᵀ(QW) = I.
    Relative floor: directions whose s is under 0.1·s_max are numerically
    collapsed (the graph is smaller than the block, or the iteration drove
    them dependent); whitening would amplify f32 noise into Ritz
    directions. They are dropped: their rows of T become 0 and their Ritz
    values sink to the bottom.

    ``all_sum`` completes the Gram of a basis whose rows are spread over
    several ranks (the giant path's all-reduce); in one process it is the
    identity."""
    s_g = all_sum(_gram(q))
    s_g = 0.5 * (s_g + s_g.transpose(1, 2))
    s_g = s_g + jitter * _eye_like(q.shape[2], s_g)
    sv, v = eigh(s_g)
    floor = 0.1 * sv[:, :1]
    keep = (sv > floor).to(q.dtype)
    w = v * (torch.rsqrt(torch.maximum(sv, floor)) * keep)[:, None, :]
    return torch.bmm(q, w)


def subspace_topk(m_shift: torch.Tensor, node_mask: torch.Tensor, k: int,
                  guards: int = 0, iters: int = PE_ITERS,
                  orth_every: int = PE_ORTH_EVERY, rr: str = "jacobi",
                  rr_sweeps: int = RR_SWEEPS) -> torch.Tensor:
    """Top-k (algebraic) eigenvectors of M from m_shift = M + I off the
    padding (spectrum shifted to [0, 2], padding at shifted 0), by
    subspace iteration and a Rayleigh–Ritz finish
    (positional.py:169-370). ``guards`` extra columns are iterated and
    dropped after the rotation."""
    n = node_mask.shape[1]
    k_keep = k
    # Guarded block width: even (the Jacobi pairs columns), ≤ n.
    k = min(n, k_keep + max(0, guards))
    k = max(k - (k % 2), k_keep)
    q = subspace_start(n, k, node_mask)
    if n <= MAX_NODES:
        # Kernel 2. Its f32 Newton–Schulz finish returns a near-
        # orthonormal basis, so Rayleigh–Ritz runs directly.
        q = _finite(pe_subspace_iterate(m_shift, q, iters=iters,
                                        orth_every=orth_every))
    else:
        q = _dense_iterate(m_shift, q, iters, orth_every)

    if k > k_keep:
        q = guarded_whitening(q, 1e-5,
                              lambda s: _small_eigh(s, rr, rr_sweeps))

    # Rayleigh–Ritz on m_shift: the +I shift changes neither eigenvectors
    # nor order, and q is zero on padding rows.
    mq = torch.bmm(m_shift, q)
    t = torch.bmm(q.transpose(1, 2), mq)
    t = 0.5 * (t + t.transpose(1, 2))
    _, u = _small_eigh(t, rr, rr_sweeps)
    return torch.bmm(q, u[:, :, :k_keep])


def laplacian_positional_embedding(node_mask: torch.Tensor,
                                   n_nodes: torch.Tensor, pos_size: int,
                                   m_shift: torch.Tensor | None = None,
                                   adj: torch.Tensor | None = None,
                                   method: str = "subspace",
                                   profile: str = "train",
                                   guards: int | None = None,
                                   rr: str = "jacobi",
                                   rr_sweeps: int = RR_SWEEPS
                                   ) -> torch.Tensor:
    """(B, N, pos_size) positional embeddings (see module docstring;
    positional.py:76-166). The subspace method works on ``m_shift``
    (Kernel 1's output) or derives it from ``adj``; the eigh method needs
    ``adj``. ``guards`` overrides the profile's guard count."""
    n_max = node_mask.shape[1]
    n_vec = min(pos_size, n_max)
    if method == "eigh":
        if adj is None:
            raise ValueError("the eigh PE method needs the adjacency")
        # Ascending eigenvalues: the last n_vec columns, largest first.
        _, vecs = torch.linalg.eigh(normalized_adjacency(adj, node_mask))
        top = vecs[:, :, n_max - n_vec:].flip(-1)
    elif method == "subspace":
        if m_shift is None:
            if adj is None:
                raise ValueError("the subspace PE method needs m_shift or "
                                 "the adjacency")
            m_shift = shifted_operator(normalized_adjacency(adj, node_mask),
                                       node_mask)
        top = subspace_topk(
            m_shift, node_mask, n_vec,
            guards=pe_guards(profile) if guards is None else guards,
            rr=rr, rr_sweeps=rr_sweeps)
    else:
        raise ValueError(f"unknown PE method: {method}")
    return canonical_pe(top, n_nodes, node_mask, pos_size)


def canonical_pe(top: torch.Tensor, n_nodes: torch.Tensor,
                 node_mask: torch.Tensor, pos_size: int, all_max=_same,
                 all_sum=_same) -> torch.Tensor:
    """The conventions every PE ends with, on (B, N, n_vec) eigenvectors
    in descending eigenvalue order: zero-padded to pos_size columns, the
    sign canonicalized, columns beyond k_b = min(n_b - 2, pos_size)
    zeroed, rows L2-normalized, padding rows zeroed (n_nodes: (B,)).

    The sign rule is the only reduction over rows: ``all_max`` and
    ``all_sum`` complete its column max and its column sum where the
    rows are spread over several ranks (the max before the comparison,
    so ties are those of the whole column); in one process they are the
    identity."""
    if top.shape[2] < pos_size:
        top = torch.nn.functional.pad(top, (0, pos_size - top.shape[2]))
    # Canonical sign: the entry of max |value| positive (ties of opposite
    # sign, or an all-zero column, keep +).
    absv = top.abs()
    mx = all_max(torch.amax(absv, dim=1, keepdim=True))
    ref = all_sum(torch.sum(torch.where(absv == mx, top,
                                        torch.zeros_like(top)),
                            dim=1, keepdim=True))
    top = top * torch.sign(torch.where(ref == 0, torch.ones_like(ref), ref))
    # Zero columns >= k_b = min(n_b - 2, pos_size).
    k_b = torch.clamp(n_nodes - 2, 0, pos_size)
    col = torch.arange(pos_size, device=top.device)
    top = top * (col[None, None, :] < k_b[:, None, None])
    # Row-L2 normalize (sklearn normalize semantics: zero rows -> zero).
    norm = torch.linalg.vector_norm(top, dim=-1, keepdim=True)
    top = top / torch.where(norm == 0, torch.ones_like(norm), norm)
    return top * node_mask[:, :, None]
