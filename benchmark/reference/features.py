"""Plain featurization: adjacency, degrees, masks and the Laplacian PE.

Each graph is a dense (N, N) adjacency A[dst, src] of edge
multiplicities over its first n real nodes. The PE is the GCC recipe
(the leading eigenvectors of M = D^-1/2 A D^-1/2, descending, signs
canonicalized, columns beyond min(n - 2, pos) zeroed, rows L2-normalized)
computed the way the program documents its subspace method: block
subspace iteration on m_shift = M + I from a fixed start (numpy
``default_rng(2)`` normals), four rounds of four power steps with
bf16-rounded operands and float32 sums, each round closed by a
Gershgorin-scaled Newton-Schulz orthonormalization, two float32 polish
steps, an eight-step float32 Newton-Schulz finish, then Rayleigh-Ritz
with a 3-sweep parallel-order Jacobi; the eval profile iterates 16 guard
columns more and whitens the guarded basis by a generalized
Rayleigh-Ritz before the rotation. The bf16 roundings are part of the
method; every other product follows ``prec`` (precision.py).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.precision import bf16_round, bmm

PAD_EIGENVALUE = -2.0
PE_ITERS, PE_ORTH_EVERY, NS_STEPS, POLISH, FINAL_NS = 16, 4, 4, 2, 8
RR_SWEEPS = 3
GUARDS = {"train": 0, "eval": 16}


# -- operator ----------------------------------------------------------

def degrees(adj: torch.Tensor) -> torch.Tensor:
    """In-degree with multiplicity: the row sums of A[dst, src]."""
    return adj.sum(dim=2)


def shifted_operator(adj: torch.Tensor, node_mask: torch.Tensor):
    """m_shift = D^-1/2 A D^-1/2 + I on real rows, 0 on the padding
    diagonal (degrees clipped at 1)."""
    inv = torch.rsqrt(torch.clamp_min(degrees(adj), 1.0))
    m = adj * inv[:, :, None] * inv[:, None, :]
    eye = torch.eye(adj.shape[1], device=adj.device)
    pad = 1.0 - node_mask
    m = m + (pad * PAD_EIGENVALUE)[:, :, None] * eye
    return m + pad[:, :, None] * eye + eye


# -- the subspace PE ---------------------------------------------------

def _colunit(qt):
    norm = torch.sqrt(torch.sum(qt * qt, dim=2, keepdim=True))
    return qt / torch.clamp_min(norm, 1e-20)


def _ns_orth(qt, steps: int, rnd, prec: str):
    """Newton-Schulz on Qᵀ after scaling σ_max below 1 by the Gershgorin
    bound of the Gram matrix; ``rnd`` rounds the operands (bf16 in the
    rounds, none in the finish)."""
    qt = _colunit(qt)
    gram = bmm(rnd(qt), rnd(qt).transpose(1, 2), prec)
    bound = torch.amax(torch.sum(gram.abs(), dim=2), dim=1)
    scale = torch.rsqrt(torch.clamp_min(bound, 1e-20))
    qt = qt * scale[:, None, None]
    gram = gram * (scale * scale)[:, None, None]
    for i in range(steps):
        if i:
            gram = bmm(rnd(qt), rnd(qt).transpose(1, 2), prec)
        qt = 1.5 * qt - 0.5 * bmm(rnd(gram), rnd(qt), prec)
    return qt


def subspace_iterate(m: torch.Tensor, q0: torch.Tensor, prec: str):
    """(B, N, k) near-orthonormal basis after the schedule above."""
    m_lo = bf16_round(m)
    qt = q0.transpose(1, 2)
    same = lambda x: x  # noqa: E731
    for _ in range(PE_ITERS // PE_ORTH_EVERY):
        for _ in range(PE_ORTH_EVERY):
            qt = torch.bmm(bf16_round(qt), m_lo)
        qt = _ns_orth(qt, NS_STEPS, bf16_round, prec)
    for _ in range(POLISH):
        qt = _colunit(bmm(qt, m, prec))
    qt = _ns_orth(qt, FINAL_NS, same, prec)
    return qt.transpose(1, 2)


def start_basis(n: int, k: int, node_mask: torch.Tensor) -> torch.Tensor:
    q0 = torch.as_tensor(
        np.random.default_rng(2).standard_normal((n, k)).astype(np.float32),
        device=node_mask.device)
    q = q0[None] * node_mask[:, :, None]
    norm = torch.linalg.vector_norm(q, dim=1, keepdim=True)
    return q / torch.clamp_min(norm, 1e-20)


# -- Jacobi ------------------------------------------------------------

def _tournament(n: int):
    """Round 0's half-split layout and the constant re-pairing of the
    circle method (players not sorted within a pair)."""
    h = n // 2
    players = list(range(n))
    layout0 = [players[i] for i in range(h)] + \
        [players[n - 1 - i] for i in range(h)]
    pi = [0, h] + list(range(1, h - 1)) + list(range(h + 1, n)) + [h - 1]
    return np.asarray(layout0, np.int64), np.asarray(pi, np.int64)


def _sqrt_rn(x):
    return torch.sqrt(x.double()).to(x.dtype)


def _rotation(app, aqq, apq, eps: float):
    small = apq.abs() <= eps * _sqrt_rn((app * aqq).abs() + eps)
    safe = torch.where(small, torch.ones_like(apq), apq)
    tau = (aqq - app) / (2.0 * safe)
    t = torch.sign(tau) / (tau.abs() + _sqrt_rn(1.0 + tau * tau))
    t = torch.where(tau == 0, torch.ones_like(t), t)
    c = 1.0 / _sqrt_rn(1.0 + t * t)
    s = t * c
    return (torch.where(small, torch.ones_like(c), c),
            torch.where(small, torch.zeros_like(s), s))


def jacobi_eigh(a: torch.Tensor, sweeps: int = RR_SWEEPS,
                eps: float = 1e-12):
    """Eigenpairs of symmetric (B, n, n), n even, by parallel-order cyclic
    Jacobi: (w, v) in descending order, eigenvectors in columns."""
    n = a.shape[-1]
    h = n // 2
    layout0, pi = _tournament(n)
    lay = torch.as_tensor(layout0, device=a.device)
    pi_t = torch.as_tensor(pi, device=a.device)
    a = a.index_select(-2, lay).index_select(-1, lay)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    vt = eye.index_select(0, lay).expand(a.shape).contiguous()
    j = torch.arange(h, device=a.device)
    for _ in range(sweeps * (n - 1)):
        ae, ao = a[..., :h, :], a[..., h:, :]
        c, s = _rotation(ae[..., j, j], ao[..., j, j + h], ae[..., j, j + h],
                         eps)
        ce, se = c[..., :, None], s[..., :, None]
        a = torch.cat([ce * ae - se * ao, se * ae + ce * ao], dim=-2)
        al, ar = a[..., :, :h], a[..., :, h:]
        cc, sc = c[..., None, :], s[..., None, :]
        a = torch.cat([cc * al - sc * ar, sc * al + cc * ar], dim=-1)
        ve, vo = vt[..., :h, :], vt[..., h:, :]
        vt = torch.cat([ce * ve - se * vo, se * ve + ce * vo], dim=-2)
        a = a.index_select(-2, pi_t).index_select(-1, pi_t)
        vt = vt.index_select(-2, pi_t)
    inv = torch.empty_like(lay)
    inv[lay] = torch.arange(n, device=a.device)
    w = torch.diagonal(a, dim1=-2, dim2=-1).index_select(-1, inv)
    v = vt.transpose(-1, -2).index_select(-1, inv)
    # Descending by comparison rank, ties by index.
    idx = torch.arange(n, device=w.device)
    wk, wj = w[..., :, None], w[..., None, :]
    tie = (idx[:, None] < idx[None, :]) & (wk == wj)
    rank = ((wk > wj) | tie).sum(dim=-2)
    w_out = torch.empty_like(w).scatter_(-1, rank, w)
    v_out = torch.empty_like(v).scatter_(-1, rank[..., None, :].expand_as(v),
                                         v)
    return w_out, v_out


def _small_eigh(a):
    if a.shape[-1] % 2 == 0:
        return jacobi_eigh(a)
    w, v = torch.linalg.eigh(a)
    return w.flip(-1), v.flip(-1)


def _whiten(q, prec: str, jitter: float = 1e-5):
    """Generalized Rayleigh-Ritz whitening of a guarded basis: directions
    whose Gram eigenvalue is under a tenth of the largest are dropped."""
    s = bmm(q.transpose(1, 2), q, prec)
    s = 0.5 * (s + s.transpose(1, 2))
    s = s + jitter * torch.eye(q.shape[2], device=q.device)
    sv, v = _small_eigh(s)
    floor = 0.1 * sv[:, :1]
    keep = (sv > floor).to(q.dtype)
    w = v * (torch.rsqrt(torch.maximum(sv, floor)) * keep)[:, None, :]
    return bmm(q, w, prec)


def positional_embedding(adj: torch.Tensor, node_mask: torch.Tensor,
                         n_nodes: torch.Tensor, pos_size: int,
                         profile: str, prec: str = "f32") -> torch.Tensor:
    """(B, N, pos_size) PE of the subspace method (module docstring)."""
    n = node_mask.shape[1]
    k_keep = min(pos_size, n)
    k = min(n, k_keep + GUARDS[profile])
    k = max(k - (k % 2), k_keep)
    m = shifted_operator(adj, node_mask)
    q = torch.nan_to_num(subspace_iterate(m, start_basis(n, k, node_mask),
                                          prec), nan=0.0, posinf=0.0,
                         neginf=0.0)
    if k > k_keep:
        q = _whiten(q, prec)
    t = bmm(q.transpose(1, 2), bmm(m, q, prec), prec)
    t = 0.5 * (t + t.transpose(1, 2))
    _, u = _small_eigh(t)
    top = bmm(q, u[:, :, :k_keep], prec)
    return canonical(top, n_nodes, node_mask, pos_size)


def canonical(top, n_nodes, node_mask, pos_size: int):
    """Sign (largest |entry| positive), columns >= min(n - 2, pos) zeroed,
    rows L2-normalized, padding rows zeroed."""
    if top.shape[2] < pos_size:
        top = torch.nn.functional.pad(top, (0, pos_size - top.shape[2]))
    absv = top.abs()
    mx = torch.amax(absv, dim=1, keepdim=True)
    ref = torch.sum(torch.where(absv == mx, top, torch.zeros_like(top)),
                    dim=1, keepdim=True)
    top = top * torch.sign(torch.where(ref == 0, torch.ones_like(ref), ref))
    k_b = torch.clamp(n_nodes - 2, 0, pos_size)
    col = torch.arange(pos_size, device=top.device)
    top = top * (col[None, None, :] < k_b[:, None, None])
    norm = torch.linalg.vector_norm(top, dim=-1, keepdim=True)
    top = top / torch.where(norm == 0, torch.ones_like(norm), norm)
    return top * node_mask[:, :, None]


def pe_gaps(pos_a: torch.Tensor, pos_b: torch.Tensor,
            node_mask: torch.Tensor, n_nodes: torch.Tensor,
            block: int = 256) -> torch.Tensor:
    """Per graph, the mean |difference| of the row cosines pos·posᵀ over
    the graph's real node pairs (float64, on the host). The row cosines
    do not move when the columns rotate among themselves, as eigenvectors
    of one eigenvalue may."""
    out = []
    for lo in range(0, pos_a.shape[0], block):
        a, b = pos_a[lo:lo + block], pos_b[lo:lo + block]
        m = node_mask[lo:lo + block]
        d = (torch.bmm(a, a.transpose(1, 2))
             - torch.bmm(b, b.transpose(1, 2))).abs()
        pair = m[:, :, None] * m[:, None, :]
        per = (d * pair).sum(dim=(1, 2)) / torch.clamp_min(
            pair.sum(dim=(1, 2)), 1.0)
        out.append(per.double().cpu())
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.float64)
