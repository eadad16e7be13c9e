"""Batched Jacobi eigendecomposition for small symmetric matrices —
Kernel 3, the Rayleigh-Ritz finisher of the positional embedding.

Counterpart of ``gcc_tpu/ops/jacobi.py`` (the algorithm, run by XLA in
production) and ``gcc_tpu/ops/jacobi_pallas.py`` (its Pallas kernel).
A parallel-order ("round-robin tournament") cyclic Jacobi sweeps all
n/2 disjoint pivot pairs per round; pivot pair j lives at positions
(j, j + n/2) — "half split" — and after each round one constant
permutation re-pairs the players (the UNSORTED circle method, see
:func:`unsorted_tournament`). ``sweeps`` full sweeps of n-1 rounds,
then the layout is undone and a comparison-rank sort orders the pairs.

:func:`jacobi_eigh` is the kernel's wrapper: a CUDA tensor launches
``csrc/jacobi.cu``; a CPU tensor runs :func:`jacobi_eigh_plain`, the
same rounds as plain PyTorch. The source holds three hand-written
kernels and the launch picks one by shape (:func:`jacobi_launch_plan`):
n = 32, the train path, runs one warp per matrix with A and Vᵀ in
registers and no block-wide barrier in the round loop; n = 48, the eval
profile's guarded finish, runs one block of 576 threads per matrix, one
thread per 2×2 block of A and one barrier a round; every other even n
from 4 to 118 runs one block of 256 threads per matrix over shared
memory with two barriers a round (dynamic shared memory above 48 KB, so
n = 64 and 80, the widths of PE 64 on the train and eval profiles, take
it too; n = 120 passes a block's 227 KB and raises). All round every
operation as the plain
version does, in its order, so all agree with it bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gcc_tpu_torch.ops import build as _build


def unsorted_tournament(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Round-robin schedule WITHOUT sorting pair members (circle method
    verbatim). In the half-split layout the round-to-round re-pairing is
    ONE CONSTANT position permutation pi, the sweep wrap is that same pi,
    and the layout returns to round-0 form every n-1 rounds. (Which
    member of a pair is "p" does not affect the rotation: swapping
    (p, q) negates tau and s, the same orthogonal transform.)

    Returns (layout0, pi): layout0 (n,) maps half-split position -> node
    index for round 0; next_layout[j] = layout[pi[j]]."""
    if n % 2 or n < 4:
        raise ValueError(f"jacobi_eigh needs an even n >= 4, got {n}")
    h = n // 2
    players = list(range(n))
    layouts = []
    for _ in range(n - 1):
        layouts.append([players[i] for i in range(h)]
                       + [players[n - 1 - i] for i in range(h)])
        players = [players[0]] + [players[-1]] + players[1:-1]
    pis = set()
    for r in range(n - 1):
        cur, nxt = layouts[r], layouts[(r + 1) % (n - 1)]
        inv = {v: k for k, v in enumerate(cur)}
        pis.add(tuple(inv[nxt[j]] for j in range(n)))
    assert len(pis) == 1
    pi = np.asarray(next(iter(pis)), np.int64)
    expect = np.asarray([0, h] + list(range(1, h - 1))
                        + list(range(h + 1, n)) + [h - 1], np.int64)
    assert np.array_equal(pi, expect), (pi, expect)
    return np.asarray(layouts[0], np.int64), pi


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root (via f64, exact for f32 inputs):
    torch's vectorized CPU sqrt may differ in the last bit, and the
    rotation chain carries such bits on; XLA and the CUDA kernel round
    correctly."""
    return torch.sqrt(x.double()).to(x.dtype)


def rotation_cs(app, aqq, apq, eps: float):
    """Two-sided Jacobi rotation coefficients zeroing A[p, q]
    (``gcc_tpu/ops/jacobi.py:91-109``): tau = (aqq - app) / (2 apq),
    t = sign(tau) / (|tau| + sqrt(1 + tau²)) (tau = 0 → t = 1),
    c = 1/sqrt(1 + t²), s = t c; |apq| ≤ eps·sqrt(|app aqq| + eps) →
    identity rotation."""
    small = apq.abs() <= eps * _sqrt_rn((app * aqq).abs() + eps)
    safe_apq = torch.where(small, torch.ones_like(apq), apq)
    tau = (aqq - app) / (2.0 * safe_apq)
    t = torch.sign(tau) / (tau.abs() + _sqrt_rn(1.0 + tau * tau))
    t = torch.where(tau == 0, torch.ones_like(t), t)
    c = 1.0 / _sqrt_rn(1.0 + t * t)
    s = t * c
    c = torch.where(small, torch.ones_like(c), c)
    s = torch.where(small, torch.zeros_like(s), s)
    return c, s


def sort_eig(w: torch.Tensor, v: torch.Tensor, descending: bool):
    """Comparison-rank eigenpair sort, ties broken by index
    (``gcc_tpu/ops/jacobi.py:339``): pair j goes to rank[j]."""
    n = w.shape[-1]
    wk = w[..., :, None]
    wj = w[..., None, :]
    idx = torch.arange(n, device=w.device)
    tie = (idx[:, None] < idx[None, :]) & (wk == wj)
    before = (wk > wj) if descending else (wk < wj)
    rank = (before | tie).sum(dim=-2)                     # (..., n)
    w_out = torch.empty_like(w).scatter_(-1, rank, w)
    v_out = torch.empty_like(v).scatter_(
        -1, rank[..., None, :].expand_as(v), v)
    return w_out, v_out


def jacobi_eigh_plain(a: torch.Tensor, sweeps: int = 5, eps: float = 1e-12,
                      descending: bool = False):
    """Plain PyTorch version of Kernel 3 (the "lane" layout of
    ``gcc_tpu.ops.jacobi.jacobi_eigh``). a: (..., n, n) symmetric float32,
    n even. Returns (w, v): w (..., n) ascending (descending=True flips),
    v (..., n, n) with eigenvectors in columns."""
    n = a.shape[-1]
    h = n // 2
    layout0, pi = unsorted_tournament(n)
    lay = torch.as_tensor(layout0, device=a.device)
    pi_t = torch.as_tensor(pi, device=a.device)
    a = a.index_select(-2, lay).index_select(-1, lay)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    vt = eye.index_select(0, lay).expand(a.shape).contiguous()
    j = torch.arange(h, device=a.device)
    for _ in range(sweeps * (n - 1)):
        ae, ao = a[..., :h, :], a[..., h:, :]
        app = ae[..., j, j]
        aqq = ao[..., j, j + h]
        apq = ae[..., j, j + h]
        c, s = rotation_cs(app, aqq, apq, eps)
        # rows: A <- R~ A, R~ = [[c, -s], [s, c]] per pair
        ce, se = c[..., :, None], s[..., :, None]
        a = torch.cat([ce * ae - se * ao, se * ae + ce * ao], dim=-2)
        # cols: A <- A R~^T (same coefficients on the column halves)
        al, ar = a[..., :, :h], a[..., :, h:]
        cc, sc = c[..., None, :], s[..., None, :]
        a = torch.cat([cc * al - sc * ar, sc * al + cc * ar], dim=-1)
        ve, vo = vt[..., :h, :], vt[..., h:, :]
        vt = torch.cat([ce * ve - se * vo, se * ve + ce * vo], dim=-2)
        # re-pair for the next round: new[i] = old[pi[i]]
        a = a.index_select(-2, pi_t).index_select(-1, pi_t)
        vt = vt.index_select(-2, pi_t)
    # Undo the round-0 layout: eigenpair at position j is node lay[j].
    inv = torch.empty_like(lay)
    inv[lay] = torch.arange(n, device=a.device)
    w = torch.diagonal(a, dim1=-2, dim2=-1).index_select(-1, inv)
    v = vt.transpose(-1, -2).index_select(-1, inv)
    return sort_eig(w, v, descending)


_JACOBI_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_void_p])
_tables: dict = {}


def _jacobi_lib() -> ctypes.CDLL:
    lib = _build.load("jacobi")
    lib.gcc_jacobi_launch.argtypes = _JACOBI_ARGS
    lib.gcc_jacobi_launch.restype = ctypes.c_int
    return lib


def _device_tables(n: int, device: torch.device) -> torch.Tensor:
    """int32 [layout0 | repair destination] for the kernel: old position
    x moves to pinv[x] in the re-pair."""
    key = (n, str(device))
    t = _tables.get(key)
    if t is None:
        layout0, pi = unsorted_tournament(n)
        pinv = np.empty(n, np.int64)
        pinv[pi] = np.arange(n)
        t = torch.as_tensor(np.concatenate([layout0, pinv]).astype(np.int32),
                            device=device)
        _tables[key] = t
    return t


# Mirrors of the constants in csrc/jacobi.cu.
_WARP_N = 32            # the n the warp-per-matrix kernel takes
_WARPS_PER_BLOCK = 4
_BLOCK_THREADS = 256
_PAIR_N = 48            # the n the thread-per-2x2-block kernel takes
_MAX_SMEM = 232_448     # shared memory a Hopper block may use
MAX_N = 118             # the widest even n whose block fits _MAX_SMEM


def jacobi_launch_plan(n: int, batch: int = 1) -> dict:
    """Launch plan of Kernel 3 for (batch, n, n), as ``csrc/jacobi.cu``
    launches it: which kernel, blocks, threads per block, bytes of shared
    memory per block. Raises ``ValueError`` on an n the kernels do not
    take."""
    if n % 2 or not 4 <= n <= MAX_N:
        raise ValueError(
            f"jacobi kernel takes even 4 <= n <= {MAX_N}, got n={n}"
            + (f" (its block would need {_block_smem(n)} B of shared "
               f"memory, limit {_MAX_SMEM})" if n > MAX_N else ""))
    if n == _WARP_N:
        # lay[n] + per warp: slab n(n+1), eigenvalues n, ranks n
        smem = 4 * (n + _WARPS_PER_BLOCK * (n * (n + 1) + 2 * n))
        return dict(variant="warp-per-matrix, registers",
                    blocks=-(-batch // _WARPS_PER_BLOCK),
                    threads=32 * _WARPS_PER_BLOCK, smem_bytes=smem)
    if n == _PAIR_N:
        # A and V^T double-buffered with rows padded to n + 8, the
        # eigenvalues and three index tables; static shared memory.
        smem = 4 * (4 * n * (n + 8) + n) + 3 * 4 * n
        return dict(variant="thread-per-2x2-block, one barrier a round",
                    blocks=batch, threads=(n // 2) ** 2, smem_bytes=smem)
    return dict(variant="block-per-matrix, shared memory", blocks=batch,
                threads=_BLOCK_THREADS, smem_bytes=_block_smem(n))


def _block_smem(n: int) -> int:
    """Shared memory of the block kernel: A and V^T double-buffered,
    c/s, eigenvalues, four index tables."""
    return 4 * (4 * n * n + 2 * n) + 4 * 4 * n


def _check_input(a: torch.Tensor) -> None:
    """Raise on what the kernels do not take."""
    if a.dtype != torch.float32:
        raise TypeError(f"jacobi_eigh takes float32, got {a.dtype}")
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"jacobi_eigh takes (B, n, n), got {tuple(a.shape)}")
    jacobi_launch_plan(a.shape[1], a.shape[0])


def jacobi_eigh(a: torch.Tensor, sweeps: int = 5, eps: float = 1e-12,
                descending: bool = False):
    """Kernel 3 wrapper: batched symmetric eigendecomposition, sorted.
    a: (B, n, n) float32, n even ≤ 118 (32 on the train path, 48 for the
    eval profile's guarded finish; 64 and 80 with PE 64). CUDA tensors launch ``csrc/jacobi.cu``
    (one launch counted: the warp-per-matrix kernel at n = 32, the
    thread-per-2x2-block kernel at n = 48, the block-per-matrix kernel at
    any other n); CPU tensors run
    :func:`jacobi_eigh_plain`."""
    if a.device.type == "cpu":
        return jacobi_eigh_plain(a, sweeps, eps, descending)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    _check_input(a)
    b, n, _ = a.shape
    a = a.contiguous()
    w = torch.empty((b, n), dtype=torch.float32, device=a.device)
    v = torch.empty((b, n, n), dtype=torch.float32, device=a.device)
    tables = _device_tables(n, a.device)
    lib = _jacobi_lib()
    with torch.cuda.device(a.device):
        err = lib.gcc_jacobi_launch(
            a.data_ptr(), tables.data_ptr(), w.data_ptr(), v.data_ptr(),
            b, n, sweeps, 1 if descending else 0, eps,
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "jacobi")
    jacobi_eigh.launches += 1
    return w, v


jacobi_eigh.launches = 0
