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
registers and no block-wide barrier in the round loop; n = 48 (the eval
profile's guarded finish at PE 32), 64 and 80 (PE 64's finish on the
train profile, and on the eval profile and the giant path) run the pair
kernel: one block per matrix, each thread mixing 1, 4 or 5 2×2 blocks of
A (576, 256 or 320 threads), one barrier a round, dynamic shared memory
above 48 KB; every other even n from 4 to 832 runs the cluster pair
kernel, the same design over a thread block cluster of C blocks per
matrix: block b holds the pairs of :func:`pair_ranges` (both rows of
each), the rows that cross a range's ends go to the neighbours' shared
memory, each warp reads its pairs' pivots from the blocks holding them,
one cluster barrier a round. C = 1 up
to n = 118; above, the least C ≤ 8 whose share fits a block, raised
while the batch's clusters fill one wave and the card holds them all
(:func:`cluster_held`); above n = 328 A and Vᵀ live in a per-matrix
device scratch that the wrapper allocates. The wrapper builds the
kernel's tables once per width and cluster (:func:`cluster_tables`).
All round every operation as the plain version does, in its order, so
all agree with it bit for bit.

``v_dtype`` (``EncoderConfig.jacobi_v_dtype``; the reference's
``GCC_TPU_JACOBI_V_DTYPE=bf16``, ``gcc_tpu/ops/jacobi.py:151-168``):
with bfloat16, each round rotates Vᵀ in f32 and rounds the result to
bf16 before it is stored; the output v is f32. A and the eigenvalues
never read Vᵀ, so they are bit for bit those of the f32 run. The three
kernels take it as a template flag and keep Vᵀ in f32 storage holding
the rounded values.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gcc_tpu_torch.ops import build as _build
from gcc_tpu_torch.ops.aggregate import storage_dtype


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
                      descending: bool = False, v_dtype=torch.float32):
    """Plain PyTorch version of Kernel 3 (the "lane" layout of
    ``gcc_tpu.ops.jacobi.jacobi_eigh``). a: (..., n, n) symmetric float32,
    n even. Returns (w, v): w (..., n) ascending (descending=True flips),
    v (..., n, n) with eigenvectors in columns. ``v_dtype`` bfloat16
    rounds Vᵀ to bf16 after every round's f32 rotation."""
    round_v = storage_dtype(v_dtype) == torch.bfloat16
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
        if round_v:
            vt = vt.to(torch.bfloat16).to(torch.float32)
        # re-pair for the next round: new[i] = old[pi[i]]
        a = a.index_select(-2, pi_t).index_select(-1, pi_t)
        vt = vt.index_select(-2, pi_t)
    # Undo the round-0 layout: eigenpair at position j is node lay[j].
    inv = torch.empty_like(lay)
    inv[lay] = torch.arange(n, device=a.device)
    w = torch.diagonal(a, dim1=-2, dim2=-1).index_select(-1, inv)
    v = vt.transpose(-1, -2).index_select(-1, inv)
    return sort_eig(w, v, descending)


_JACOBI_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_tables: dict = {}
_held: dict = {}


def _jacobi_lib() -> ctypes.CDLL:
    lib = _build.load("jacobi")
    lib.gcc_jacobi_launch.argtypes = _JACOBI_ARGS
    lib.gcc_jacobi_launch.restype = ctypes.c_int
    lib.gcc_jacobi_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int)]
    lib.gcc_jacobi_plan.restype = ctypes.c_int
    lib.gcc_jacobi_held.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.gcc_jacobi_held.restype = ctypes.c_int
    return lib


# Mirrors of the constants in csrc/jacobi.cu.
_WARP_N = 32            # the n the warp-per-matrix kernel takes
_WARPS_PER_BLOCK = 4
# The pair kernel's widths: items (2x2 blocks) per thread.
_PAIR_ITEMS = {48: 1, 64: 4, 80: 5}
_MAX_SMEM = 232_448     # shared memory a Hopper block may use
MAX_N = 832             # the widest n, the widest block of Kernel 2
# The cluster pair kernel: the portable cluster size, the items a thread
# its instances take in shared memory and in the device scratch, the SMs
# whose one wave batch x cluster fills (an H100's), the ints of the pair
# ranges.
MAX_CLUSTER = 8
CLUSTER_ITEMS = (6, 4, 3, 2)
DEVICE_ITEMS = 2        # the items a thread in the device scratch
_SMS = 132
_PAIR_RANGE_INTS = 16
# How many clusters of 1 to 8 blocks of the cluster pair kernel an NVIDIA
# H100 80GB HBM3 holds at once at one block an SM (cudaOccupancyMax-
# ActiveClusters there, by cluster_held): a GPC holds whole clusters only,
# so 15 of 8 blocks, not 16. The wrapper asks the card it runs on; this is
# the plan's default.
H100_CLUSTERS_HELD = (132, 66, 39, 30, 22, 17, 15, 15)
CLUSTER_VARIANT = "cluster pair kernel, one cluster barrier a round"


def cluster_ld(n: int, device: bool = False) -> int:
    """Row stride of the cluster pair kernel's buffers: in shared memory
    the least ≥ n that is 8 mod 16 floats (a warp's 4 rows × 8 columns on
    distinct banks); in the device scratch n rounded up to 128 bytes."""
    return -(-n // 32) * 32 if device else n + (24 - n % 16) % 16


def cluster_pairs(n: int, cluster: int) -> int:
    """Pairs the largest block of a cluster holds: ceil(h / cluster)."""
    return -(-(n // 2) // cluster)


def cluster_smem(n: int, cluster: int, device: bool) -> int:
    """Shared memory of a block of the cluster pair kernel: A, A′, Vᵀ and
    Vᵀ′ (2 M rows of LD floats each; when placed in the device scratch,
    a round's rotations, n floats, instead), the eigenvalues, four n-int
    tables, the pair ranges and the ranks."""
    buffers = (4 * n if device
               else 32 * cluster_pairs(n, cluster) * cluster_ld(n))
    return buffers + 24 * n + 4 * _PAIR_RANGE_INTS


def least_cluster(n: int) -> int:
    """The least cluster (≤ 8 blocks) whose share of A and Vᵀ fits a
    block's shared memory; 0 where none does (n > 328)."""
    return next((c for c in range(1, MAX_CLUSTER + 1)
                 if cluster_smem(n, c, False) <= _MAX_SMEM), 0)


def _cluster_max_warps(items: int) -> int:
    return 32 if items <= 3 else 16


def _cluster_patches(n: int, pairs: int, items: int,
                     device: bool = False) -> int:
    """A block's patches: 4·items of its pairs × 8 column pairs each in
    shared memory, items × 32 in the device scratch."""
    rows, cols = (items, 32) if device else (4 * items, 8)
    return -(-pairs // rows) * -(-(n // 2) // cols)


def cluster_items(n: int, pairs: int) -> int:
    """2×2 blocks a thread mixes per patch (6, 4, 3 or 2; a block has at
    most 16 warps of 4 or 6 items, 32 of 2 or 3), by a rule fitted to the
    timings of ``ops/jacobi_instances.py``: first a patch a warp and at
    least 16 warps, then the fewest patch rows past the block's pairs,
    then the most items; failing that, a patch a warp and the most warps;
    failing that, the fewest 2×2 blocks a thread mixes in a round."""
    def key(items):
        warps = _cluster_max_warps(items)
        patches = _cluster_patches(n, pairs, items)
        rows = -(-pairs // (4 * items)) * 4 * items
        if 16 <= patches <= warps:
            return (0, rows, -items)
        if patches <= warps:
            return (1, -patches, -items)
        return (2, -(-patches // warps) * items, -items)
    return min(CLUSTER_ITEMS, key=key)


def pair_ranges(n: int, cluster: int) -> list[tuple[int, int]]:
    """Block b of a cluster holds the pairs [start, stop) of entry b:
    contiguous, as even as they divide."""
    h = n // 2
    return [(b * h // cluster, (b + 1) * h // cluster)
            for b in range(cluster)]


def _cluster_plan(n: int, batch: int, held, cluster, items) -> dict:
    """The cluster pair kernel's plan, as ``cluster_plan`` in
    ``csrc/jacobi.cu`` computes it."""
    least = least_cluster(n)
    device = least == 0
    lo, hi = (1 if device else least), min(MAX_CLUSTER, n // 2)
    if cluster:
        if not lo <= cluster <= hi:
            raise ValueError(f"jacobi n={n} takes clusters of {lo} to {hi} "
                             f"blocks, got {cluster}")
        c = cluster
    elif least == 1:
        c = 1                    # a block holds the whole matrix
    else:
        # Raised while the batch's clusters fill at most one wave of the
        # SMs and the card holds them all at once.
        c = lo
        while c < hi and batch * (c + 1) <= _SMS and batch <= held[c]:
            c += 1
    pairs = cluster_pairs(n, c)
    if device:
        if items not in (0, DEVICE_ITEMS):
            raise ValueError(f"jacobi n={n} in the device scratch takes "
                             f"{DEVICE_ITEMS} items a thread, got {items}")
        items = DEVICE_ITEMS
    elif not items:
        items = cluster_items(n, pairs)
    elif items not in CLUSTER_ITEMS:
        raise ValueError(f"jacobi cluster kernel takes {CLUSTER_ITEMS} items "
                         f"a thread, got {items}")
    warps = min(_cluster_patches(n, pairs, items, device),
                _cluster_max_warps(items))
    return dict(variant=CLUSTER_VARIANT, blocks=batch * c, threads=32 * warps,
                smem_bytes=cluster_smem(n, c, device),
                scratch_bytes=16 * n * cluster_ld(n, True) if device else 0,
                cluster=c, items=items,
                placement="device" if device else "shared",
                least_cluster=lo, pair_ranges=pair_ranges(n, c))


def jacobi_launch_plan(n: int, batch: int = 1, held=H100_CLUSTERS_HELD,
                       cluster: int = 0, items: int = 0) -> dict:
    """Launch plan of Kernel 3 for (batch, n, n), as ``csrc/jacobi.cu``
    launches it: which kernel (``variant``), blocks, threads per block,
    bytes of shared memory per block and of device scratch per matrix,
    blocks per matrix (``cluster``), 2×2 blocks a thread (``items``) and
    where A and Vᵀ live (``placement``: "registers", "shared" or
    "device"). ``held[c - 1]`` is how many clusters of c blocks the card
    holds at once; ``cluster`` and ``items`` force the cluster pair
    kernel's choices (0: the plan's). Raises ``ValueError`` on what the
    kernels do not take."""
    if n % 2 or not 4 <= n <= MAX_N:
        raise ValueError(
            f"jacobi kernel takes even 4 <= n <= {MAX_N}, got n={n}")
    fixed = n == _WARP_N or n in _PAIR_ITEMS
    if fixed and (cluster or items):
        raise ValueError(f"jacobi n={n} runs a kernel of fixed shape")
    if n == _WARP_N:
        # lay[n] + per warp: slab n(n+1), eigenvalues n, ranks n
        smem = 4 * (n + _WARPS_PER_BLOCK * (n * (n + 1) + 2 * n))
        return dict(variant="warp-per-matrix, registers",
                    blocks=-(-batch // _WARPS_PER_BLOCK),
                    threads=32 * _WARPS_PER_BLOCK, smem_bytes=smem,
                    scratch_bytes=0, cluster=1, items=0,
                    placement="registers")
    if n in _PAIR_ITEMS:
        # A and V^T double-buffered with rows padded to n + 8, the
        # eigenvalues and three index tables.
        smem = 4 * (4 * n * (n + 8) + n) + 3 * 4 * n
        return dict(variant="thread-per-2x2-block, one barrier a round",
                    blocks=batch, threads=(n // 2) ** 2 // _PAIR_ITEMS[n],
                    smem_bytes=smem, scratch_bytes=0, cluster=1,
                    items=_PAIR_ITEMS[n], placement="shared")
    return _cluster_plan(n, batch, held, cluster, items)


def cluster_tables(n: int, cluster: int, placement: str) -> np.ndarray:
    """int32 tables of Kernel 3: ``layout0 | cdst`` (old position x moves
    to cdst[x] in the re-pair; the warp and pair kernels read these two),
    then for the cluster pair kernel ``rdst | home | pstart``: home[x] is
    ``block << 16 | buffer row`` of position x (placement "shared": block
    b's top rows, then its bottom rows, ceil(h / C) each; "device": row x
    of the matrix's scratch, block 0), rdst[x] = home[cdst[x]], and block b
    holds the pairs [pstart[b], pstart[b + 1])."""
    layout0, pi = unsorted_tournament(n)
    cdst = np.empty(n, np.int64)
    cdst[pi] = np.arange(n)
    h = n // 2
    ranges = pair_ranges(n, cluster)
    pstart = np.full(_PAIR_RANGE_INTS, h, np.int64)
    pstart[:cluster] = [start for start, _ in ranges]
    if placement == "device":
        home = np.arange(n, dtype=np.int64)
    else:
        rows = cluster_pairs(n, cluster)
        pair = np.arange(n) % h
        block = np.searchsorted(pstart[:cluster + 1], pair, side="right") - 1
        row = pair - pstart[block] + np.where(np.arange(n) >= h, rows, 0)
        home = block << 16 | row
    return np.concatenate([layout0, cdst, home[cdst], home, pstart]
                          ).astype(np.int32)


def _device_tables(n: int, plan: dict, device: torch.device) -> torch.Tensor:
    key = (n, plan["cluster"], plan["placement"], str(device))
    t = _tables.get(key)
    if t is None:
        t = torch.as_tensor(cluster_tables(n, plan["cluster"],
                                           plan["placement"]), device=device)
        _tables[key] = t
    return t


def cluster_held(device=None) -> tuple:
    """How many clusters of 1 to 8 blocks of the cluster pair kernel the
    card holds at once (``H100_CLUSTERS_HELD`` on an H100 80GB HBM3), asked
    once per device. Needs the card."""
    device = torch.device("cuda" if device is None else device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    held = _held.get(index)
    if held is None:
        out = (ctypes.c_int * MAX_CLUSTER)()
        with torch.cuda.device(index):
            _build.check(_jacobi_lib().gcc_jacobi_held(out), "jacobi held")
        held = _held[index] = tuple(out)
    return held


def _check_input(a: torch.Tensor) -> dict:
    """Raise on what the kernels do not take; the plan else."""
    if a.dtype != torch.float32:
        raise TypeError(f"jacobi_eigh takes float32, got {a.dtype}")
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"jacobi_eigh takes (B, n, n), got {tuple(a.shape)}")
    return jacobi_launch_plan(a.shape[1], a.shape[0])


def jacobi_eigh(a: torch.Tensor, sweeps: int = 5, eps: float = 1e-12,
                descending: bool = False, v_dtype=torch.float32):
    """Kernel 3 wrapper: batched symmetric eigendecomposition, sorted.
    a: (B, n, n) float32, n even ≤ 832 (32 on the train path, 48 for the
    eval profile's guarded finish; 64 and 80 with PE 64). CUDA tensors
    launch ``csrc/jacobi.cu`` (one launch counted: the warp-per-matrix
    kernel at n = 32, the thread-per-2x2-block kernel at n = 48, 64 and
    80, the cluster pair kernel at any other n, on the plan's cluster and
    items a thread); CPU tensors run :func:`jacobi_eigh_plain`.
    ``v_dtype``: float32 or bfloat16 (Vᵀ rounded each round)."""
    if a.device.type == "cpu":
        return jacobi_eigh_plain(a, sweeps, eps, descending, v_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    _check_input(a)
    return _launch(a, sweeps, eps, descending, v_dtype=v_dtype)


def _launch(a: torch.Tensor, sweeps: int, eps: float, descending: bool,
            cluster: int = 0, items: int = 0, v_dtype=torch.float32):
    """Launch ``csrc/jacobi.cu`` on the CUDA tensor a (B, n, n) float32,
    counted in ``jacobi_eigh.launches``. ``cluster`` and ``items`` force
    the cluster pair kernel's blocks per matrix and 2×2 blocks a thread
    (0: the plan's); the card tests and ``ops/jacobi_instances.py`` sweep
    them. ``v_dtype`` bfloat16 launches the kernels' bf16-V variants."""
    v_bf16 = storage_dtype(v_dtype) == torch.bfloat16
    b, n, _ = a.shape
    plan = jacobi_launch_plan(n, b, cluster_held(a.device), cluster, items)
    a = a.contiguous()
    w = torch.empty((b, n), dtype=torch.float32, device=a.device)
    v = torch.empty((b, n, n), dtype=torch.float32, device=a.device)
    scratch = torch.empty((b, plan["scratch_bytes"]), dtype=torch.uint8,
                          device=a.device)
    tables = _device_tables(n, plan, a.device)
    fixed = plan["variant"] != CLUSTER_VARIANT
    with torch.cuda.device(a.device):
        err = _jacobi_lib().gcc_jacobi_launch(
            a.data_ptr(), tables.data_ptr(), w.data_ptr(), v.data_ptr(),
            scratch.data_ptr() if scratch.numel() else None,
            b, n, sweeps, 1 if descending else 0, eps,
            0 if fixed else plan["cluster"], 0 if fixed else plan["items"],
            1 if v_bf16 else 0,
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "jacobi")
    jacobi_eigh.launches += 1
    return w, v


jacobi_eigh.launches = 0
