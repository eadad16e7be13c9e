"""Block subspace iteration for the positional embedding — Kernel 2.

Counterpart of ``gcc_tpu/ops/pe_pallas.py`` ``pe_subspace_iterate``:
from a column-normalized start q0 (B, N, k), iterate on the basis
stored transposed as Qᵀ (k, N) — rounds of power steps with bf16 inputs
and f32 sums, each round closed by a Gershgorin-scaled Newton–Schulz
orthonormalization, then f32 polish power steps and an f32 Newton–Schulz
finish — and return a near-orthonormal (B, N, k) basis. No gradient:
the positional embedding is a stop-gradient input feature.

:func:`pe_subspace_iterate` is the kernel's wrapper: a CUDA tensor
launches ``csrc/pe.cu``; a CPU tensor runs
:func:`pe_subspace_iterate_plain`, the same steps as plain PyTorch.

The kernel runs the bf16-input products (power steps, the rounds' Gram
and G·Qᵀ) on the tensor cores and the f32 work on the CUDA cores;
:func:`pe_launch_plan` mirrors its launch plan. M is read as the
reference reads it, out[r, c] = Σ_j Qᵀ[r, j]·M[j, c]: ``m_shift`` is
symmetric as a matrix but not bit for bit (it is formed as
``(a·inv_row)·inv_col``), so neither version may read M[c, j] in place of
M[j, c]. N is padded to a multiple of 32 (at most 832, the largest
multiple of 32 with N·N·6 ≤ 4 MiB), k to a multiple of 16 inside the
kernel. The plans by width:

* k ≤ 48: "shared" for N ≤ 256, one block of 2N threads per graph, M's
  bf16 copy in shared memory; "streamed" above, a thread block cluster
  per graph (2 blocks up to N = 512, 4 above; 512 threads a block) whose
  blocks split the live columns of Qᵀ in slabs of 16, one warp a slab.
  The kernel makes a bf16 copy of M once, in 16×16 tiles, in a device
  scratch that the wrapper allocates, and every warp streams its own
  tiles of it through a private ``cp.async`` ring for each power step;
  Qᵀ stays on the chip, in registers and in a copy in every block's
  shared memory that the blocks update through distributed shared
  memory;
* 48 < k ≤ 80 (PE 64: k = 64 on the train profile, 80 with the eval
  profile's 16 guards): "wide", the same two layouts at five row tiles —
  the shared layout where its bytes fit a block (N ≤ 224 at kp = 64,
  N ≤ 160 at kp = 80), the cluster layout above (one block per graph up
  to N = 256, so a batch of 4096 graphs takes one SM a graph); where the
  cluster's two
  bf16 copies of Qᵀ do not fit beside the rest (kp = 80 above N = 384,
  kp = 64 above N = 512) a block keeps one, written behind a barrier,
  and the f32 Qᵀ of the polish and the finish moves to the scratch;
* 80 < k ≤ 832: "general", reached by no configuration the repository
  ships: a thread block cluster per graph sized by the batch (the most
  blocks, up to 8, whose batch × cluster fills one wave of 132 SMs and
  whose clusters the card holds at once: 6 at a batch of 16, 2 at 64, 1
  at 128), 512 threads a block; every step one GEMM whose 128 × 64
  output tiles are dealt to the cluster's blocks, operands streamed by
  ``cp.async`` from a device scratch that stays in L2 — bf16 copies of
  M and Q (Q double-buffered) for the rounds, on the tensor cores with
  the A operand split; f32 copies of Q and G for the polish and finish,
  register-tiled on the CUDA cores. The Gram is formed on its upper
  triangle and mirrored, so it is symmetric bit for bit.

Larger N or k raises.

M may be float32 or bfloat16 (the reference's ``GCC_TPU_ADJ_DTYPE=bf16``
stores the operator in bf16, ``gcc_tpu/ops/pe_pallas.py:49``). A bf16 M
is its own bf16 copy: the rounds take it as it is, and the f32 polish and
finish widen it as they read it, so the result is that of the f32 M that
holds the same values. Every plan reads a bf16 M as it reads an f32 one,
at half the bytes: the copy into the rounds' bf16 tiles converts nothing,
and the f32 panels of the polish widen each value as it lands.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gcc_tpu_torch.ops import build as _build

# Shared memory a block may use on Hopper (227 KB).
_MAX_SMEM = 232_448
# Largest node count the kernel takes: the largest multiple of 32 with
# N·N·6 <= 4 MiB, the bound under which the reference sends a bucket to
# its fused kernel (positional.py:257-274).
MAX_NODES = 832
# Widest block the kernel takes, and the widest its tensor-core plans
# take (five row tiles: PE 64 plus the eval profile's 16 guards).
MAX_WIDTH = 832
_TC_MAX_WIDTH = 80
# The general plan: threads a block, most blocks a graph (the portable
# cluster size), the SMs whose one wave batch x cluster fills (an H100's),
# output tile, depth of a bf16 and of an f32 slice, stages of the ring,
# rows of a partial sum of squares.
_GEN_THREADS = 512
_GEN_MAX_CLUSTER = 8
_SMS = 132
_GEN_BM, _GEN_BN, _GEN_BK_LO, _GEN_BK_F = 128, 64, 64, 32
_GEN_STAGES, _GEN_CHUNK = 4, 128
# How many clusters of 1 to 8 blocks of the general plan's kernel an NVIDIA
# H100 80GB HBM3 holds at once (cudaOccupancyMaxActiveClusters there, by
# general_clusters): a GPC holds whole clusters only, so 15 of 8 blocks,
# not 16. The kernel asks the card it runs on; this is the plan's default.
H100_CLUSTERS_HELD = (132, 66, 39, 30, 22, 17, 15, 15)


def _gen_stage_bytes() -> int:
    """Bytes of one slice of the general plan's ring, as ``kGenStage`` in
    ``csrc/pe.cu``: the larger of a bf16 slice (A depth- or row-major,
    rows padded by 8 values, then B) and an f32 one (padded by 4)."""
    bm, bn, lo, f = _GEN_BM, _GEN_BN, _GEN_BK_LO, _GEN_BK_F
    bf16 = 2 * max(bm * (lo + 8), lo * (bm + 8)) + 2 * lo * (bn + 8)
    f32 = 4 * max(bm * (f + 4), f * (bm + 4)) + 4 * f * (bn + 4)
    return max(bf16, f32)


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back: a product of two rounded values is exact
    in f32, so f32 matmuls of rounded operands are bf16-input/f32-sum
    products."""
    return x.to(torch.bfloat16).to(torch.float32)


def pe_subspace_iterate_plain(m: torch.Tensor, q0: torch.Tensor,
                              iters: int = 24, orth_every: int = 4,
                              ns_steps: int = 4, power_lo: bool = True,
                              polish: int = 2, final_ns: int = 8
                              ) -> torch.Tensor:
    """Plain PyTorch version of Kernel 2. m (B, N, N) float32 or bfloat16
    (widened: the values are what count), q0 (B, N, k) → (B, N, k).
    ``power_lo`` selects bf16 inputs for the round products (the
    production setting); polish and the final NS are f32."""
    rounds = max(1, iters // orth_every)
    ident = lambda x: x  # noqa: E731
    lo = _bf16_round if power_lo else ident
    m = m.to(torch.float32)
    m_lo = lo(m)
    qt = q0.to(torch.float32).transpose(1, 2)          # (B, k, N)

    def colunit(qt):
        norm = torch.sqrt(torch.sum(qt * qt, dim=2, keepdim=True))
        return qt / torch.clamp_min(norm, 1e-20)

    def ns_orth(qt, steps: int, rnd):
        # Q ← (3Q − Q QᵀQ)/2 on Qᵀ, after scaling σ_max just below 1 by
        # the Gershgorin bound σ_max² ≤ ‖QᵀQ‖_∞ (pe_pallas.py:78-101).
        qt = colunit(qt)
        gram = torch.bmm(rnd(qt), rnd(qt).transpose(1, 2))
        bound = torch.amax(torch.sum(gram.abs(), dim=2), dim=1)
        scale = torch.rsqrt(torch.clamp_min(bound, 1e-20))
        qt = qt * scale[:, None, None]
        gram = gram * (scale * scale)[:, None, None]
        for i in range(steps):
            if i:
                gram = torch.bmm(rnd(qt), rnd(qt).transpose(1, 2))
            qt = 1.5 * qt - 0.5 * torch.bmm(rnd(gram), rnd(qt))
        return qt

    for _ in range(rounds):
        for _ in range(orth_every):
            qt = torch.bmm(lo(qt), m_lo)
        qt = ns_orth(qt, ns_steps, lo)
    for _ in range(polish):
        qt = colunit(torch.bmm(qt, m))
    if final_ns:
        qt = ns_orth(qt, final_ns, ident)
    return qt.transpose(1, 2)


_CLUSTER_MAX = 4        # blocks per graph the streamed plan uses at most
_RING_BYTES = 16 * 4 * 512   # 16 warps x 4 stages x one 16x16 bf16 tile


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def _cluster_smem(n_pad: int, kp: int, spb: int, nbuf: int) -> int:
    """Shared memory of the cluster layout, as ``big_smem`` in
    ``csrc/pe.cu`` computes it."""
    kk = kp * kp
    # nbuf bf16 copies of Q^T (rows padded by 8); with two, the f32 steps
    # keep one f32 copy of Q^T in the same bytes.
    smem = _align16(nbuf * kp * (n_pad + 8) * 2)
    # The warps' rings of M tiles, the f32 power steps' three panels of 16
    # rows of f32 M, or the two partial Grams; then G, its bf16 copy, the
    # sums of squares per warp and per block, the row norms, two scalars
    # and the blocks' extents.
    smem += max(_RING_BYTES, 3 * 16 * 16 * spb * 4, 2 * kk * 4)
    smem += kk * 4 + _align16(kp * (kp + 8) * 2)
    smem += 16 * kp * 4 + _CLUSTER_MAX * kp * 4 + kp * 4 + 16 + _CLUSTER_MAX * 4
    return smem


def _cluster_plan(n_pad: int, kp: int, name: str) -> dict:
    """The cluster layout (the streamed plan, k <= 48 and N > 256; the
    wide plan where its shared layout does not fit), as ``pe_big_plan``
    in ``csrc/pe.cu`` computes it: a cluster of blocks per graph that
    split the columns of Qᵀ in slabs of 16."""
    cluster = 1 if n_pad <= 256 else 2 if n_pad <= 512 else _CLUSTER_MAX
    slabs = n_pad // 16
    spb = -(-slabs // cluster)
    # Static split of all slabs; the kernel deals out the live ones the
    # same way (ceil(live / cluster) a block, the last blocks fewer).
    block_slabs = [max(0, min(spb, slabs - r * spb)) for r in range(cluster)]
    nbuf = 2
    smem = _cluster_smem(n_pad, kp, spb, nbuf)
    if smem > _MAX_SMEM:
        nbuf = 1
        smem = _cluster_smem(n_pad, kp, spb, nbuf)
    if smem > _MAX_SMEM or spb > 16:
        raise ValueError(
            f"pe kernel: N={n_pad}, kp={kp} needs {smem} B of shared memory "
            f"and {spb} warps per block (limits {_MAX_SMEM}, 16)")
    qf = "f32 Q^T in device memory" if nbuf == 1 else "f32 Q^T on the chip"
    return dict(n_pad=n_pad, kp=kp, threads=512, warps=16,
                smem_bytes=smem, gram_split=1, gram_f32_split=1,
                plan=name, layout="cluster", cluster=cluster,
                slabs_per_block=spb, block_slabs=block_slabs, qt_copies=nbuf,
                scratch_bytes=n_pad * n_pad * 2
                + (kp * (n_pad + 4) * 4 if nbuf == 1 else 0),
                variant=f"cluster of {cluster} blocks per graph; mma.sync "
                        f"m16n8k16 bf16 on a bf16 copy of M streamed by "
                        f"cp.async, {kp // 16} row tile(s) x 16 columns per "
                        f"warp, {nbuf} bf16 cop{'ies' if nbuf > 1 else 'y'} "
                        f"of Q^T a block; f32 4x{kp // 8} register tiles, "
                        f"{qf}")


def _general_cluster(batch: int, held=H100_CLUSTERS_HELD) -> int:
    """Blocks per graph of the general plan, 1 to 8: the most whose batch
    × cluster blocks fit one wave of the SMs and whose ``batch`` clusters
    the card holds at once (``held[c - 1]`` clusters of c blocks)."""
    return max(c for c in range(1, _GEN_MAX_CLUSTER + 1)
               if c == 1 or (batch * c <= _SMS and batch <= held[c - 1]))


def _general_plan(n_pad: int, kp: int, batch: int, held) -> dict:
    """The general plan (80 < k <= 832, any N <= 832), as
    ``pe_general_plan`` in ``csrc/pe.cu`` computes it. ``slabs_per_block``
    and ``block_slabs`` count its 128 × 64 tiles of a power step when all
    N nodes are live."""
    cluster = _general_cluster(batch, held)
    tiles = -(-n_pad // _GEN_BM) * -(-kp // _GEN_BN)
    stages = _GEN_STAGES * _gen_stage_bytes()
    mlo, qf, ql = n_pad * n_pad * 2, n_pad * kp * 4, n_pad * kp * 2
    gf, gl = kp * kp * 4, kp * kp * 2
    part = -(-n_pad // _GEN_CHUNK) * kp * 8
    return dict(n_pad=n_pad, kp=kp, threads=_GEN_THREADS,
                warps=_GEN_THREADS // 32,
                # the ring, the row norms, per-warp partials and scalars
                smem_bytes=stages + kp * 4 + 256,
                gram_split=1, gram_f32_split=1, plan="general",
                layout="device", cluster=cluster,
                slabs_per_block=-(-tiles // cluster),
                block_slabs=[len(range(r, tiles, cluster))
                             for r in range(cluster)],
                qt_copies=0,
                # bf16 M, f32 Q x 2, bf16 Q x 2, f32 G x 2, bf16 G, the
                # partial sums of squares, the blocks' extents
                scratch_bytes=mlo + 2 * qf + 2 * ql + 2 * gf + gl
                + -(-part // 256) * 256 + 256,
                variant=f"cluster of {cluster} block(s) of {_GEN_THREADS} per "
                        f"graph; 128x64 tiles dealt to the blocks, mma.sync "
                        f"m16n8k16 bf16 (A split) over bf16 M ({mlo} B) and "
                        f"bf16 Q (2 x {ql} B), f32 4x4 register tiles over "
                        f"f32 M and Q (2 x {qf} B), G (2 x {gf} B f32, "
                        f"{gl} B bf16), all in the device scratch, streamed "
                        f"through {stages} B of shared memory")


def _shared_plan(n_pad: int, kp: int, name: str) -> dict | None:
    """The shared layout (N <= 256), as ``pe_plan`` in ``csrc/pe.cu``
    computes it; None where its bytes pass a block's shared memory."""
    kt = kp // 16
    threads, warps = 2 * n_pad, n_pad // 16
    ldm = ldq = n_pad + 8
    ldg, ldt = kp + 8, n_pad + 4
    ks = max(d for d in range(1, 9)
             if d == 1 or (warps % d == 0 and 2 * kt * kt * d <= warps))
    tiles4 = (kp // 4) * (kp // 4 + 1) // 2      # upper triangle of 4x4s
    chunks = max(d for d in (1, 2, 4) if d == 1 or tiles4 * d <= threads)

    align16 = _align16
    kk = kp * kp
    smem = align16(max(n_pad * ldm * 2, 2 * kp * ldt * 4))
    smem += kk * 4 + warps * kp * 4 + kp * 4 + 16
    # The rounds' bf16 tiles and the f32 steps' three 16-row panels of M
    # share one region.
    smem += max(align16(2 * kp * ldq * 2) + align16(kp * ldg * 2)
                + (ks * kk * 4 if ks > 1 else 0), 3 * 16 * n_pad * 4)
    if smem > _MAX_SMEM:
        return None
    return dict(n_pad=n_pad, kp=kp, threads=threads, warps=warps,
                smem_bytes=smem, gram_split=ks, gram_f32_split=chunks,
                plan=name, layout="shared", cluster=1, slabs_per_block=warps,
                block_slabs=[warps], qt_copies=2, scratch_bytes=0,
                variant=f"mma.sync m16n8k16 bf16, {kt} row tile(s) x 16 "
                        f"columns per warp; f32 4x{2 * kt} register tiles")


def pe_launch_plan(n: int, k: int, batch: int = 1,
                   held=H100_CLUSTERS_HELD) -> dict:
    """Launch plan of Kernel 2 for N = ``n`` nodes (before padding), width
    ``k`` and ``batch`` graphs, as ``gcc_pe_plan`` in ``csrc/pe.cu``
    computes it (the batch, and ``held``, the clusters of 1 to 8 blocks the
    card holds at once, size the general plan's cluster only): the plan
    by width (``plan``: "shared" or "streamed" for k <= 48, "wide" for
    48 < k <= 80, "general" above) and its ``layout`` ("shared": M's bf16
    copy in shared memory; "cluster": a cluster of blocks per graph, M's
    bf16 copy in a device scratch; "device": Q in a device scratch),
    threads per block, bytes of dynamic shared memory, the padded sizes,
    the splits of the two Gram products, the tile variant, the blocks per
    graph (``cluster``), the slabs of 16 columns each block takes when all
    N nodes are live (``block_slabs``), the bf16 copies of Qᵀ a block
    keeps (``qt_copies``) and the bytes of device scratch per graph.
    Raises ``ValueError`` with the numbers on a shape the kernel does not
    take."""
    n_pad = -(-n // 32) * 32
    if not 1 <= n_pad <= MAX_NODES or not 1 <= k <= MAX_WIDTH:
        raise ValueError(f"pe kernel takes 1 <= N <= {MAX_NODES} and "
                         f"1 <= k <= {MAX_WIDTH}, got N={n}, k={k}")
    kp = -(-k // 16) * 16
    if k > _TC_MAX_WIDTH:
        return _general_plan(n_pad, kp, batch, held)
    name = "wide" if k > 48 else None
    if n_pad <= 256:
        plan = _shared_plan(n_pad, kp, name or "shared")
        if plan is not None:
            return plan
    return _cluster_plan(n_pad, kp, name or "streamed")


_PE_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p])


def _pe_lib() -> ctypes.CDLL:
    lib = _build.load("pe")
    lib.gcc_pe_launch.argtypes = _PE_ARGS
    lib.gcc_pe_launch.restype = ctypes.c_int
    lib.gcc_pe_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int)]
    lib.gcc_pe_plan.restype = ctypes.c_int
    return lib


def general_clusters(cluster: int) -> int:
    """How many clusters of ``cluster`` blocks of the general plan's
    kernel the card holds at once (what the kernel sizes its cluster by;
    ``H100_CLUSTERS_HELD`` for an H100 80GB HBM3). Needs the card."""
    lib = _pe_lib()
    lib.gcc_pe_general_clusters.argtypes = [ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int)]
    count = ctypes.c_int(0)
    _build.check(lib.gcc_pe_general_clusters(cluster, ctypes.byref(count)),
                 "pe general_clusters")
    return count.value


def _check_inputs(m, q0, orth_every, ns_steps, polish, final_ns) -> dict:
    """Raise on what the kernel does not take; the launch plan else."""
    if m.dtype not in (torch.float32, torch.bfloat16) \
            or q0.dtype != torch.float32:
        raise TypeError(f"pe_subspace_iterate takes float32 or bfloat16 m "
                        f"and float32 q0, got {m.dtype} and {q0.dtype}")
    if q0.dim() != 3 or m.dim() != 3:
        raise ValueError(f"pe_subspace_iterate takes m (B, N, N) and q0 "
                         f"(B, N, k), got {tuple(m.shape)}, {tuple(q0.shape)}")
    b, n, k = q0.shape
    if m.shape != (b, n, n) or q0.device != m.device:
        raise ValueError(f"shape/device mismatch: m {tuple(m.shape)}, "
                         f"q0 {tuple(q0.shape)}")
    if orth_every < 1 or min(ns_steps, polish, final_ns) < 0:
        raise ValueError(
            f"orth_every must be >= 1 and ns_steps, polish, final_ns >= 0, "
            f"got {orth_every}, {ns_steps}, {polish}, {final_ns}")
    return pe_launch_plan(n, k, b)


def pe_subspace_iterate(m: torch.Tensor, q0: torch.Tensor, iters: int = 24,
                        orth_every: int = 4, ns_steps: int = 4,
                        power_lo: bool = True, polish: int = 2,
                        final_ns: int = 8) -> torch.Tensor:
    """Kernel 2 wrapper: m (B, N, N) float32 or bfloat16, q0 (B, N, k)
    float32 → (B, N, k) float32. CUDA tensors launch ``csrc/pe.cu`` (one launch counted);
    CPU tensors run :func:`pe_subspace_iterate_plain`. N ≤ 832 (padded
    to a multiple of 32), k ≤ 832; ``power_lo`` both ways and any
    ``iters``/``orth_every``/``ns_steps``/``polish``/``final_ns``."""
    if m.device.type == "cpu":
        return pe_subspace_iterate_plain(m, q0, iters, orth_every, ns_steps,
                                         power_lo, polish, final_ns)
    if m.device.type != "cuda":
        raise ValueError(f"unsupported device {m.device}")
    plan = _check_inputs(m, q0, orth_every, ns_steps, polish, final_ns)
    b, n, k = q0.shape
    n_pad = plan["n_pad"]
    if n_pad != n:
        # Zero rows/columns of M and zero rows of q0 stay exactly zero
        # through every step, so padding the node axis is exact.
        m = F.pad(m, (0, n_pad - n, 0, n_pad - n))
        q0 = F.pad(q0, (0, 0, 0, n_pad - n))
    lib = _pe_lib()
    m, q0 = m.contiguous(), q0.contiguous()
    out = torch.empty((b, n_pad, k), dtype=torch.float32, device=m.device)
    scratch = torch.empty((b, plan["scratch_bytes"]), dtype=torch.uint8,
                          device=m.device)
    with torch.cuda.device(m.device):
        err = lib.gcc_pe_launch(
            m.data_ptr(), q0.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch.numel() else None, b, n_pad, k,
            iters,
            orth_every, ns_steps, polish, final_ns, 1 if power_lo else 0,
            1 if m.dtype == torch.bfloat16 else 0,
            torch.cuda.current_stream(m.device).cuda_stream)
    _build.check(err, "pe")
    pe_subspace_iterate.launches += 1
    return out[:, :n] if n_pad != n else out


pe_subspace_iterate.launches = 0
