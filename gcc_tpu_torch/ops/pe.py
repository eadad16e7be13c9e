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
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gcc_tpu_torch.ops import build as _build

# Shared memory a block may use on Hopper (227 KB).
_MAX_SMEM = 232_448


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
    """Plain PyTorch version of Kernel 2. m (B, N, N), q0 (B, N, k) →
    (B, N, k). ``power_lo`` selects bf16 inputs for the round products
    (the production setting); polish and the final NS are f32."""
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


_PE_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def _pe_lib() -> ctypes.CDLL:
    lib = _build.load("pe")
    lib.gcc_pe_launch.argtypes = _PE_ARGS
    lib.gcc_pe_launch.restype = ctypes.c_int
    lib.gcc_pe_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gcc_pe_smem_bytes.restype = ctypes.c_int
    return lib


def pe_subspace_iterate(m: torch.Tensor, q0: torch.Tensor, iters: int = 24,
                        orth_every: int = 4, ns_steps: int = 4,
                        power_lo: bool = True, polish: int = 2,
                        final_ns: int = 8) -> torch.Tensor:
    """Kernel 2 wrapper: m (B, N, N) float32, q0 (B, N, k) float32 →
    (B, N, k). CUDA tensors launch ``csrc/pe.cu`` (one launch counted);
    CPU tensors run :func:`pe_subspace_iterate_plain`."""
    if m.device.type == "cpu":
        return pe_subspace_iterate_plain(m, q0, iters, orth_every, ns_steps,
                                         power_lo, polish, final_ns)
    if m.device.type != "cuda":
        raise ValueError(f"unsupported device {m.device}")
    if m.dtype != torch.float32 or q0.dtype != torch.float32:
        raise TypeError("pe_subspace_iterate takes float32 m and q0")
    b, n, k = q0.shape
    if m.shape != (b, n, n) or q0.device != m.device:
        raise ValueError(f"shape/device mismatch: m {tuple(m.shape)}, "
                         f"q0 {tuple(q0.shape)}")
    if orth_every < 1:
        raise ValueError("orth_every must be >= 1")
    n_pad = -(-n // 32) * 32
    if n_pad != n:
        # Zero rows/columns of M and zero rows of q0 stay exactly zero
        # through every step, so padding the node axis is exact.
        m = F.pad(m, (0, n_pad - n, 0, n_pad - n))
        q0 = F.pad(q0, (0, 0, 0, n_pad - n))
    lib = _pe_lib()
    smem = lib.gcc_pe_smem_bytes(n_pad, k)
    threads = -(-k // 16) * n_pad
    if smem > _MAX_SMEM or threads > 1024:
        raise ValueError(
            f"pe kernel: N={n}, k={k} needs {smem} B of shared memory and "
            f"{threads} threads per block (limits {_MAX_SMEM}, 1024)")
    m, q0 = m.contiguous(), q0.contiguous()
    out = torch.empty((b, n_pad, k), dtype=torch.float32, device=m.device)
    with torch.cuda.device(m.device):
        err = lib.gcc_pe_launch(
            m.data_ptr(), q0.data_ptr(), out.data_ptr(), b, n_pad, k, iters,
            orth_every, ns_steps, polish, final_ns, 1 if power_lo else 0,
            torch.cuda.current_stream(m.device).cuda_stream)
    _build.check(err, "pe")
    pe_subspace_iterate.launches += 1
    return out[:, :n] if n_pad != n else out


pe_subspace_iterate.launches = 0
