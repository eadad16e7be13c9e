"""Device ops: plain PyTorch functions and the wrappers of the three
hand-written CUDA kernels (``csrc/``), each beside its plain version.

=====================================  =========================  ==========================================
wrapper                                kernel source              replaces (TPU kernel)
=====================================  =========================  ==========================================
aggregate.fused_adjacency_featurize    csrc/featurize.cu          gcc_tpu/ops/featurize_pallas.py:92
pe.pe_subspace_iterate                 csrc/pe.cu                 gcc_tpu/ops/pe_pallas.py:141
jacobi.jacobi_eigh                     csrc/jacobi.cu             gcc_tpu/ops/jacobi_pallas.py:189
=====================================  =========================  ==========================================

Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from gcc_tpu_torch.ops.aggregate import fused_adjacency_featurize
from gcc_tpu_torch.ops.jacobi import jacobi_eigh
from gcc_tpu_torch.ops.pe import pe_subspace_iterate

KERNEL_WRAPPERS = {
    "featurize": fused_adjacency_featurize,
    "pe": pe_subspace_iterate,
    "jacobi": jacobi_eigh,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


__all__ = [
    "KERNEL_WRAPPERS",
    "fused_adjacency_featurize",
    "jacobi_eigh",
    "launch_counts",
    "pe_subspace_iterate",
    "reset_launch_counts",
]
