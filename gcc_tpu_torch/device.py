"""Device selection for the port's entry points.

Entry points take an explicit ``device`` and default to ``"cuda"``. A
CUDA request on a machine without a usable card raises instead of
quietly running on the CPU: a CPU run (the tests pass ``device="cpu"``)
exercises the kernels' plain versions, never the kernels.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gcc_tpu_torch: CUDA was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"gcc_tpu_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev
