"""gcc_tpu_torch — the PyTorch/CUDA port of gcc_tpu for NVIDIA Hopper.

Mirrors ``gcc_tpu``'s module layout. Host code (corpus, sampler,
pipeline) is numpy and C++; device code is PyTorch, and each Pallas
kernel of ``gcc_tpu/ops`` has a hand-written CUDA counterpart under
``gcc_tpu_torch/csrc`` with a plain PyTorch version beside its wrapper
(``gcc_tpu_torch/ops``). Entry points default to ``device="cuda"``.
"""

from gcc_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
