"""Host → device transfer of compact wire batches.

A :class:`~gcc_tpu_torch.graph.batch.CompactWireBatch` leaves the
sampler as numpy: ``edges`` uint16 ``src | dst << 8`` (or int32
``src | dst << 16`` when ``id_bits == 16``) and ``meta`` (..., 3, B)
int32. On the device both become int32 tensors; the kernels and the
plain versions unpack ids with shifts and masks. uint16 travels as its
int16 bit pattern (torch has full int16 support) and is widened on the
device, so the copy moves 2 bytes per edge.
"""

from __future__ import annotations

import numpy as np
import torch

from gcc_tpu_torch.device import resolve_device
from gcc_tpu_torch.graph.batch import CompactWireBatch


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        # Pinned staging copy + async upload; the caching host allocator
        # keeps the pinned block alive until the copy has run.
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def wire_to_device(wire: CompactWireBatch, device="cuda"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (edges, meta) as int32 tensors on ``device``: edges keeps
    the packed form (``src | dst << id_bits``, widened to int32) and its
    shape, meta its (..., 3, B) shape. A wire already uploaded (tensor
    fields, as :func:`~gcc_tpu_torch.parallel.multihost.host_local_batch_to_global`
    leaves it) passes through."""
    device = resolve_device(device)
    if torch.is_tensor(wire.edges):
        return wire.edges.to(device), wire.meta.to(device)
    edges = np.asarray(wire.edges)
    if edges.dtype == np.uint16:
        e = _to_device(edges.view(np.int16), device)
        e = e.to(torch.int32) & 0xFFFF
    elif edges.dtype == np.int32:
        e = _to_device(edges, device)
    else:
        raise TypeError(f"wire edges must be uint16 or int32, not "
                        f"{edges.dtype}")
    meta = _to_device(np.asarray(wire.meta, np.int32), device)
    return e, meta
