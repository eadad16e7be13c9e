"""Host-side wire types for subgraph batches (numpy only).

The sampler ships batches in a compact form — per-graph edge runs
concatenated into one packed buffer plus three small per-graph vectors —
and everything else (adjacency, node mask, seed one-hot, degrees, PE) is
derived on the device (``gcc_tpu_torch/features``). ``wire.py`` moves
these arrays onto the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WireBatch:
    """Padded wire form: (B, E_max) int16 local edge endpoints (entries
    past each graph's n_edges are arbitrary) + (B,) int32 n_nodes,
    n_edges, seed_pos. Used by the pipeline's start-up probe."""

    src: np.ndarray
    dst: np.ndarray
    n_nodes: np.ndarray
    n_edges: np.ndarray
    seed_pos: np.ndarray


@dataclasses.dataclass(frozen=True)
class CompactWireBatch:
    """Flat-edge wire form: per-graph edge runs concatenated into one
    packed (E_tot,) buffer instead of a padded (B, E_max) int16 grid.

      edges: (E_tot,) — uint16 ``src | dst << 8`` when the bucket's
        local ids fit a byte, else int32 ``src | dst << 16``. Stacked
        dispatch items carry (K, E_tot).
      meta:  (3, B) int32 — rows n_nodes, n_edges, seed_pos ((K, 3, B)
        when stacked).

    ``e_max`` is the per-graph edge cap, ``id_bits`` the packing width,
    and ``n_max`` the node bucket a routed item was sorted into (0 =
    unrouted: the consumer's bucket applies).
    """

    edges: np.ndarray
    meta: np.ndarray
    e_max: int = 2048
    id_bits: int = 8
    n_max: int = 0

    @property
    def src(self) -> np.ndarray:
        return (np.asarray(self.edges).astype(np.int32)
                & ((1 << self.id_bits) - 1))

    @property
    def dst(self) -> np.ndarray:
        return (np.asarray(self.edges).astype(np.int32) >> self.id_bits) & (
            (1 << self.id_bits) - 1
        )


def pack_edge_ids(src, dst, n_max: int):
    """Host-side packing of compact local edge ids into one integer per
    edge: uint16 (8+8 bits) when n_max <= 256, else int32 (16+16)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if n_max <= 256:
        return (src.astype(np.uint16) & 0xFF) | (
            (dst.astype(np.uint16) & 0xFF) << 8
        ), 8
    return (src.astype(np.int32) & 0xFFFF) | (
        (dst.astype(np.int32) & 0xFFFF) << 16
    ), 16


@dataclasses.dataclass(frozen=True)
class Subgraph:
    """Host-side subgraph: relabeled edge list + node count + seed position."""

    src: np.ndarray  # (E,) int32, local ids
    dst: np.ndarray  # (E,) int32, local ids
    num_nodes: int
    seed: int = 0  # local id of the walk seed (0 except entire-graph mode)
