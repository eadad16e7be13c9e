"""Shares read from a traced stretch: the featurize kernels' share of
their roofline and the card's idle share."""

from __future__ import annotations

from benchmark.counts.bound import seconds

# The program's featurize kernels (csrc/featurize.cu, pe.cu, jacobi.cu),
# matched within the profiler's kernel names.
FEATURIZE_KERNELS = (
    "featurize_band_kernel", "featurize_tile_kernel", "pe_kernel",
    "pe_cluster_kernel", "pe_general_kernel", "jacobi_warp_kernel",
    "jacobi_pair_kernel", "jacobi_cluster_kernel")


def roofline(rec: dict, kind: str):
    """The bound time of the featurize work the stretch's inputs need,
    summed, over the named kernels' device time in it, summed, in %; None
    where the stretch holds none of them."""
    tr = rec.get("trace")
    if rec.get("kind") != kind or not tr:
        return None
    dev = sum(s for name, s in tr["kernel_s"].items()
              if any(k in name for k in FEATURIZE_KERNELS))
    if dev <= 0:
        return None
    return 100.0 * sum(seconds(w) for w in tr["featurize_work"]) / dev


def idle(rec: dict, kind: str):
    """The part of the stretch with no kernel, copy or set on the card, in
    %; None where nothing ran there."""
    tr = rec.get("trace")
    if rec.get("kind") != kind or not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
