"""The operations the window's generation calls require (counts/: both
views' eval encode and featurize kernels, at real node and edge counts)
over the window's length, as a share of the card's float32 peak."""

from benchmark.counts import peaks


def read(rec):
    if rec.get("kind") != "embed" or not rec.get("window_s"):
        return None
    return 100.0 * rec["work_ops"] / (rec["window_s"] * peaks.F32_PER_S)
