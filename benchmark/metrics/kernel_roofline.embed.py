"""The featurize kernels' share of their roofline in the traced stretch of
the embed traffic (counts/shares.py)."""

from benchmark.counts import shares


def read(rec):
    return shares.roofline(rec, "embed")
