"""The card's idle share in the traced stretch of the embed traffic
(counts/shares.py)."""

from benchmark.counts import shares


def read(rec):
    return shares.idle(rec, "embed")
