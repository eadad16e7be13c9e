"""The least time the card needs for counted work: the larger of its
bytes over the bandwidth and its operations over the peak of their
precision (bf16 on the tensor cores, float32 beside them)."""

from __future__ import annotations

from benchmark.counts import peaks


def seconds(work: dict) -> float:
    ops = work["f32"] / peaks.F32_PER_S + work["bf16"] / peaks.BF16_PER_S
    return max(work["bytes"] / peaks.BYTES_PER_S, ops)


def total(works) -> dict:
    out = {"f32": 0.0, "bf16": 0.0, "bytes": 0.0}
    for w in works:
        for k in out:
            out[k] += w[k]
    return out
