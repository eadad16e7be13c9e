"""The counted work of Kernels 1-3, the encoder and the steps, against
numbers worked by hand for one small graph, and unchanged by padding."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.counts import bound, encoder, kernel1, kernel2, kernel3, peaks
from benchmark.counts import step as step_counts

# A path 0-1-2-3, each edge both ways: n = 4 nodes, e = 6 edges.
N, E = 4, 6
TINY_CFG = {"positional_embedding_size": 2, "degree_embedding_size": 1,
            "hidden_size": 3, "output_size": 2, "num_layers": 3}


def test_kernel1_by_hand():
    w = kernel1.work([N], [E])
    assert w["f32"] == 3 * 16
    # 6 edges x 4 B + 12 B meta + adj and m_shift 2 x 16 x 4 B + 4 degrees.
    assert w["bytes"] == 24 + 12 + 128 + 16
    assert w["bf16"] == 0


def test_kernel2_by_hand():
    w = kernel2.work([N], k=2)
    ns = 4 * 2 * 3 + 2 * 4 * 4          # Gram n k(k+1) + product 2 n k^2
    assert w["bf16"] == 2 * 16 * 2 * 16 + 4 * 4 * ns   # 16 steps, 4 x 4 NS
    assert w["f32"] == 2 * 16 * 2 * 2 + 8 * ns         # 2 polish, 8 NS
    assert w["bytes"] == 16 * 4 + 2 * 4 * 2 * 4


def test_kernel3_by_hand():
    w = kernel3.work(4, 1, sweeps=3)
    assert w["f32"] == 3 * 3 * (9 * 16 + 10 * 4)
    assert w["bytes"] == (2 * 16 + 4) * 4


def test_encoder_by_hand():
    # dims [4, 3, 3]; conv layers on 4 and 3 inputs, hidden 3, output 2.
    conv4 = 2 * E * 4 + N * 4 + 2 * N * 4 * 3 + 2 * N * 3 * 3
    conv3 = 2 * E * 3 + N * 3 + 2 * N * 3 * 3 + 2 * N * 3 * 3
    readouts = (N * 4 + 2 * 4 * 2) + 2 * (N * 3 + 2 * 3 * 2)
    assert encoder.forward([N], [E], TINY_CFG) == conv4 + conv3 + readouts
    assert encoder.logits(2, 5, 4) == 2 * 2 * 5 * 4


def test_bound_takes_the_larger_side():
    w = {"f32": 67e12, "bf16": 989e12, "bytes": 3.35e12}
    assert bound.seconds(w) == pytest.approx(2.0)
    w = {"f32": 0.0, "bf16": 0.0, "bytes": 2 * peaks.BYTES_PER_S}
    assert bound.seconds(w) == pytest.approx(2.0)


def _real_sizes(adj: torch.Tensor, node_mask: torch.Tensor):
    return (node_mask.sum(dim=1).long().numpy(),
            adj.sum(dim=(1, 2)).long().numpy())


@pytest.mark.parametrize("n_max", [4, 8, 32])
def test_padding_leaves_every_count_unchanged(n_max):
    """The same two graphs in buckets of 4, 8 and 32 nodes, and with empty
    graphs added to the batch, count alike."""
    adj = torch.zeros(3, n_max, n_max)
    for u, v in ((0, 1), (1, 2), (2, 3)):
        adj[0, u, v] = adj[0, v, u] = 1.0
    adj[1, 0, 1] = adj[1, 1, 0] = 2.0
    mask = torch.zeros(3, n_max)
    mask[0, :4] = 1.0
    mask[1, :2] = 1.0
    n, e = _real_sizes(adj, mask)
    works = step_counts.featurize(n, e, pos=2, guards=0, compact=True)
    got = {k: w for k, w in works.items()}
    ref = step_counts.featurize(np.array([4, 2]), np.array([6, 4]), pos=2,
                                guards=0, compact=True)
    for k in ("kernel1", "kernel2", "kernel3"):
        assert got[k] == ref[k]
    assert encoder.forward(n, e, TINY_CFG) == encoder.forward(
        [4, 2], [6, 4], TINY_CFG)
