"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks for the ``cuda_device`` fixture, which
skips when no card is present (the CPU tier runs none of them). On a
machine with an H100:

    python -m pytest tests/test_torch_cuda.py tests/test_torch_port.py \
        -q --noconftest

(``--noconftest`` where JAX is not installed: the repository's conftest
configures JAX). chip_smoke.py makes the same comparisons at the main
path's production shapes.
"""

import numpy as np
import pytest
import torch

from gcc_tpu_torch.features.positional import subspace_start
from gcc_tpu_torch.ops import aggregate, jacobi, pe

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _wire(rng, s, b, n_max, e_tot):
    """Wire segments of random symmetric multigraphs (both directions of
    every edge, as the sampler emits), one zero-edge graph, stale tails."""
    edges = np.full((s, e_tot), 0xFFFF, np.int32)
    meta = np.zeros((s, 3, b), np.int32)
    for i in range(s):
        n = rng.integers(1, n_max + 1, b)
        half = rng.integers(0, e_tot // (2 * b), b)
        half[0] = 0
        runs = []
        for j in range(b):
            u = rng.integers(0, n[j], half[j])
            v = rng.integers(0, n[j], half[j])
            runs.append(np.concatenate([u | (v << 8), v | (u << 8)]))
        flat = np.concatenate(runs)
        edges[i, : flat.size] = flat
        meta[i] = np.stack([n, 2 * half, np.zeros(b, np.int64)])
    return edges, meta


@pytest.mark.parametrize("n_max", [64, 128, 256])
def test_featurize_kernel_matches_plain(cuda_device, n_max):
    """Adjacency and degrees exact, m_shift within 1e-6 (both round the
    same products; rsqrt may differ by an ulp)."""
    edges, meta = _wire(np.random.default_rng(n_max), 4, 8, n_max, 2048)
    e = torch.as_tensor(edges, device=cuda_device)
    m = torch.as_tensor(meta, device=cuda_device)
    before = aggregate.fused_adjacency_featurize.launches
    got = aggregate.fused_adjacency_featurize(e, m, n_max, 8)
    want = aggregate.fused_adjacency_featurize_plain(e, m, n_max, 8)
    assert aggregate.fused_adjacency_featurize.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert (got[1] - want[1]).abs().max().item() <= 1e-6


@pytest.mark.parametrize("n", [8, 32, 48])
def test_jacobi_kernel_matches_plain(cuda_device, n):
    """The kernel runs the plain version's rounds with correctly rounded
    f32 operations: results within 1e-6."""
    a = torch.randn(64, n, n, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(n))
    a = 0.5 * (a + a.transpose(1, 2))
    for desc in (False, True):
        w, v = jacobi.jacobi_eigh(a, sweeps=3, descending=desc)
        w0, v0 = jacobi.jacobi_eigh_plain(a, sweeps=3, descending=desc)
        assert (w - w0).abs().max().item() <= 1e-6
        assert (v - v0).abs().max().item() <= 1e-6


@pytest.mark.parametrize("n_max", [64, 128])
def test_pe_kernel_matches_plain(cuda_device, n_max):
    """f32 rounds: within 1e-5 (the same arithmetic, f32 sums in another
    order). Production bf16 rounds: a last-bit difference can flip a
    bf16 rounding, a 2^-8 relative step the iteration carries on — mean
    within 1e-4, max within 2e-2."""
    edges, meta = _wire(np.random.default_rng(1), 2, 16, n_max, 4096)
    e = torch.as_tensor(edges, device=cuda_device)
    m = torch.as_tensor(meta, device=cuda_device)
    _, m_shift, _ = aggregate.fused_adjacency_featurize_plain(e, m, n_max, 8)
    q0 = subspace_start(n_max, 16, aggregate.node_mask_from_meta(m, n_max))
    got = pe.pe_subspace_iterate(m_shift, q0, iters=16, power_lo=False)
    want = pe.pe_subspace_iterate_plain(m_shift, q0, iters=16,
                                        power_lo=False)
    assert (got - want).abs().max().item() <= 1e-5
    got = pe.pe_subspace_iterate(m_shift, q0, iters=16)
    want = pe.pe_subspace_iterate_plain(m_shift, q0, iters=16)
    assert torch.isfinite(got).all()
    diff = (got - want).abs()
    assert diff.mean().item() <= 1e-4 and diff.max().item() <= 2e-2
