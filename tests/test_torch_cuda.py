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


def _wire(rng, s, b, n_max, e_tot, id_bits=8):
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
            runs.append(np.concatenate([u | (v << id_bits), v | (u << id_bits)]))
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
    """The kernels (one warp per matrix at n = 32, one thread per 2x2
    block at n = 48, one block per matrix else) run the plain version's
    rounds with correctly rounded f32 operations: results within 1e-6."""
    a = torch.randn(64, n, n, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(n))
    a = 0.5 * (a + a.transpose(1, 2))
    for desc in (False, True):
        w, v = jacobi.jacobi_eigh(a, sweeps=3, descending=desc)
        w0, v0 = jacobi.jacobi_eigh_plain(a, sweeps=3, descending=desc)
        assert (w - w0).abs().max().item() <= 1e-6
        assert (v - v0).abs().max().item() <= 1e-6


@pytest.mark.parametrize("batch", [1, 3, 2777])
def test_jacobi_warp_kernel_batches(cuda_device, batch):
    """n = 32 at a batch of one, one that does not fill a block of four
    warps, and one larger than a wave of resident warps; a diagonal
    matrix and repeated eigenvalues among them (identity rotations, the
    sort's tie rule)."""
    a = torch.randn(batch, 32, 32, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(batch))
    a = 0.5 * (a + a.transpose(1, 2))
    a[0] = torch.diag(torch.arange(32, device=cuda_device).float() // 2)
    before = jacobi.jacobi_eigh.launches
    w, v = jacobi.jacobi_eigh(a, sweeps=3, descending=True)
    assert jacobi.jacobi_eigh.launches == before + 1
    w0, v0 = jacobi.jacobi_eigh_plain(a, sweeps=3, descending=True)
    assert (w - w0).abs().max().item() <= 1e-6
    assert (v - v0).abs().max().item() <= 1e-6


@pytest.mark.parametrize("batch", [1, 3, 64, 2777])
def test_jacobi_pair_kernel_batches(cuda_device, batch):
    """n = 48 at a batch of one, a few, the serve path's 64 and one of
    several waves of blocks; a diagonal matrix and
    repeated eigenvalues among them; both orders; sweeps = 0 only sorts.
    Equal to the plain version bit for bit."""
    a = torch.randn(batch, 48, 48, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(batch))
    a = 0.5 * (a + a.transpose(1, 2))
    a[0] = torch.diag(torch.arange(48, device=cuda_device).float() // 2)
    assert jacobi.jacobi_launch_plan(48, batch)["variant"].startswith(
        "thread-per-2x2-block")
    for desc in (False, True):
        for sweeps in (0, 3):
            before = jacobi.jacobi_eigh.launches
            w, v = jacobi.jacobi_eigh(a, sweeps=sweeps, descending=desc)
            assert jacobi.jacobi_eigh.launches == before + 1
            w0, v0 = jacobi.jacobi_eigh_plain(a, sweeps=sweeps,
                                              descending=desc)
            assert torch.equal(w, w0) and torch.equal(v, v0)


def _pe_case(device, n_max, k, graphs, seed=1, e_tot=4096, id_bits=8):
    """m_shift and a start block for `graphs` random graphs of up to
    n_max nodes."""
    b = 16
    s = -(-graphs // b)
    edges, meta = _wire(np.random.default_rng(seed), s, b, n_max, e_tot,
                        id_bits)
    e = torch.as_tensor(edges, device=device)
    m = torch.as_tensor(meta, device=device)
    _, m_shift, _ = aggregate.fused_adjacency_featurize_plain(e, m, n_max,
                                                              id_bits)
    q0 = subspace_start(n_max, k, aggregate.node_mask_from_meta(m, n_max))
    return m_shift[:graphs].contiguous(), q0[:graphs].contiguous()


def _pe_compare(m_shift, q0, **kw):
    """f32 rounds: within 1e-5 (the same arithmetic, f32 sums in another
    order). Production bf16 rounds: a last-bit difference can flip a
    bf16 rounding, a 2^-8 relative step the iteration carries on — mean
    within 1e-4, max within 2e-2."""
    got = pe.pe_subspace_iterate(m_shift, q0, iters=16, power_lo=False, **kw)
    want = pe.pe_subspace_iterate_plain(m_shift, q0, iters=16,
                                        power_lo=False, **kw)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5
    before = pe.pe_subspace_iterate.launches
    got = pe.pe_subspace_iterate(m_shift, q0, iters=16, **kw)
    assert pe.pe_subspace_iterate.launches == before + 1
    want = pe.pe_subspace_iterate_plain(m_shift, q0, iters=16, **kw)
    assert torch.isfinite(got).all()
    diff = (got - want).abs()
    assert diff.mean().item() <= 1e-4 and diff.max().item() <= 2e-2


@pytest.mark.parametrize("n_max", [64, 128])
def test_pe_kernel_matches_plain(cuda_device, n_max):
    _pe_compare(*_pe_case(cuda_device, n_max, 16, 32))


@pytest.mark.parametrize("n_max,k,graphs", [
    (256, 32, 32),     # the large bucket
    (256, 48, 16),     # the most shared memory
    (128, 48, 16),     # three row tiles
    (96, 32, 16),      # N padded to a multiple of 32 by the kernel's plan
    (100, 16, 16),     # N padded by the wrapper
    (32, 8, 16),       # two warps, k padded to 16
    (128, 32, 133),    # a batch that is no multiple of the SM count
])
def test_pe_kernel_shapes(cuda_device, n_max, k, graphs):
    _pe_compare(*_pe_case(cuda_device, n_max, k, graphs))


@pytest.mark.parametrize("n_max,k,graphs", [
    (288, 32, 8),      # the smallest streamed shape, two passes of columns
    (512, 48, 8),      # the generate path's default bucket
    (500, 48, 4),      # N padded by the wrapper
    (832, 48, 4),      # the largest shape the kernel takes
    (320, 16, 4),      # one row tile
    (512, 48, 140),    # more blocks than SMs
    (352, 48, 6),      # 22 slabs of 16 columns over 2 blocks
    (544, 32, 5),      # 34 slabs over 4 blocks: 9, 9, 9, 7
    (800, 48, 3),      # 50 slabs over 4 blocks: 13, 13, 13, 11
])
def test_pe_streamed_plan_matches_plain(cuda_device, n_max, k, graphs):
    """256 < N <= 832: a cluster of blocks per graph, the rounds on the
    tensor cores against a bf16 copy of M streamed from device memory;
    the same limits as the shared plan. The graphs have 1 to N nodes, so
    the live slabs split unevenly and some blocks get none."""
    assert pe.pe_launch_plan(n_max, k)["plan"] == "streamed"
    _pe_compare(*_pe_case(cuda_device, n_max, k, graphs, e_tot=16384,
                          id_bits=16))


def test_pe_streamed_plan_small_graphs_stay_finite(cuda_device):
    """Graphs with fewer nodes than columns (rank deficient) and an
    empty graph in a 512 bucket: finite output, zero on the padding."""
    m_shift, q0 = _pe_case(cuda_device, 512, 48, 16, e_tot=16384, id_bits=16)
    m_shift[1, 20:, :] = 0
    m_shift[1, :, 20:] = 0
    q0[1, 20:] = 0
    m_shift[2] = 0
    q0[2] = 0
    got = pe.pe_subspace_iterate(m_shift, q0, iters=16)
    assert torch.isfinite(got).all()
    assert got[1, 20:].abs().max().item() == 0 and got[2].abs().max() == 0


def test_pe_streamed_plan_batch_of_one(cuda_device):
    """A cluster's result does not depend on the batch around it: each
    graph alone equals the same graph in a batch, bit for bit."""
    m_shift, q0 = _pe_case(cuda_device, 512, 48, 5, e_tot=16384, id_bits=16)
    for lo in (False, True):
        full = pe.pe_subspace_iterate(m_shift, q0, iters=16, power_lo=lo)
        for i in (0, 4):
            one = pe.pe_subspace_iterate(m_shift[i:i + 1], q0[i:i + 1],
                                         iters=16, power_lo=lo)
            assert one.shape == (1, 512, 48) and torch.equal(one[0], full[i])


@pytest.mark.parametrize("kw", [
    dict(orth_every=1, ns_steps=1, polish=0, final_ns=0),
    dict(orth_every=3, ns_steps=2, polish=1, final_ns=3),
    dict(orth_every=16, ns_steps=0, polish=0, final_ns=8),
])
def test_pe_streamed_plan_schedules(cuda_device, kw):
    _pe_compare(*_pe_case(cuda_device, 512, 48, 8, e_tot=16384, id_bits=16),
                **kw)


def test_pe_kernel_refuses_beyond_832(cuda_device):
    m = torch.zeros(1, 864, 864, device=cuda_device)
    q0 = torch.zeros(1, 864, 48, device=cuda_device)
    with pytest.raises(ValueError, match="N=864, k=48"):
        pe.pe_subspace_iterate(m, q0)


def test_pe_kernel_batch_of_one(cuda_device):
    """A block's result does not depend on the batch around it: graph 0
    alone equals graph 0 of a batch, bit for bit (the mean tolerance of
    the bf16 rounds is a statistic over many graphs, not of one)."""
    m_shift, q0 = _pe_case(cuda_device, 128, 32, 16)
    for lo in (False, True):
        full = pe.pe_subspace_iterate(m_shift, q0, iters=16, power_lo=lo)
        one = pe.pe_subspace_iterate(m_shift[:1], q0[:1], iters=16,
                                     power_lo=lo)
        assert one.shape == (1, 128, 32) and torch.equal(one[0], full[0])
    got = pe.pe_subspace_iterate(m_shift[:1], q0[:1], iters=16,
                                 power_lo=False)
    want = pe.pe_subspace_iterate_plain(m_shift[:1], q0[:1], iters=16,
                                        power_lo=False)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("kw", [
    dict(orth_every=1, ns_steps=1, polish=0, final_ns=0),
    dict(orth_every=3, ns_steps=2, polish=1, final_ns=3),
    dict(orth_every=16, ns_steps=0, polish=0, final_ns=8),
])
def test_pe_kernel_schedules(cuda_device, kw):
    _pe_compare(*_pe_case(cuda_device, 128, 32, 16), **kw)


def test_pe_plan_mirrors_the_source(cuda_device):
    """pe_launch_plan (Python) and pe_plan (csrc/pe.cu) agree on every
    shape the wrapper takes."""
    import ctypes

    lib = pe._pe_lib()
    out = (ctypes.c_int * 9)()
    for n in (32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 512, 544,
              800, 832):
        for k in (1, 8, 16, 17, 32, 33, 48, 49, 64, 65, 80):
            assert lib.gcc_pe_plan(n, k, out) == 0
            plan = pe.pe_launch_plan(n, k)
            assert list(out) == [plan["threads"], plan["smem_bytes"],
                                 plan["kp"], plan["warps"],
                                 plan["gram_split"], plan["gram_f32_split"],
                                 plan["cluster"], plan["slabs_per_block"],
                                 plan["scratch_bytes"]]
    assert lib.gcc_pe_plan(864, 32, out) != 0
    assert lib.gcc_pe_plan(128, 81, out) != 0


@pytest.mark.parametrize("n,batch", [(64, 1), (64, 4096), (80, 64),
                                     (80, 3), (118, 5), (56, 7)])
def test_jacobi_block_kernel_wide(cuda_device, n, batch):
    """Even n above 48 (PE 64: n = 64 on the train profile, 80 on the eval
    profile and the giant finish; 118 the widest block; 56 the first
    beyond a plain launch's 48 KB) run the block kernel with dynamic
    shared memory, bit for bit the plain version, both orders."""
    a = torch.randn(batch, n, n, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(n))
    a = 0.5 * (a + a.transpose(1, 2))
    a[0] = torch.diag(torch.arange(n, device=cuda_device).float() // 2)
    assert jacobi.jacobi_launch_plan(n, batch)["variant"].startswith(
        "block-per-matrix")
    for desc in (False, True):
        before = jacobi.jacobi_eigh.launches
        w, v = jacobi.jacobi_eigh(a, sweeps=3, descending=desc)
        assert jacobi.jacobi_eigh.launches == before + 1
        w0, v0 = jacobi.jacobi_eigh_plain(a, sweeps=3, descending=desc)
        assert torch.equal(w, w0) and torch.equal(v, v0)


@pytest.mark.parametrize("n", [120, 65])
def test_jacobi_kernel_refuses_beyond_its_widths(cuda_device, n):
    a = torch.zeros(2, n, n, device=cuda_device)
    with pytest.raises(ValueError, match=f"n={n}"):
        jacobi.jacobi_eigh(a)


@pytest.mark.parametrize("n_max,k,graphs", [
    (128, 64, 32),     # the train profile's small bucket at PE 64
    (256, 64, 16),     # its large bucket
    (256, 80, 16),     # the eval profile at bucket 256
    (512, 80, 6),      # the eval profile's default bucket
    (832, 80, 3),      # the largest shape the kernel takes
    (100, 49, 8),      # N and k both padded
    (160, 80, 140),    # more blocks than SMs
])
def test_pe_wide_plan_matches_plain(cuda_device, n_max, k, graphs):
    """48 < k <= 80: one block per graph, Q in a device scratch, f32 FMAs
    on operands rounded to bf16 where the plain version rounds them; the
    limits of the other plans."""
    assert pe.pe_launch_plan(n_max, k)["plan"] == "wide"
    big = n_max > 256
    _pe_compare(*_pe_case(cuda_device, n_max, k, graphs,
                          e_tot=16384 if big else 4096,
                          id_bits=16 if big else 8))


@pytest.mark.parametrize("kw", [
    dict(orth_every=1, ns_steps=1, polish=0, final_ns=0),
    dict(orth_every=3, ns_steps=2, polish=1, final_ns=3),
    dict(orth_every=16, ns_steps=0, polish=0, final_ns=8),
])
def test_pe_wide_plan_schedules(cuda_device, kw):
    _pe_compare(*_pe_case(cuda_device, 128, 80, 16), **kw)


def test_pe_wide_plan_small_graphs_and_batch_of_one(cuda_device):
    """Graphs smaller than the block width and an empty graph stay finite
    and zero on the padding; each graph alone equals the same graph in a
    batch, bit for bit."""
    m_shift, q0 = _pe_case(cuda_device, 256, 80, 6)
    m_shift[1, 20:, :] = 0
    m_shift[1, :, 20:] = 0
    q0[1, 20:] = 0
    m_shift[2] = 0
    q0[2] = 0
    for lo in (False, True):
        full = pe.pe_subspace_iterate(m_shift, q0, iters=16, power_lo=lo)
        assert torch.isfinite(full).all()
        assert full[1, 20:].abs().max().item() == 0
        assert full[2].abs().max().item() == 0
        for i in (0, 5):
            one = pe.pe_subspace_iterate(m_shift[i:i + 1], q0[i:i + 1],
                                         iters=16, power_lo=lo)
            assert torch.equal(one[0], full[i])


def test_pe_kernel_refuses_beyond_80(cuda_device):
    m = torch.zeros(1, 128, 128, device=cuda_device)
    q0 = torch.zeros(1, 128, 81, device=cuda_device)
    with pytest.raises(ValueError, match="N=128, k=81"):
        pe.pe_subspace_iterate(m, q0)
