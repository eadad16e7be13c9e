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

from featurize_wires import heavy_wire, pair_wire_256
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
    shape the wrapper takes, the general plan's cluster sized by the
    clusters this card holds at once."""
    import ctypes

    lib = pe._pe_lib()
    out = (ctypes.c_int * 9)()
    held = tuple(pe.general_clusters(c) for c in range(1, 9))
    for n in (32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384, 416,
              512, 544, 800, 832):
        for k in (1, 8, 16, 17, 32, 33, 48, 49, 64, 65, 80, 81, 96, 128,
                  240, 241, 256, 832):
            for batch in (1, 16, 64, 128, 4096):
                assert lib.gcc_pe_plan(n, k, batch, out) == 0
                plan = pe.pe_launch_plan(n, k, batch, held)
                assert list(out) == [
                    plan["threads"], plan["smem_bytes"], plan["kp"],
                    plan["warps"], plan["gram_split"], plan["gram_f32_split"],
                    plan["cluster"], plan["slabs_per_block"],
                    plan["scratch_bytes"]]
    assert lib.gcc_pe_plan(864, 32, 1, out) != 0
    assert lib.gcc_pe_plan(128, 833, 1, out) != 0


@pytest.mark.parametrize("n,batch", [(118, 5), (56, 7)])
def test_jacobi_cluster_kernel_wide(cuda_device, n, batch):
    """Even n above 48 beside PE 64's widths (118 the widest a block holds
    alone; 56 the first beyond a plain launch's 48 KB) run the cluster
    pair kernel on one block a matrix with dynamic shared memory, bit for
    bit the plain version, both orders."""
    a = torch.randn(batch, n, n, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(n))
    a = 0.5 * (a + a.transpose(1, 2))
    a[0] = torch.diag(torch.arange(n, device=cuda_device).float() // 2)
    plan = jacobi.jacobi_launch_plan(n, batch, jacobi.cluster_held())
    assert plan["variant"] == jacobi.CLUSTER_VARIANT and plan["cluster"] == 1
    for desc in (False, True):
        before = jacobi.jacobi_eigh.launches
        w, v = jacobi.jacobi_eigh(a, sweeps=3, descending=desc)
        assert jacobi.jacobi_eigh.launches == before + 1
        w0, v0 = jacobi.jacobi_eigh_plain(a, sweeps=3, descending=desc)
        assert torch.equal(w, w0) and torch.equal(v, v0)


@pytest.mark.parametrize("batch", [1, 3, 64, 4096])
@pytest.mark.parametrize("n", [64, 80])
def test_jacobi_pair_kernel_wide(cuda_device, n, batch):
    """PE 64's widths (n = 64 on the train profile, 80 on the eval profile
    and the giant finish) run the pair kernel, 3 and 5 sweeps, both
    orders, a diagonal matrix with repeated eigenvalues first: bit for
    bit the plain version."""
    a = torch.randn(batch, n, n, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(n))
    a = 0.5 * (a + a.transpose(1, 2))
    a[0] = torch.diag(torch.arange(n, device=cuda_device).float() // 2)
    assert jacobi.jacobi_launch_plan(n, batch)["variant"].startswith(
        "thread-per-2x2-block")
    for sweeps in (3, 5):
        for desc in (False, True):
            before = jacobi.jacobi_eigh.launches
            w, v = jacobi.jacobi_eigh(a, sweeps=sweeps, descending=desc)
            assert jacobi.jacobi_eigh.launches == before + 1
            w0, v0 = jacobi.jacobi_eigh_plain(a, sweeps=sweeps,
                                              descending=desc)
            assert torch.equal(w, w0) and torch.equal(v, v0)


def test_jacobi_plan_mirrors_the_source(cuda_device):
    """jacobi_launch_plan (Python, given the clusters this card holds at
    once) and gcc_jacobi_plan (csrc/jacobi.cu) agree at every width the
    wrapper takes and at batches from one matrix to 4096."""
    import ctypes

    lib = jacobi._jacobi_lib()
    held = jacobi.cluster_held()
    kernels = ("warp-per-matrix, registers",
               "thread-per-2x2-block, one barrier a round",
               jacobi.CLUSTER_VARIANT)
    placements = ("shared", "device")
    out = (ctypes.c_int * 7)()
    for batch in (1, 3, 16, 64, 128, 4096):
        for n in range(4, jacobi.MAX_N + 1, 2):
            assert lib.gcc_jacobi_plan(n, batch, out) == 0
            plan = jacobi.jacobi_launch_plan(n, batch, held)
            placement = ("registers" if out[0] == 0
                         else placements[out[6]])
            assert [kernels[out[0]], *out[1:6], placement] == [
                plan["variant"], plan["threads"], plan["smem_bytes"],
                plan["scratch_bytes"], plan["cluster"], plan["items"],
                plan["placement"]], (n, batch)
    for n in (3, 2, 834):
        assert lib.gcc_jacobi_plan(n, 1, out) != 0


def test_jacobi_cluster_held_on_an_h100(cuda_device):
    """The clusters of 1 to 8 blocks the card holds at once: on an NVIDIA
    H100 80GB HBM3 the plan's default table (a GPC holds whole clusters
    only: 15 of 8 blocks, not 16), never more than one wave of blocks."""
    held = jacobi.cluster_held()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert all(0 < held[c - 1] * c <= sms for c in range(1, 9)), held
    if torch.cuda.get_device_name(0) == "NVIDIA H100 80GB HBM3":
        assert held == jacobi.H100_CLUSTERS_HELD


_CLUSTER_SWEEP = [n for n in range(4, 341, 2) if n not in (32, 48, 64, 80)]


@pytest.mark.parametrize("n", _CLUSTER_SWEEP + [400, 512, 640, 832])
def test_jacobi_cluster_kernel_every_width(cuda_device, n):
    """Every even n from 4 to 340 but the warp and pair kernels' widths,
    and 400 / 512 / 640 / 832 in the device scratch: one matrix, three,
    and the batch that fills one wave at the least cluster that holds the
    matrix, bit for bit the plain version (2 sweeps up to n = 130, 1
    above; a diagonal matrix of repeated eigenvalues first)."""
    held = jacobi.cluster_held()
    least = max(1, jacobi.least_cluster(n))
    sweeps = 2 if n <= 130 else 1
    gen = torch.Generator(cuda_device).manual_seed(n)
    for batch in (1, 3, 132 // least):
        a = torch.randn(batch, n, n, device=cuda_device, generator=gen)
        a = 0.5 * (a + a.transpose(1, 2))
        a[0] = torch.diag(torch.arange(n, device=cuda_device).float() // 2)
        plan = jacobi.jacobi_launch_plan(n, batch, held)
        assert plan["variant"] == jacobi.CLUSTER_VARIANT
        desc = n % 4 == 0
        before = jacobi.jacobi_eigh.launches
        w, v = jacobi.jacobi_eigh(a, sweeps=sweeps, descending=desc)
        assert jacobi.jacobi_eigh.launches == before + 1
        w0, v0 = jacobi.jacobi_eigh_plain(a, sweeps=sweeps, descending=desc)
        assert torch.equal(w, w0) and torch.equal(v, v0), (n, batch)


@pytest.mark.parametrize("n,batch", [(96, 128), (130, 40), (256, 16),
                                     (512, 4)])
def test_jacobi_cluster_kernel_one_matrix_alone(cuda_device, n, batch):
    """One matrix alone (a cluster of up to 8 blocks) equals the same
    matrix inside a batch (a smaller cluster), bit for bit."""
    a = torch.randn(batch, n, n, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(n))
    a = 0.5 * (a + a.transpose(1, 2))
    w, v = jacobi.jacobi_eigh(a, sweeps=1, descending=True)
    for i in (0, batch - 1):
        w1, v1 = jacobi.jacobi_eigh(a[i:i + 1], sweeps=1, descending=True)
        assert torch.equal(w1[0], w[i]) and torch.equal(v1[0], v[i])


def test_jacobi_cluster_kernel_forced_clusters(cuda_device):
    """(4, 256, 256) on every legal cluster (5 to 8 blocks a matrix) and
    every items a thread gives the same bits, equal to the plain version;
    the launch raises on a cluster that does not hold the matrix."""
    a = torch.randn(4, 256, 256, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(7))
    a = 0.5 * (a + a.transpose(1, 2))
    w0, v0 = jacobi.jacobi_eigh_plain(a, sweeps=1, descending=True)
    for cluster in range(jacobi.least_cluster(256), 9):
        for items in jacobi.CLUSTER_ITEMS:
            w, v = jacobi._launch(a, 1, 1e-12, True, cluster, items)
            assert torch.equal(w, w0) and torch.equal(v, v0), (cluster, items)
    with pytest.raises(ValueError, match="clusters of 5 to 8"):
        jacobi._launch(a, 1, 1e-12, True, cluster=4)


@pytest.mark.parametrize("n", [834, 65])
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
    """48 < k <= 80: the rounds on the tensor cores against a bf16 copy of
    M made once per graph (in shared memory up to N = 224 / 160 at kp =
    64 / 80, in a device scratch above), the f32 polish and finish on the
    CUDA cores; the limits of the other plans."""
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
    """Beyond the widest block the kernel takes, k = 832 (the general
    plan now takes 80 < k <= 832)."""
    m = torch.zeros(1, 128, 128, device=cuda_device)
    q0 = torch.zeros(1, 128, 833, device=cuda_device)
    with pytest.raises(ValueError, match="N=128, k=833"):
        pe.pe_subspace_iterate(m, q0)


@pytest.mark.parametrize("k", [64, 80])
@pytest.mark.parametrize("n_max", [32, 128, 256, 512, 832])
def test_pe_wide_plan_by_layout(cuda_device, n_max, k):
    """The wide plan at both of its widths across its layouts (shared up
    to N = 224 / 160, a cluster of 2 or 4 blocks above, one bf16 copy of
    Q^T a block at (512, 80) and (832, 64 / 80)): a batch of graphs of 1
    to N nodes, then a batch of one graph with a few live nodes, each
    against the plain version."""
    assert pe.pe_launch_plan(n_max, k)["plan"] == "wide"
    big = n_max > 256
    m_shift, q0 = _pe_case(cuda_device, n_max, k, 4,
                           e_tot=16384 if big else 4096,
                           id_bits=16 if big else 8)
    _pe_compare(m_shift, q0)
    m_shift[1, 5:, :] = 0
    m_shift[1, :, 5:] = 0
    q0[1, 5:] = 0
    _pe_compare(m_shift[1:2].contiguous(), q0[1:2].contiguous())


@pytest.mark.parametrize("n_max,k,graphs", [
    (128, 96, 8),      # PE 80 with the eval profile's 16 guards
    (256, 96, 6),      # six graphs: clusters of 8 blocks
    (512, 128, 4),     # PE 112 with 16 guards
    (160, 240, 2),     # a partial 64-column tile of Q
    (256, 256, 2),     # the Gram on two 128-row tiles
    (100, 81, 3),      # N and k both padded
    (256, 96, 128),    # the timed shapes' batches: clusters of 1,
    (512, 128, 64),    # 2
    (832, 256, 16),    # and 6 blocks a graph
    (832, 832, 1),     # the widest shape, one graph
])
def test_pe_general_plan_matches_plain(cuda_device, n_max, k, graphs):
    """80 < k <= 832: the rounds on the tensor cores (the A operand split)
    over bf16 copies of M and Q in a device scratch, the f32 polish and
    finish register-tiled on the CUDA cores, a cluster of blocks per graph
    sized by the batch; the limits of the other plans (f32 rounds within
    1e-5; bf16 rounds mean 1e-4, max 2e-2)."""
    assert pe.pe_launch_plan(n_max, k, graphs)["plan"] == "general"
    big = n_max > 256
    _pe_compare(*_pe_case(cuda_device, n_max, k, graphs,
                          e_tot=16384 if big else 4096,
                          id_bits=16 if big else 8))


@pytest.mark.parametrize("kw", [
    dict(orth_every=1, ns_steps=1, polish=0, final_ns=0),
    dict(orth_every=3, ns_steps=2, polish=1, final_ns=3),
    dict(orth_every=16, ns_steps=0, polish=0, final_ns=8),
])
def test_pe_general_plan_schedules(cuda_device, kw):
    """Schedules that leave parts out (no Newton-Schulz step in a round,
    no polish, no finish), at k = 256 on a cluster of 8 blocks a graph:
    the f32 rounds within 1e-5 and the bf16 rounds within their limits."""
    _pe_compare(*_pe_case(cuda_device, 512, 256, 4, e_tot=16384,
                          id_bits=16), **kw)


@pytest.mark.parametrize("n_max,k", [(256, 96), (832, 256)])
def test_pe_general_plan_few_live_nodes(cuda_device, n_max, k):
    """A batch whose second graph has 5 live nodes, an empty third graph:
    finite, zero beyond the live rows, within the limits; each graph alone
    (a cluster of 8 blocks) equals the same graph in the batch (a smaller
    cluster) bit for bit."""
    big = n_max > 256
    m_shift, q0 = _pe_case(cuda_device, n_max, k, 4,
                           e_tot=16384 if big else 4096,
                           id_bits=16 if big else 8)
    m_shift[1, 5:, :] = 0
    m_shift[1, :, 5:] = 0
    q0[1, 5:] = 0
    m_shift[2] = 0
    q0[2] = 0
    _pe_compare(m_shift, q0)
    for lo in (False, True):
        full = pe.pe_subspace_iterate(m_shift, q0, iters=16, power_lo=lo)
        assert torch.isfinite(full).all()
        assert full[1, 5:].abs().max().item() == 0
        assert full[2].abs().max().item() == 0
        for i in (0, 1):
            one = pe.pe_subspace_iterate(m_shift[i:i + 1], q0[i:i + 1],
                                         iters=16, power_lo=lo)
            assert torch.equal(one[0], full[i])


@pytest.mark.parametrize("n,batch", [(120, 5), (128, 3), (256, 2), (832, 1)])
def test_jacobi_cluster_kernel_beyond_118(cuda_device, n, batch):
    """Even n above 118 (A and V^T pass a block's shared memory): the
    cluster pair kernel on a cluster of blocks a matrix (shared memory up
    to n = 328, the device scratch above), bit for bit the plain version,
    both orders."""
    a = torch.randn(batch, n, n, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(n))
    a = 0.5 * (a + a.transpose(1, 2))
    a[0] = torch.diag(torch.arange(n, device=cuda_device).float() // 2)
    plan = jacobi.jacobi_launch_plan(n, batch, jacobi.cluster_held())
    assert plan["variant"] == jacobi.CLUSTER_VARIANT and plan["cluster"] > 1
    assert plan["placement"] == ("device" if n > 328 else "shared")
    sweeps = 1 if n > 256 else 3
    for desc in (False, True):
        before = jacobi.jacobi_eigh.launches
        w, v = jacobi.jacobi_eigh(a, sweeps=sweeps, descending=desc)
        assert jacobi.jacobi_eigh.launches == before + 1
        w0, v0 = jacobi.jacobi_eigh_plain(a, sweeps=sweeps, descending=desc)
        assert torch.equal(w, w0) and torch.equal(v, v0)


# ---- the bf16 storage levers (EncoderConfig.adj_dtype, jacobi_v_dtype) ----

@pytest.mark.parametrize("n_max,e_tot", [(128, 4096), (256, 8192)])
def test_featurize_bf16_kernel_matches_plain(cuda_device, n_max, e_tot):
    """Kernel 1's bf16 variant at the training shapes (4096 graphs): adj,
    m_shift and deg bit for bit the plain version's, adj equal to the f32
    kernel's (counts below 256 are exact in bf16)."""
    edges, meta = _wire(np.random.default_rng(n_max), 128, 32, n_max, e_tot)
    e = torch.as_tensor(edges, device=cuda_device)
    m = torch.as_tensor(meta, device=cuda_device)
    before = aggregate.fused_adjacency_featurize.launches
    got = aggregate.fused_adjacency_featurize(e, m, n_max, 8, "bfloat16")
    assert aggregate.fused_adjacency_featurize.launches == before + 1
    want = aggregate.fused_adjacency_featurize_plain(e, m, n_max, 8,
                                                     "bfloat16")
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    f32 = aggregate.fused_adjacency_featurize(e, m, n_max, 8)
    assert torch.equal(got[0].float(), f32[0])


@pytest.mark.parametrize("n_max,k,graphs,plan", [
    (128, 32, 4096, "shared"),
    (512, 48, 64, "streamed"),
    (128, 64, 4096, "wide"),
    (256, 96, 128, "general"),
])
def test_pe_bf16_m_matches_plain(cuda_device, n_max, k, graphs, plan):
    """Kernel 2 on a bf16 operator, one shape per plan (chip_smoke's): the
    plans' limits against the plain version, and bit for bit the f32
    kernel on the same values widened (a bf16 M is its own bf16 copy, and
    the f32 steps widen it as they read it)."""
    assert pe.pe_launch_plan(n_max, k, graphs)["plan"] == plan
    big = n_max > 256
    m_shift, q0 = _pe_case(cuda_device, n_max, k, graphs,
                           e_tot=16384 if big else 4096,
                           id_bits=16 if big else 8)
    m16 = m_shift.to(torch.bfloat16)
    _pe_compare(m16, q0)
    for lo in (False, True):
        got = pe.pe_subspace_iterate(m16, q0, iters=16, power_lo=lo)
        wide = pe.pe_subspace_iterate(m16.float(), q0, iters=16,
                                      power_lo=lo)
        assert torch.equal(got, wide)


@pytest.mark.parametrize("n,batch,kernel", [
    (32, 4096, "warp"), (48, 64, "pair"), (64, 4096, "pair"),
    (96, 128, "cluster"), (512, 4, "device")])
def test_jacobi_bf16_v_matches_plain(cuda_device, n, batch, kernel):
    """Kernel 3's bf16-V variant, one shape per kernel (chip_smoke's), 3
    sweeps, a diagonal matrix with repeated eigenvalues first: bit for bit
    the plain version with v_dtype bf16, eigenvalues equal to the f32-V
    launch's, V's entries bf16 values."""
    a = torch.randn(batch, n, n, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(n))
    a = 0.5 * (a + a.transpose(1, 2))
    a[0] = torch.diag(torch.arange(n, device=cuda_device).float() // 2)
    plan = jacobi.jacobi_launch_plan(n, batch, jacobi.cluster_held())
    assert plan["variant"].startswith({"warp": "warp", "pair": "thread",
                                       "cluster": "cluster",
                                       "device": "cluster"}[kernel])
    assert (plan["placement"] == "device") == (kernel == "device")
    before = jacobi.jacobi_eigh.launches
    w, v = jacobi.jacobi_eigh(a, sweeps=3, descending=True,
                              v_dtype="bfloat16")
    assert jacobi.jacobi_eigh.launches == before + 1
    w0, v0 = jacobi.jacobi_eigh_plain(a, sweeps=3, descending=True,
                                      v_dtype="bfloat16")
    assert torch.equal(w, w0) and torch.equal(v, v0)
    w32, _ = jacobi.jacobi_eigh(a, sweeps=3, descending=True)
    assert torch.equal(w, w32)
    assert torch.equal(v, v.to(torch.bfloat16).float())


# ---- Kernel 1: the band and tile paths, degrees from the stored entries --

def _featurize_against_plain(device, edges, meta, n_max, id_bits, dtype,
                             cluster=0):
    """Kernel 1 (its plan's path, or the band path at a forced cluster)
    against the plain version on the same card tensors: adj and deg bit
    for bit; m_shift bit for bit in bf16, within 1e-6 in f32 (rsqrt may
    differ by an ulp; measured 0). One launch counted a call."""
    e = torch.as_tensor(edges, device=device)
    m = torch.as_tensor(meta, device=device)
    before = aggregate.fused_adjacency_featurize.launches
    if cluster:
        got = aggregate._launch(e, m, n_max, id_bits, dtype, cluster)
    else:
        got = aggregate.fused_adjacency_featurize(e, m, n_max, id_bits, dtype)
    assert aggregate.fused_adjacency_featurize.launches == before + 1
    want = aggregate.fused_adjacency_featurize_plain(e, m, n_max, id_bits,
                                                     dtype)
    assert got[0].dtype == got[1].dtype == aggregate.storage_dtype(dtype)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    err = (got[1].float() - want[1].float()).abs().max().item()
    assert err <= (0.0 if dtype == "bfloat16" else 1e-6), err
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire", [heavy_wire, pair_wire_256])
def test_featurize_f1_wires_bit_for_bit(cuda_device, wire, dtype):
    """The two wires where a pair repeats 300 times (N = 512 with 16-bit
    ids: the tile path; N = 256 with 8-bit ids: the band path, a cluster
    of 2): adj, m_shift and deg bit for bit the plain version's in both
    dtypes, the degrees the sums of the stored entries (a bf16 count stops
    at 256)."""
    edges, meta, n_max, id_bits = wire()
    plan = aggregate.featurize_launch_plan(n_max, edges.shape[1], dtype)
    assert plan["path"] == ("tile" if n_max == 512 else "band")
    adj, m_shift, deg = _featurize_against_plain(cuda_device, edges, meta,
                                                 n_max, id_bits, dtype)
    e = torch.as_tensor(edges, device=cuda_device)
    m = torch.as_tensor(meta, device=cuda_device)
    plain_ms = aggregate.fused_adjacency_featurize_plain(e, m, n_max, id_bits,
                                                         dtype)[1]
    assert torch.equal(m_shift, plain_ms)
    lo = dtype == "bfloat16"
    if n_max == 512:
        want = [300.0, 256.0, 0.0, 260.0] if lo else [301.0, 300.0, 0.0,
                                                      259.0]
        assert deg[0, :4].tolist() == want
    else:
        assert deg[0, [0, 1, 3, 255]].tolist() == (
            [255.0, 256.0, 296.0, 256.0] if lo else [255.0, 300.0, 296.0,
                                                     300.0])
    assert adj.float().max().item() == (256.0 if lo else 300.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_max", [100, 240, 250, 17])
def test_featurize_ragged_widths(cuda_device, n_max, dtype):
    """N = 100 (no multiple of 8: 16-byte stores in f32, 8-byte in bf16),
    N = 240 (a cluster of 2 bands of 120 rows, 16-byte stores), N = 250
    (8-byte f32 and 4-byte bf16 stores) and N = 17 (a value a store)."""
    edges, meta = _wire(np.random.default_rng(n_max), 8, 8, n_max, 2048)
    plan = aggregate.featurize_launch_plan(n_max, 2048, dtype)
    assert plan["path"] == "band"
    assert plan["cluster"] == (1 if n_max <= 128 else 2)
    _featurize_against_plain(cuda_device, edges, meta, n_max, 8, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_max", [128, 256])
def test_featurize_one_graph_and_no_edges(cuda_device, n_max, dtype):
    """A batch of one graph, and a graph with no edges (adj 0, deg 0,
    m_shift the identity on its real rows and 0 on the padding)."""
    rng = np.random.default_rng(1)
    u, v = rng.integers(0, 90, 150), rng.integers(0, 90, 150)
    edges = np.zeros((1, 512), np.int32)
    edges[0, :300] = np.stack([u | (v << 8), v | (u << 8)], 1).ravel()
    meta = np.array([[[90], [300], [0]]], np.int32)
    _featurize_against_plain(cuda_device, edges, meta, n_max, 8, dtype)
    meta[0, 1, 0] = 0
    meta[0, 0, 0] = 40
    adj, m_shift, deg = _featurize_against_plain(cuda_device, edges, meta,
                                                 n_max, 8, dtype)
    eye = torch.eye(n_max, device=cuda_device)
    eye[40:] = 0
    assert not adj.any() and not deg.any()
    assert torch.equal(m_shift[0].float(), eye)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_max,cluster", [(256, 1), (256, 4), (128, 2),
                                           (240, 3), (64, 8)])
def test_featurize_band_forced_clusters(cuda_device, n_max, cluster, dtype):
    """The band path at every cluster shape it takes (bands of 256 rows
    down to 8, ragged last bands): the same bits as the plain version."""
    edges, meta = _wire(np.random.default_rng(cluster), 8, 8, n_max, 4096)
    _featurize_against_plain(cuda_device, edges, meta, n_max, 8, dtype,
                             cluster)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_max,e_tot", [(128, 65536), (300, 4096)])
def test_featurize_tile_path(cuda_device, n_max, e_tot, dtype):
    """The tile path where a 16-bit count could overflow (e_tot >= 65536)
    and past N = 256 (N = 300, a scalar tail a row)."""
    id_bits = 8 if n_max <= 256 else 16
    edges, meta = _wire(np.random.default_rng(e_tot), 2, 8, n_max, e_tot,
                        id_bits)
    assert aggregate.featurize_launch_plan(n_max, e_tot)["path"] == "tile"
    _featurize_against_plain(cuda_device, edges, meta, n_max, id_bits, dtype)


def test_featurize_refuses_beyond_2048(cuda_device):
    e = torch.zeros((1, 8), dtype=torch.int32, device=cuda_device)
    m = torch.zeros((1, 3, 1), dtype=torch.int32, device=cuda_device)
    before = aggregate.fused_adjacency_featurize.launches
    with pytest.raises(ValueError, match="n_max=4096"):
        aggregate.fused_adjacency_featurize(e, m, 4096, 16)
    with pytest.raises(TypeError, match="int32"):
        aggregate.fused_adjacency_featurize(e.long(), m, 128, 8)
    assert aggregate.fused_adjacency_featurize.launches == before


def test_featurize_plan_mirrors_the_source(cuda_device):
    """featurize_launch_plan (Python) and gcc_featurize_plan (csrc/
    featurize.cu) agree on every width, wire size, dtype and forced
    cluster, and refuse the same."""
    import ctypes

    lib = aggregate._featurize_lib()
    out = (ctypes.c_int * 10)()
    for n in list(range(1, 300, 7)) + [128, 240, 256, 512, 2047, 2048, 2049]:
        for e_tot in (0, 6656, 65535, 65536):
            for lo, dtype in ((0, "float32"), (1, "bfloat16")):
                for cluster in (0, 1, 2, 3, 8, 9):
                    err = lib.gcc_featurize_plan(n, e_tot, lo, cluster, out)
                    try:
                        plan = aggregate.featurize_launch_plan(n, e_tot, dtype,
                                                               cluster)
                    except ValueError:
                        assert err != 0, (n, e_tot, lo, cluster)
                        continue
                    assert err == 0, (n, e_tot, lo, cluster)
                    assert list(out) == [
                        0 if plan["path"] == "band" else 1, plan["cluster"],
                        plan["rows"], plan["count_bits"], plan["threads"],
                        plan["smem_bytes"], plan["blocks_per_graph"],
                        plan["launches"], plan["store_bytes"],
                        plan["scratch_bytes"]], (n, e_tot, lo, cluster)
