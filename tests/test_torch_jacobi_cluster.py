"""Kernel 3's cluster pair kernel, on the CPU: its launch plan, its tables
and an emulation of its rounds.

``csrc/jacobi.cu``'s ``jacobi_cluster_kernel`` takes every even n from 4 to
832 other than 32, 48, 64 and 80: a thread block cluster of C blocks per
matrix, block b holding the pairs [pstart[b], pstart[b + 1]) and both rows
of each, the rows that cross a range's ends written into the neighbouring
block, each warp reading its pivots from the block holding the pair, one
cluster barrier a round. Here the plan (``jacobi_launch_plan``) is held to
a block's limits and to the H100 table of clusters held at once at every
width and batch, and a numpy/torch emulation that runs the kernel's tables
block by block (per-block row slabs, edge rows sent to the neighbours,
pivots read from the block holding each pair) is held to
``jacobi_eigh_plain`` bit for bit. On the card the kernel itself is held
to the plain version (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from gcc_tpu.ops import jacobi as jx_jacobi  # noqa: E402
from gcc_tpu_torch.ops import jacobi  # noqa: E402

torch.set_num_threads(1)

MAX_SMEM = 232_448      # bytes of shared memory a block may use on Hopper
SMS = 132               # an H100's SMs: one wave of blocks
SHARED_EDGE = 328       # the widest n whose A and V^T a cluster of 8 holds
CLUSTER_WIDTHS = [n for n in range(4, jacobi.MAX_N + 1, 2)
                  if n not in (32, 48, 64, 80)]


def _sym(rng, b, n):
    """Symmetric matrices with eigenvalues spread over [0, 2], neighbours
    at least 1/n apart (as ``tests/test_torch_widths.py``)."""
    lam = np.linspace(0.0, 2.0, n)[None, :] + rng.uniform(0, 0.5 / n, (b, n))
    q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    a = np.einsum("bij,bj,bkj->bik", q, lam, q)
    return ((a + a.transpose(0, 2, 1)) / 2).astype(np.float32)


@pytest.mark.parametrize("batch", [1, 3, 16, 64, 128, 4096])
def test_cluster_plan_fits_at_every_width(batch):
    """Every width the cluster pair kernel takes, at batches from one
    matrix to the training path's 4096: a block's shared memory fits, the
    pair ranges cover 0..h-1 once and contiguously, the batch's clusters
    fill at most one wave (or C is the least that holds the matrix: 1 up
    to n = 118), the placement is shared memory up to n = 328 and the
    device scratch above."""
    for n in CLUSTER_WIDTHS:
        plan = jacobi.jacobi_launch_plan(n, batch)
        h, c = n // 2, plan["cluster"]
        assert plan["variant"] == jacobi.CLUSTER_VARIANT, n
        assert plan["smem_bytes"] <= MAX_SMEM, n
        assert 1 <= c <= min(8, h) and plan["blocks"] == batch * c, n
        assert plan["threads"] % 32 == 0 and 0 < plan["threads"] <= 1024, n
        assert plan["items"] in (2, 3, 4, 6), n
        ranges = plan["pair_ranges"]
        assert len(ranges) == c and ranges[0][0] == 0 and ranges[-1][1] == h
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:])), n
        assert all(0 < stop - start <= jacobi.cluster_pairs(n, c)
                   for start, stop in ranges), n
        assert batch * c <= SMS or c == plan["least_cluster"], n
        if n <= 118:
            assert c == 1 and plan["placement"] == "shared", n
        if n <= SHARED_EDGE:
            assert plan["placement"] == "shared", n
            assert plan["scratch_bytes"] == 0, n
            assert plan["smem_bytes"] > 32 * -(-h // c) * n, n
        else:
            assert plan["placement"] == "device", n
            ld = jacobi.cluster_ld(n, True)
            assert ld % 32 == 0 and plan["scratch_bytes"] == 16 * n * ld, n
            assert plan["smem_bytes"] <= 48 * 1024, n


@pytest.mark.parametrize("n,batch,cluster,placement", [
    (256, 16, 6, "shared"),    # 7 would need 16 clusters of 7: 15 held
    (128, 64, 2, "shared"),
    (120, 64, 2, "shared"),
    (96, 128, 1, "shared"),
    (58, 64, 1, "shared"),
    (256, 4, 8, "shared"),
    (256, 4096, 5, "shared"),  # the least that holds it; many waves
    (512, 4, 8, "device"),
    (832, 64, 2, "device"),
])
def test_cluster_plan_under_the_h100_table(n, batch, cluster, placement):
    """The cluster sizes of the main shapes under the H100's clusters held
    at once (``H100_CLUSTERS_HELD``): the least C whose share fits,
    raised while the batch's clusters fit one wave and the card holds
    them all."""
    plan = jacobi.jacobi_launch_plan(n, batch)
    assert (plan["cluster"], plan["placement"]) == (cluster, placement)
    # a card that held more clusters of 7 would take 7 at (16, 256, 256)
    if (n, batch) == (256, 16):
        held = jacobi.H100_CLUSTERS_HELD[:6] + (16, 15)
        assert jacobi.jacobi_launch_plan(n, batch, held)["cluster"] == 7


@pytest.mark.parametrize("n,first_device", [(118, False), (120, False),
                                            (328, False), (330, True)])
def test_cluster_placement_edge(n, first_device):
    """A block holds the whole matrix up to n = 118; clusters of 2 to 8
    hold A and V^T in shared memory up to n = 328; above, the device
    scratch."""
    least = jacobi.least_cluster(n)
    assert (least == 0) == first_device
    if n == 118:
        assert least == 1
    if n == 120:
        assert least == 2 and jacobi.cluster_smem(120, 1, False) > MAX_SMEM
    if n == 328:
        assert least == 8
        assert jacobi.cluster_smem(330, 8, False) > MAX_SMEM


@pytest.mark.parametrize("n,cluster,ok", [(256, 5, True), (256, 8, True),
                                          (256, 4, False), (256, 9, False),
                                          (512, 1, True), (6, 3, True),
                                          (6, 4, False), (120, 1, False)])
def test_cluster_plan_takes_forced_clusters(n, cluster, ok):
    """A forced cluster is legal from the least that fits to 8 (and at
    most h blocks); the wrapper raises on any other."""
    if ok:
        plan = jacobi.jacobi_launch_plan(n, 4, cluster=cluster)
        assert plan["cluster"] == cluster
        assert plan["smem_bytes"] <= MAX_SMEM
    else:
        with pytest.raises(ValueError, match=f"n={n}"):
            jacobi.jacobi_launch_plan(n, 4, cluster=cluster)


@pytest.mark.parametrize("items,ok", [(2, True), (3, True), (4, True),
                                      (6, True), (5, False), (1, False)])
def test_cluster_plan_takes_forced_items(items, ok):
    if ok:
        plan = jacobi.jacobi_launch_plan(96, 128, items=items)
        assert plan["items"] == items
        assert plan["threads"] <= (1024 if items <= 3 else 512)
    else:
        with pytest.raises(ValueError, match="items"):
            jacobi.jacobi_launch_plan(96, 128, items=items)


@pytest.mark.parametrize("n", [4, 6, 32, 58, 96, 130, 256, 330, 832])
def test_cluster_tables(n):
    """The tables: layout0 and the re-pair destination as the warp and
    pair kernels read them; every position's home is one buffer row of
    one block, the rows of block b's pairs in that block (top rows, then
    bottom rows); rdst = home after the re-pair; the re-pair moves a row
    to its own pair's neighbour, so only a range's end rows cross to
    another block."""
    h = n // 2
    layout0, pi = jacobi.unsorted_tournament(n)
    for cluster in sorted({1, min(3, h), min(8, h)}):
        placement = "shared" if jacobi.least_cluster(n) else "device"
        if placement == "shared" and cluster < jacobi.least_cluster(n):
            continue
        tab = jacobi.cluster_tables(n, cluster, placement)
        lay, cdst, rdst, home = (tab[i * n:(i + 1) * n] for i in range(4))
        pstart = tab[4 * n:]
        assert np.array_equal(lay, layout0)
        assert np.array_equal(cdst[pi], np.arange(n))
        assert np.array_equal(rdst, home[cdst])
        assert len(set(home.tolist())) == n
        rows = jacobi.cluster_pairs(n, cluster)
        for x in range(n):
            b, row = home[x] >> 16, home[x] & 0xFFFF
            pair = x % h
            if placement == "device":
                assert (b, row) == (0, x)
                continue
            assert pstart[b] <= pair < pstart[b + 1]
            assert row == pair - pstart[b] + (rows if x >= h else 0)
        # Rows crossing blocks: only from a range's first or last pair.
        if placement == "shared":
            for x in range(n):
                src, dst = x % h, cdst[x] % h
                bs = np.searchsorted(pstart[:cluster + 1], src, "right") - 1
                bd = rdst[x] >> 16
                assert abs(src - dst) <= 1
                if bd != bs:
                    assert src in (pstart[bs], pstart[bs + 1] - 1)


def emulate_cluster_kernel(t: torch.Tensor, sweeps: int, eps: float,
                           cluster: int, placement: str,
                           descending: bool = True):
    """The cluster pair kernel's rounds on one matrix t (n, n), block by
    block, from its tables: per-block slabs of rows (or one device
    scratch), row mix then column mix of each block's pairs against every
    column pair, the re-paired rows written to the block their rdst names
    (a neighbour for a range's end rows). The rotations come from the
    pivots that each block reads from the block holding each pair.
    Returns (w, v) sorted as the kernel writes them."""
    n = t.shape[-1]
    h = n // 2
    tab = torch.as_tensor(jacobi.cluster_tables(n, cluster, placement)
                          .astype(np.int64))
    lay, cdst, rdst, home = (tab[i * n:(i + 1) * n] for i in range(4))
    pstart = tab[4 * n:4 * n + cluster + 1].tolist()
    pstart[-1] = h
    device = placement == "device"
    rows = n if device else 2 * jacobi.cluster_pairs(n, cluster)
    slabs = 1 if device else cluster
    a_buf = torch.zeros(2, slabs * rows, n)
    v_buf = torch.zeros(2, slabs * rows, n)
    top_rows, bot_rows = [], []
    for b in range(cluster):
        p0, p1 = pstart[b], pstart[b + 1]
        base = 0 if device else b * rows
        top0 = p0 if device else 0
        bot0 = p0 + h if device else rows // 2
        top = base + top0 + torch.arange(p1 - p0)
        bot = base + bot0 + torch.arange(p1 - p0)
        top_rows.append(top)
        bot_rows.append(bot)
        xs = torch.cat([torch.arange(p0, p1), torch.arange(p0, p1) + h])
        a_buf[0, torch.cat([top, bot])] = t[lay[xs]][:, lay]
        v_buf[0, torch.cat([top, bot])] = (
            lay[xs][:, None] == torch.arange(n)[None, :]).float()

    def flat(d):
        return (0 if device else (d >> 16) * rows) + (d & 0xFFFF)

    k0, k1 = cdst[:h], cdst[h:]
    cols = torch.arange(h)
    top_j, bot_j = flat(home[cols]), flat(home[cols + h])
    for r in range(sweeps * (n - 1)):
        par = r & 1
        a, v = a_buf[par], v_buf[par]
        an, vn = a_buf[par ^ 1], v_buf[par ^ 1]
        # Every block reads pair j's pivots from the blocks holding it.
        c, s = jacobi.rotation_cs(a[top_j, cols], a[bot_j, cols + h],
                                  a[top_j, cols + h], eps)
        for b in range(cluster):
            p0, p1 = pstart[b], pstart[b + 1]
            if p1 == p0:
                continue
            top, bot = a[top_rows[b]], a[bot_rows[b]]
            vtop, vbot = v[top_rows[b]], v[bot_rows[b]]
            a00, a01, a10, a11 = top[:, :h], top[:, h:], bot[:, :h], bot[:, h:]
            v00, v01, v10, v11 = (vtop[:, :h], vtop[:, h:], vbot[:, :h],
                                  vbot[:, h:])
            ca, sa = c[p0:p1, None], s[p0:p1, None]
            cb, sb = c[None, :], s[None, :]
            r00 = ca * a00 - sa * a10
            r01 = ca * a01 - sa * a11
            r10 = sa * a00 + ca * a10
            r11 = sa * a01 + ca * a11
            o00 = cb * r00 - sb * r01
            o01 = sb * r00 + cb * r01
            o10 = cb * r10 - sb * r11
            o11 = sb * r10 + cb * r11
            x0 = torch.arange(p0, p1)
            f0, f1 = flat(rdst[x0])[:, None], flat(rdst[x0 + h])[:, None]
            an[f0, k0[None, :]] = o00
            an[f0, k1[None, :]] = o01
            an[f1, k0[None, :]] = o10
            an[f1, k1[None, :]] = o11
            vn[f0, cols[None, :]] = ca * v00 - sa * v10
            vn[f1, cols[None, :]] = sa * v00 + ca * v10
            vn[f0, cols[None, :] + h] = ca * v01 - sa * v11
            vn[f1, cols[None, :] + h] = sa * v01 + ca * v11
    a, v = a_buf[sweeps * (n - 1) & 1], v_buf[sweeps * (n - 1) & 1]
    x = torch.arange(n)
    at_home = flat(home)
    diag = a[at_home, x]
    vt = v[at_home]
    inv = torch.empty_like(lay)
    inv[lay] = x
    return jacobi.sort_eig(diag[inv], vt.T[:, inv], descending)


EMULATED = [(6, 1, "shared"), (6, 2, "shared"), (6, 3, "shared"),
            (58, 1, "shared"), (58, 2, "shared"), (58, 3, "shared"),
            (58, 6, "shared"), (58, 8, "shared"),
            (96, 1, "shared"), (96, 2, "shared"), (96, 3, "shared"),
            (96, 6, "shared"), (96, 8, "shared"),
            (130, 2, "shared"), (130, 3, "shared"), (130, 6, "shared"),
            (130, 8, "shared"), (256, 6, "shared"), (256, 8, "shared"),
            (58, 3, "device"), (130, 8, "device"),
            (6, 3, "device"), (58, 8, "device"), (96, 4, "shared"),
            (130, 4, "shared"), (256, 7, "shared"), (256, 8, "device")]


@pytest.mark.parametrize("n,cluster,placement", EMULATED)
def test_cluster_emulation_matches_plain(n, cluster, placement):
    """The kernel's schedule over its tables equals ``jacobi_eigh_plain``
    bit for bit: the same rotations, row mix, column mix and re-pair, only
    split over blocks, each pivot read from the block holding it. A
    diagonal block of repeated eigenvalues (identity rotations, the sort's
    tie rule) rides in the same matrix set."""
    assert placement == "device" or cluster >= jacobi.least_cluster(n)
    sweeps = 1 if n > 130 else 2
    rng = np.random.default_rng(n + cluster)
    mats = [_sym(rng, 1, n)[0]]
    if n <= 96:
        mats.append(np.diag(np.arange(n) // 2).astype(np.float32))
    for a in mats:
        t = torch.as_tensor(a)
        w, v = emulate_cluster_kernel(t, sweeps, 1e-12, cluster, placement)
        w0, v0 = jacobi.jacobi_eigh_plain(t[None], sweeps, 1e-12,
                                          descending=True)
        assert torch.equal(w, w0[0]) and torch.equal(v, v0[0])


@pytest.mark.parametrize("n", [58, 96])
def test_jacobi_plain_matches_jax_at_cluster_widths(n):
    """Kernel 3's plain version against ``gcc_tpu.ops.jacobi.jacobi_eigh``
    at two widths of the cluster pair kernel (n = 58: h = 29, odd; n = 96,
    PE 80's guarded finish): eigenvalues and eigenvectors within 1e-5,
    both orders, the limit at n = 120 and 128
    (``tests/test_torch_widths.py``)."""
    a = _sym(np.random.default_rng(n), 2, n)
    w_u, v_u = jx_jacobi.jacobi_eigh(jnp.asarray(a), sweeps=3, sort=False)
    for desc in (False, True):
        w_j, v_j = jx_jacobi._sort_eig(w_u, v_u, n, desc)
        w_p, v_p = jacobi.jacobi_eigh(torch.as_tensor(a), sweeps=3,
                                      descending=desc)
        np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(v_p.numpy(), np.asarray(v_j), rtol=0,
                                   atol=1e-5)
