"""Kernels 2 and 3 at every width the reference computes, on the CPU.

Kernel 2 takes 80 < k <= 832 under its "general" plan and Kernel 3 every
even n up to 832 (A and Vᵀ in device memory above n = 118). Here their
plain versions are held against the reference at the first such widths
(Jacobi at n = 120 and 128, Kernel 2 at k = 96, the whole PE at pos 112
on the eval profile, k = 128), and the launch plans of the new widths
are checked against a block's limits. On the card the kernels are held
against these plain versions (``tests/test_torch_cuda.py``,
``chip_smoke.py``'s "wide widths" phase)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from gcc_tpu.features.featurize import _MaskBatch  # noqa: E402
from gcc_tpu.features.positional import (  # noqa: E402
    laplacian_positional_embedding as jx_pe_embed,
)
from gcc_tpu.ops import jacobi as jx_jacobi  # noqa: E402
from gcc_tpu.ops.pe_pallas import pe_subspace_iterate as jx_pe  # noqa: E402
from gcc_tpu_torch.features.positional import (  # noqa: E402
    laplacian_positional_embedding,
    subspace_start,
)
from gcc_tpu_torch.ops import jacobi, pe  # noqa: E402
from gcc_tpu_torch.ops.aggregate import (  # noqa: E402
    normalized_adjacency,
    shifted_operator,
)

torch.set_num_threads(1)

MAX_SMEM = 232_448      # bytes of shared memory a block may use on Hopper
POS_WIDE = 112          # PE 112: k = 128 with the eval profile's 16 guards


def _sym(rng, b, n):
    """Symmetric matrices with eigenvalues spread over [0, 2], neighbours
    at least 1/n apart (as ``tests/test_torch_wide_pe.py``)."""
    lam = np.linspace(0.0, 2.0, n)[None, :] + rng.uniform(0, 0.5 / n, (b, n))
    q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    a = np.einsum("bij,bj,bkj->bik", q, lam, q)
    return ((a + a.transpose(0, 2, 1)) / 2).astype(np.float32)


def _ring_graphs(sizes, n_max, seed=0):
    """Rings plus n chords (both directions of every edge) in an n_max
    bucket: adjacency, node mask, node counts."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((len(sizes), n_max, n_max), np.float32)
    mask = np.zeros((len(sizes), n_max), np.float32)
    for g, n in enumerate(sizes):
        ring = np.arange(n)
        extra = rng.integers(0, n, (2, n))
        u = np.concatenate([ring, extra[0]])
        v = np.concatenate([(ring + 1) % n, extra[1]])
        keep = u != v
        np.add.at(adj[g], (v[keep], u[keep]), 1.0)
        np.add.at(adj[g], (u[keep], v[keep]), 1.0)
        mask[g, :n] = 1.0
    return adj, mask, np.asarray(sizes, np.int32)


@pytest.mark.parametrize("n", [120, 128])
def test_jacobi_plain_matches_jax_beyond_118(n):
    """Kernel 3's plain version against ``gcc_tpu.ops.jacobi.jacobi_eigh``
    at the first widths of the device-memory variant (n = 120, the first
    whose A and Vᵀ pass a block's shared memory; 128, PE 112's guarded
    finish): eigenvalues and eigenvectors within 1e-5, both orders, the
    limit of ``tests/test_torch_wide_pe.py`` at n = 64 and 80."""
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


def test_pe_plain_matches_pallas_interpret_at_k96():
    """Kernel 2's plain version against ``pe_subspace_iterate`` in
    interpret mode at k = 96 (PE 80 with the eval profile's 16 guards,
    the general plan's first width) on 2 graphs in a 128 bucket: f32
    rounds within 1e-5; production bf16 rounds within 1e-2 elementwise,
    1e-3 on the mean, projectors within 5e-3 (the limits of
    ``tests/test_torch_wide_pe.py`` at k = 64 and 80)."""
    adj, mask, _ = _ring_graphs((110, 128), 128, seed=3)
    node_mask = torch.as_tensor(mask)
    m_shift = shifted_operator(
        normalized_adjacency(torch.as_tensor(adj), node_mask), node_mask)
    q0 = subspace_start(128, 96, node_mask)
    jm, jq = jnp.asarray(m_shift.numpy()), jnp.asarray(q0.numpy())
    got32 = pe.pe_subspace_iterate(m_shift, q0, iters=16,
                                   power_lo=False).numpy()
    want32 = np.asarray(jx_pe(jm, jq, iters=16, power_dtype=jnp.float32,
                              interpret=True))
    np.testing.assert_allclose(got32, want32, rtol=0, atol=1e-5)
    got = pe.pe_subspace_iterate(m_shift, q0, iters=16).numpy()
    want = np.asarray(jx_pe(jm, jq, iters=16, interpret=True))
    diff = np.abs(got - want)
    assert diff.max() <= 1e-2 and diff.mean() <= 1e-3, (diff.max(),
                                                        diff.mean())
    proj = lambda q: np.einsum("bnk,bmk->bnm", q, q)  # noqa: E731
    assert np.abs(proj(got) - proj(want)).max() <= 5e-3


def _row_cosines(pos):
    return np.einsum("bnk,bmk->bnm", pos, pos)


def test_pe112_eval_profile_matches_reference(monkeypatch):
    """``laplacian_positional_embedding`` at pos 112 on the eval profile
    (k = min(N, 112 + 16) = 128 in a 256 bucket: Kernel 2's general plan,
    Kernel 3 at n = 128), port against reference, both with the exact
    Rayleigh–Ritz finish, held by the row cosines as
    ``test_pe64_matches_reference`` holds pos 64: mean within 1e-3, max
    within 2e-2; the same rows and columns are zero."""
    monkeypatch.setenv("GCC_TPU_PE_PALLAS", "interpret")
    monkeypatch.setenv("GCC_TPU_PE_RR", "eigh")
    adj, mask, sizes = _ring_graphs((150, 200, 256), 256, seed=5)
    want = np.asarray(jax.jit(lambda a, m, n: jx_pe_embed(
        _MaskBatch(node_mask=m, n_nodes=n), POS_WIDE, adj=a,
        method="subspace", profile="eval"))(
            jnp.asarray(adj), jnp.asarray(mask), jnp.asarray(sizes)))
    got = laplacian_positional_embedding(
        torch.as_tensor(mask), torch.as_tensor(sizes), POS_WIDE,
        adj=torch.as_tensor(adj), method="subspace", profile="eval",
        rr="eigh").numpy()
    assert got.shape == want.shape == (3, 256, POS_WIDE)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(np.abs(got).sum(axis=1) > 0,
                                  np.abs(want).sum(axis=1) > 0)
    np.testing.assert_array_equal(np.abs(got).sum(axis=2) > 0,
                                  np.abs(want).sum(axis=2) > 0)
    d = np.abs(_row_cosines(got) - _row_cosines(want))
    assert d.mean() <= 1e-3 and d.max() <= 2e-2, (d.mean(), d.max())


@pytest.mark.parametrize("n,k,plan", [
    (128, 48, "shared"), (512, 48, "streamed"),
    (128, 49, "wide"), (832, 80, "wide"),
    (128, 81, "general"), (832, 96, "general"), (32, 832, "general"),
    (832, 832, "general"),
])
def test_pe_plan_names_by_width(n, k, plan):
    """k <= 48: "shared" / "streamed"; 48 < k <= 80: "wide"; 80 < k <=
    832: "general", at every N <= 832."""
    assert pe.pe_launch_plan(n, k)["plan"] == plan


@pytest.mark.parametrize("batch", [1, 16, 64, 128, 4096])
@pytest.mark.parametrize("k", [81, 96, 128, 240, 241, 256, 832])
@pytest.mark.parametrize("n", [32, 128, 256, 288, 512, 832])
def test_pe_general_plan_fits_a_block(n, k, batch):
    """A cluster of 1 to 8 blocks per graph (8 the portable size): the
    most whose batch x cluster blocks fill one wave of the H100's 132 SMs
    and whose batch of clusters the card holds at once (15 clusters of 8
    blocks, 17 of 6): 8 at a batch of 1, 6 at 16, 2 at 64, 1 at 128.
    Blocks of whole warps within 1024
    threads and 232,448 B of shared memory; in the device scratch bf16 M,
    f32 and bf16 Q (each double-buffered), f32 G (two) and bf16 G, the
    partial sums of squares and the blocks' extents; the 128 x 64 tiles of
    a power step dealt to the blocks round robin."""
    p = pe.pe_launch_plan(n, k, batch)
    kp, c = p["kp"], p["cluster"]
    assert p["plan"] == "general" and p["layout"] == "device"
    assert 0 <= kp - k < 16 and kp % 16 == 0 and p["n_pad"] == n
    assert p["threads"] % 32 == 0 and p["threads"] <= 1024
    assert p["threads"] == 32 * p["warps"]
    assert 0 < p["smem_bytes"] <= MAX_SMEM
    held = pe.H100_CLUSTERS_HELD
    fits = lambda c: batch * c <= 132 and batch <= held[c - 1]  # noqa: E731
    assert 1 <= c <= 8
    assert c == 1 or fits(c)                  # one wave, held at once
    assert c == 8 or not fits(c + 1)          # and no larger cluster is
    assert c == {1: 8, 16: 6, 64: 2, 128: 1, 4096: 1}[batch]
    part = -(-n // 128) * kp * 8
    assert p["scratch_bytes"] == (2 * n * n + 12 * n * kp + 10 * kp * kp
                                  + -(-part // 256) * 256 + 256)
    assert p["scratch_bytes"] % 256 == 0
    tiles = -(-n // 128) * -(-kp // 64)
    assert sum(p["block_slabs"]) == tiles and len(p["block_slabs"]) == c
    assert max(p["block_slabs"]) == p["slabs_per_block"] == -(-tiles // c)


@pytest.mark.parametrize("n,k", [(864, 96), (832, 833), (896, 832),
                                 (128, 1000)])
def test_pe_plan_refuses_beyond_832(n, k):
    with pytest.raises(ValueError, match=f"N={n}, k={k}"):
        pe.pe_launch_plan(n, k)


@pytest.mark.parametrize("n", [120, 122, 128, 256, 500, 832])
def test_jacobi_device_plan(n):
    """Even n from 120 to 832, where A and Vᵀ pass one block's shared
    memory: the cluster pair kernel on a cluster of blocks a matrix, A and
    Vᵀ in the blocks' shared memory up to n = 328 (the least cluster that
    holds them, raised to fill one wave: 2 blocks at a batch of 64 from n =
    120 to 164), in a device scratch of 16 n·LD bytes a matrix above;
    118 is the last on one block."""
    plan = jacobi.jacobi_launch_plan(n, batch=64)
    assert plan["variant"] == jacobi.CLUSTER_VARIANT
    assert plan["cluster"] >= 2 and plan["blocks"] == 64 * plan["cluster"]
    assert 0 < plan["smem_bytes"] <= MAX_SMEM
    assert jacobi.cluster_smem(n, 1, False) > MAX_SMEM
    if n <= 328:
        assert plan["placement"] == "shared" and plan["scratch_bytes"] == 0
        assert plan["cluster"] == jacobi.least_cluster(n)
    else:
        assert plan["placement"] == "device"
        assert plan["scratch_bytes"] == 16 * n * jacobi.cluster_ld(n, True)
        assert plan["smem_bytes"] <= 48 * 1024
    last = jacobi.jacobi_launch_plan(118)
    assert last["cluster"] == 1 and last["placement"] == "shared"
    assert last["smem_bytes"] <= MAX_SMEM and last["scratch_bytes"] == 0


@pytest.mark.parametrize("n", [834, 864, 121, 833])
def test_jacobi_plan_refuses_beyond_832(n):
    with pytest.raises(ValueError, match=f"n={n}"):
        jacobi.jacobi_launch_plan(n)
    with pytest.raises(ValueError, match=str(n)):
        jacobi._check_input(torch.zeros(1, n, n))
