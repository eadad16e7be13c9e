"""The positional embedding at PE 64 — Kernel 2 at k = 64 and 80, Kernel
3 at n = 64 and 80 — on the CPU: the kernels' plain versions against the
reference's (its Jacobi, its Pallas PE kernel in interpret mode), and the
port's PE at pos 64 on the train and eval profiles against the
reference's. On the card the kernels are held against these plain
versions (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

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

torch.set_num_threads(1)


def _sym(rng, b, n):
    """Symmetric matrices with eigenvalues spread over [0, 2], neighbours
    at least 1/n apart (as ``tests/test_torch_ops.py``)."""
    lam = np.linspace(0.0, 2.0, n)[None, :] + rng.uniform(0, 0.5 / n, (b, n))
    q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    a = np.einsum("bij,bj,bkj->bik", q, lam, q)
    return ((a + a.transpose(0, 2, 1)) / 2).astype(np.float32)


@pytest.mark.parametrize("n", [64, 80])
def test_jacobi_plain_matches_jax_at_pe64_widths(n):
    """Kernel 3's plain version against ``gcc_tpu.ops.jacobi.jacobi_eigh``
    at the widths PE 64 needs (n = 64 on the train profile, 80 with the
    eval profile's guards): eigenvalues and eigenvectors within 1e-5,
    both orders, the same limit as at n = 8 and 32."""
    a = _sym(np.random.default_rng(n), 3, n)
    w_u, v_u = jx_jacobi.jacobi_eigh(jnp.asarray(a), sweeps=3, sort=False)
    for desc in (False, True):
        w_j, v_j = jx_jacobi._sort_eig(w_u, v_u, n, desc)
        w_p, v_p = jacobi.jacobi_eigh(torch.as_tensor(a), sweeps=3,
                                      descending=desc)
        np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(v_p.numpy(), np.asarray(v_j), rtol=0,
                                   atol=1e-5)


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


@pytest.mark.parametrize("k", [64, 80])
def test_pe_plain_matches_pallas_interpret_at_pe64_widths(k):
    """Kernel 2's plain version against ``pe_subspace_iterate`` in
    interpret mode at k = 64 (train) and 80 (eval): f32 rounds within
    1e-5; production bf16 rounds within 1e-2 elementwise, 1e-3 on the
    mean, projectors within 5e-3 (``tests/test_torch_ops.py``'s limits
    at k = 8)."""
    adj, mask, sizes = _ring_graphs((100, 128), 128)
    node_mask = torch.as_tensor(mask)
    from gcc_tpu_torch.ops.aggregate import (
        normalized_adjacency,
        shifted_operator,
    )
    m_shift = shifted_operator(
        normalized_adjacency(torch.as_tensor(adj), node_mask), node_mask)
    q0 = subspace_start(128, k, node_mask)
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


def _port_pe(adj, mask, sizes, profile, **kw):
    return laplacian_positional_embedding(
        torch.as_tensor(mask), torch.as_tensor(sizes), 64,
        adj=torch.as_tensor(adj), method="subspace", profile=profile,
        **kw).numpy()


@pytest.mark.parametrize("profile,sizes", [("train", (64, 90, 128)),
                                           ("eval", (80, 100, 128))])
def test_pe64_matches_reference(profile, sizes, monkeypatch):
    """``laplacian_positional_embedding`` at pos 64 on the train profile
    (k = 64) and the eval profile (k = 80), port against reference, both
    with the exact Rayleigh–Ritz finish (``rr="eigh"`` /
    ``GCC_TPU_PE_RR=eigh``, as ``tests/test_torch_generate.py`` compares
    the eval profile at k = 48).

    Held by the row cosines pos·posᵀ (the projector onto the embedding's
    span, row-normalized): mean within 1e-3, Kernel 2's mean limit
    against the reference (``tests/test_torch_ops.py``), and max within
    2e-2, its bf16 max and the limit of the subspace generate test at k =
    48 (``tests/test_torch_generate.py``), since what differs is the bf16
    rounding inside the iteration (measured: mean 4.3e-4, max 7.8e-3 on
    the eval profile); the same rows and columns are zero. Columns are
    not compared one by one: a graph whose top 65 eigenvalues are all
    0.02 apart is the Ehrenfest urn, whose binomial degrees (1e27 at 96
    nodes) leave f32, and on these graphs near-degenerate Ritz vectors
    rotate within their span.

    The train profile's production finish (Kernel 3 at n = 64, 3 sweeps)
    also meets the exact finish to mean 1e-5, max 1e-4 here; the eval
    profile's is held in the next test."""
    monkeypatch.setenv("GCC_TPU_PE_PALLAS", "interpret")
    monkeypatch.setenv("GCC_TPU_PE_RR", "eigh")
    adj, mask, sizes = _ring_graphs(sizes, 128)
    want = np.asarray(jax.jit(lambda a, m, n: jx_pe_embed(
        _MaskBatch(node_mask=m, n_nodes=n), 64, adj=a, method="subspace",
        profile=profile))(jnp.asarray(adj), jnp.asarray(mask),
                          jnp.asarray(sizes)))
    exact = _port_pe(adj, mask, sizes, profile, rr="eigh")
    assert exact.shape == want.shape == (3, 128, 64)
    assert np.isfinite(exact).all()
    np.testing.assert_array_equal(np.abs(exact).sum(axis=1) > 0,
                                  np.abs(want).sum(axis=1) > 0)
    np.testing.assert_array_equal(np.abs(exact).sum(axis=2) > 0,
                                  np.abs(want).sum(axis=2) > 0)
    d = np.abs(_row_cosines(exact) - _row_cosines(want))
    assert d.mean() <= 1e-3 and d.max() <= 2e-2, (d.mean(), d.max())
    if profile == "train":
        d = np.abs(_row_cosines(_port_pe(adj, mask, sizes, profile))
                   - _row_cosines(exact))
        assert d.mean() <= 1e-5 and d.max() <= 1e-4, (d.mean(), d.max())


def test_eval_finish_at_80_columns_converges_with_sweeps():
    """The eval profile at pos 64 finishes on an 80-wide block (Kernel 3
    at n = 80, twice). The default 3 sweeps (``RR_SWEEPS``, the
    reference's ``GCC_TPU_PE_RR_SWEEPS``) are not converged there: the
    row cosines move from the exact finish's by a mean above 1e-3, and 5
    sweeps bring them several times closer. Both packages run the same
    sweeps (the port's Jacobi is held to the reference's above), so this
    is recorded, not changed, as at n = 48."""
    adj, mask, sizes = _ring_graphs((80, 100, 128), 128)
    exact = _row_cosines(_port_pe(adj, mask, sizes, "eval", rr="eigh"))
    d3 = np.abs(_row_cosines(_port_pe(adj, mask, sizes, "eval")) - exact)
    d5 = np.abs(_row_cosines(_port_pe(adj, mask, sizes, "eval",
                                      rr_sweeps=5)) - exact)
    assert d3.mean() > 1e-3
    assert d5.mean() < d3.mean() / 3
