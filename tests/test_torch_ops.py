"""Plain PyTorch versions of the port's three kernels vs the JAX package.

Each kernel of ``gcc_tpu_torch/ops`` has a plain PyTorch version that
its wrapper runs on CPU tensors (and that chip_smoke.py holds the CUDA
kernel against on the card). Here the same numpy inputs go through the
plain version and through the JAX function it ports — the XLA
formulation and the Pallas kernel in interpret mode.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from gcc_tpu.features.featurize import _MaskBatch  # noqa: E402
from gcc_tpu.features.positional import normalized_adjacency  # noqa: E402
from gcc_tpu.ops import jacobi as jx_jacobi  # noqa: E402
from gcc_tpu.ops.aggregate import (  # noqa: E402
    build_dense_adjacency_compact,
    node_degrees,
)
from gcc_tpu.ops.featurize_pallas import fused_adjacency_featurize  # noqa: E402
from gcc_tpu.ops.jacobi_pallas import jacobi_eigh_tpu  # noqa: E402
from gcc_tpu.ops.pe_pallas import pe_subspace_iterate as jx_pe  # noqa: E402
from gcc_tpu_torch.features.positional import subspace_start  # noqa: E402
from gcc_tpu_torch.ops import aggregate, jacobi, pe  # noqa: E402

torch.set_num_threads(1)


def random_wire(rng, s, b, n_max, e_tot, zero_edge=True, full=False):
    """Stacked compact wire segments with stale tail bytes: (edges
    (S, E_tot) uint16 or int32, meta (S, 3, B) int32, id_bits)."""
    id_bits = 8 if n_max <= 256 else 16
    dt = np.uint16 if id_bits == 8 else np.int32
    edges = np.full((s, e_tot), np.iinfo(dt).max, dt)
    meta = np.zeros((s, 3, b), np.int32)
    for i in range(s):
        n = rng.integers(1, n_max + 1, b).astype(np.int32)
        e = rng.integers(0, e_tot // b, b).astype(np.int32)
        if zero_edge and i == 0:
            e[0] = 0
        if full and i == s - 1:
            e[-1] = e_tot - int(e[:-1].sum())  # the segment fills e_tot
        src = np.concatenate([rng.integers(0, n[j], e[j]) for j in range(b)])
        dst = np.concatenate([rng.integers(0, n[j], e[j]) for j in range(b)])
        packed = src.astype(np.int64) | (dst.astype(np.int64) << id_bits)
        edges[i, : packed.size] = packed.astype(dt)
        meta[i] = np.stack([n, e, rng.integers(0, n)])
    return edges, meta, id_bits


def _jax_chain(edges, meta, n_max, id_bits):
    """JAX featurize chain: build_dense_adjacency_compact, node_degrees,
    normalized_adjacency (scaling and -2 padding pin), then
    _subspace_topk's +pad+I shift (features/positional.py:199-206)."""
    adj = build_dense_adjacency_compact(
        jnp.asarray(edges), jnp.asarray(meta[:, 1, :]), n_max, id_bits)
    n_nodes = meta[:, 0, :].reshape(-1)
    mask = (np.arange(n_max)[None, :] < n_nodes[:, None]).astype(np.float32)
    batch = _MaskBatch(node_mask=jnp.asarray(mask),
                       n_nodes=jnp.asarray(n_nodes))
    m = np.asarray(normalized_adjacency(batch, adj))
    eye = np.eye(n_max, dtype=np.float32)
    pad = 1.0 - mask
    return (np.asarray(adj), np.asarray(node_degrees(batch, adj)),
            m + pad[:, :, None] * eye + eye, mask)


def _port_featurize(edges, meta, n_max, id_bits):
    e = torch.as_tensor(edges.astype(np.int64) & 0xFFFFFFFF).to(torch.int32)
    out = aggregate.fused_adjacency_featurize(
        e, torch.as_tensor(meta), n_max, id_bits)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("n_max,s,b,e_tot,full", [
    (16, 3, 4, 64, False),
    (64, 3, 4, 256, True),
    (300, 2, 2, 512, True),      # id_bits 16 packing
])
def test_featurize_plain_matches_xla_chain(n_max, s, b, e_tot, full):
    """Kernel 1's plain version vs the XLA chain: adjacency and degrees
    exact (integer counts in f32), m_shift within 1e-6 (the same f32
    products; rsqrt vs 1/sqrt may differ by an ulp)."""
    rng = np.random.default_rng(n_max)
    edges, meta, id_bits = random_wire(rng, s, b, n_max, e_tot, full=full)
    adj, m_shift, deg = _port_featurize(edges, meta, n_max, id_bits)
    want_adj, want_deg, want_ms, _ = _jax_chain(edges, meta, n_max, id_bits)
    np.testing.assert_array_equal(adj, want_adj)
    np.testing.assert_array_equal(deg, want_deg)
    np.testing.assert_allclose(m_shift, want_ms, rtol=0, atol=1e-6)
    assert want_adj[0].sum() == 0  # the zero-edge graph


def test_featurize_plain_matches_pallas_interpret():
    """Kernel 1's plain version vs the Pallas kernel it replaces
    (interpret mode), N = 64 <= 128 with a zero-edge graph and a full
    segment: adjacency and degrees exact, m_shift within 1e-6."""
    rng = np.random.default_rng(11)
    n_max, s, b, e_tot = 64, 3, 4, 256
    edges, meta, id_bits = random_wire(rng, s, b, n_max, e_tot, full=True)
    _, _, _, mask = _jax_chain(edges, meta, n_max, id_bits)
    e_cap = int(meta[:, 1, :].max())
    adj, ms, deg = fused_adjacency_featurize(
        jnp.asarray(edges), jnp.asarray(meta), jnp.asarray(mask), n_max,
        e_cap, interpret=True)
    p_adj, p_ms, p_deg = _port_featurize(edges, meta, n_max, id_bits)
    np.testing.assert_array_equal(p_adj, np.asarray(adj))
    np.testing.assert_array_equal(p_deg, np.asarray(deg))
    np.testing.assert_allclose(p_ms, np.asarray(ms), rtol=0, atol=1e-6)


def _sym(rng, b, n):
    """Random symmetric matrices Q diag(λ) Qᵀ with λ spread over [0, 2]
    (the Rayleigh-Ritz matrices' range), neighbours >= 1/n apart. An
    eigenvector's f32 rounding error grows as ulp / gap, so with a gap
    floor an absolute 1e-5 bounds rounding, not conditioning."""
    lam = np.linspace(0.0, 2.0, n)[None, :] + rng.uniform(0, 0.5 / n, (b, n))
    q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    a = np.einsum("bij,bj,bkj->bik", q, lam, q)
    return ((a + a.transpose(0, 2, 1)) / 2).astype(np.float32)


@pytest.mark.parametrize("layout", ["lane", "bm"])
@pytest.mark.parametrize("sweeps", [3, 5])
def test_jacobi_plain_matches_jax(layout, sweeps):
    """Kernel 3's plain version vs gcc_tpu.ops.jacobi.jacobi_eigh: the
    same rounds, so eigenvalues AND eigenvectors agree within 1e-5 abs
    (f32 rounding of the rotations), column order included, ascending
    and descending, at n = 8 and 32."""
    rng = np.random.default_rng(sweeps)
    for n in (8, 32):
        a = _sym(rng, 4, n)
        w_u, v_u = jx_jacobi.jacobi_eigh(jnp.asarray(a), sweeps=sweeps,
                                         sort=False, layout=layout)
        for desc in (False, True):
            w_j, v_j = jx_jacobi._sort_eig(w_u, v_u, n, desc)
            w_p, v_p = jacobi.jacobi_eigh(torch.as_tensor(a), sweeps=sweeps,
                                          descending=desc)
            np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j),
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(v_p.numpy(), np.asarray(v_j),
                                       rtol=0, atol=1e-5)


def test_jacobi_plain_matches_pallas_interpret():
    """Kernel 3's plain version vs jacobi_eigh_tpu (the Pallas kernel,
    interpret mode) at n = 8: within 1e-5 abs."""
    a = _sym(np.random.default_rng(4), 6, 8)
    for desc in (False, True):
        w_j, v_j = jacobi_eigh_tpu(jnp.asarray(a), sweeps=5,
                                   descending=desc, interpret=True)
        w_p, v_p = jacobi.jacobi_eigh(torch.as_tensor(a), sweeps=5,
                                      descending=desc)
        np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j), atol=1e-5)
        np.testing.assert_allclose(v_p.numpy(), np.asarray(v_j), atol=1e-5)


def test_jacobi_plain_matches_numpy_eigh():
    """At 5 sweeps the Jacobi eigendecomposition converges to f32
    working precision: eigenvalues within 1e-5 of numpy's in the same
    order, eigenvectors equal up to sign (|cos| within 1e-5 of 1)."""
    rng = np.random.default_rng(7)
    for n in (8, 32):
        a = _sym(rng, 8, n)
        w_p, v_p = jacobi.jacobi_eigh(torch.as_tensor(a), sweeps=5)
        w_n, v_n = np.linalg.eigh(a.astype(np.float64))
        np.testing.assert_allclose(w_p.numpy(), w_n, rtol=0, atol=1e-5)
        cos = np.abs(np.einsum("bij,bij->bj", v_p.numpy(), v_n))
        np.testing.assert_allclose(cos, 1.0, rtol=0, atol=1e-5)


def _pe_inputs(rng, b, n_max, k):
    """m_shift of b random connected symmetric graphs (a ring plus random
    chords) of 4k to n_max nodes, and the masked, column-normalized start
    basis. With the leading k eigenvalues well clear of the bottom of the
    shifted spectrum the fixed-step iteration returns an orthonormal
    basis; smaller or disconnected graphs can leave it rank-deficient
    (positional.py handles that downstream) in JAX and in the port
    alike."""
    n = rng.integers(4 * k, n_max + 1, b).astype(np.int32)
    src, dst, counts = [], [], []
    for j in range(b):
        ring = np.arange(n[j])
        u = np.concatenate([ring, rng.integers(0, n[j], 2 * n[j])])
        v = np.concatenate([(ring + 1) % n[j],
                            rng.integers(0, n[j], 2 * n[j])])
        src += [u, v]
        dst += [v, u]
        counts.append(2 * u.size)
    src, dst = np.concatenate(src), np.concatenate(dst)
    edges = (src | (dst << 8)).astype(np.uint16)[None]
    meta = np.stack([n, np.asarray(counts, np.int32),
                     np.zeros(b, np.int32)])[None]
    _, m_shift, _ = _port_featurize(edges, meta, n_max, 8)
    mask = aggregate.node_mask_from_meta(torch.as_tensor(meta), n_max)
    return torch.as_tensor(m_shift), subspace_start(n_max, k, mask)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pe_plain_matches_pallas_interpret(seed):
    """Kernel 2's plain version vs pe_subspace_iterate in interpret mode.

    f32 rounds (power_dtype f32): the same arithmetic up to the order of
    f32 sums — elementwise within 1e-5. Production settings (bf16 rounds,
    iters 16, orth 4, ns 4, polish 2, final_ns 8): both round the same
    values to bf16, but a sum that differs in its last f32 bit can round
    to the neighbouring bf16 value, a 2^-8 relative step that the
    iteration carries on — elementwise within
    1e-2, mean within 1e-3, spanned subspaces (projectors QQᵀ) within
    5e-3. Every basis is orthonormal to 1e-3."""
    rng = np.random.default_rng(seed)
    m_shift, q0 = _pe_inputs(rng, 3, 64, 8)
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
    for q in (got, want, got32):
        gram = np.einsum("bnk,bnj->bkj", q, q)
        assert np.abs(gram - np.eye(q.shape[2])).max() <= 1e-3
