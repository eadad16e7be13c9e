"""Embedding generation of the port vs gcc_tpu's: the same numpy
subgraphs and bridged weights through both ``generate_embeddings``, the
readouts, and the eval-profile featurization (CPU: the kernels' plain
versions; JAX with its Pallas PE kernel in interpret mode)."""

from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from gcc_tpu import generate as jx_generate  # noqa: E402
from gcc_tpu.config import (  # noqa: E402
    EncoderConfig as JxEncoderConfig,
    TrainConfig as JxTrainConfig,
)
from gcc_tpu.features.featurize import featurize_batch as jx_featurize_batch  # noqa: E402
from gcc_tpu.graph.batch import (  # noqa: E402
    Subgraph as JxSubgraph,
    batch_subgraphs as jx_batch_subgraphs,
)
from gcc_tpu.models import GraphEncoder as JxEncoder  # noqa: E402
from gcc_tpu_torch import generate  # noqa: E402
from gcc_tpu_torch.compat import flax_to_state_dict  # noqa: E402
from gcc_tpu_torch.config import EncoderConfig, TrainConfig  # noqa: E402
from gcc_tpu_torch.features.featurize import featurize_batch  # noqa: E402
from gcc_tpu_torch.features.positional import (  # noqa: E402
    laplacian_positional_embedding,
)
from gcc_tpu_torch.graph.batch import Subgraph, batch_subgraphs  # noqa: E402
from gcc_tpu_torch.graph.csr import CSRGraph  # noqa: E402
from gcc_tpu_torch.models import GraphEncoder  # noqa: E402

torch.set_num_threads(1)

N_MAX, E_MAX, POS = 32, 512, 8
ENC = dict(num_layers=2, hidden_size=16, output_size=16,
           positional_embedding_size=POS, degree_embedding_size=4,
           final_dropout=0.0)


def _top_gap(src, dst, n, k):
    """Smallest gap among the k + 1 largest eigenvalues of the normalized
    adjacency."""
    a = np.zeros((n, n))
    np.add.at(a, (dst, src), 1.0)
    d = np.maximum(a.sum(axis=1), 1.0)
    lam = np.linalg.eigvalsh(a / np.sqrt(d)[:, None] / np.sqrt(d)[None, :])
    top = lam[::-1][: min(n, k + 1)]
    return np.min(np.abs(np.diff(top))) if len(top) > 1 else np.inf


def random_subgraphs(rng, count, n_lo, n_hi, pos=POS, min_gap=0.02):
    """Connected random graphs (a ring plus chords, both directions of
    every edge) whose pos + 1 leading eigenvalues are separated by at
    least ``min_gap``: without near-degenerate eigenvalues the
    eigenvectors are determined up to sign, which both packages
    canonicalize, so their positional embeddings can be compared entry
    by entry. Candidates with a smaller gap are drawn again."""
    out = []
    while len(out) < count:
        n = int(rng.integers(n_lo, n_hi + 1))
        ring = np.arange(n)
        extra = rng.integers(0, n, (2, 2 * n))
        u = np.concatenate([ring, extra[0]])
        v = np.concatenate([(ring + 1) % n, extra[1]])
        keep = u != v
        u, v = u[keep], v[keep]
        src = np.concatenate([u, v]).astype(np.int32)
        dst = np.concatenate([v, u]).astype(np.int32)
        if _top_gap(src, dst, n, pos) >= min_gap:
            out.append(Subgraph(src=src, dst=dst, num_nodes=n,
                                seed=int(rng.integers(0, n))))
    return out


def _jx(subs):
    return [JxSubgraph(src=s.src, dst=s.dst, num_nodes=s.num_nodes,
                       seed=s.seed) for s in subs]


def encoders(pe_method, subs, seed=0):
    """A Flax encoder's random weights (BatchNorm statistics made
    non-trivial, since generation runs in eval mode) and the port's
    encoder holding the same weights."""
    rng = np.random.default_rng(seed)
    jcfg = JxTrainConfig(encoder=JxEncoderConfig(pe_method=pe_method, **ENC))
    cfg = TrainConfig(encoder=EncoderConfig(pe_method=pe_method, **ENC))
    enc = JxEncoder(jcfg.encoder)
    feats = jx_featurize_batch(
        jax.device_put(jx_batch_subgraphs(_jx(subs[:4]), N_MAX, E_MAX)), POS,
        pe_method="eigh")
    v = enc.init(jax.random.PRNGKey(seed), feats, train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32),
        v["batch_stats"])
    model = GraphEncoder(cfg.encoder)
    model.load_state_dict(flax_to_state_dict(params, stats))
    return jcfg, SimpleNamespace(params=params, batch_stats=stats), cfg, model


@pytest.mark.parametrize("two_views", [False, True])
def test_generate_embeddings_eigh_matches_jax(two_views):
    """Exact-eigendecomposition PE: embeddings within 1e-4 (unit-norm
    outputs; f32 eigenvectors of gap-separated spectra agree to ~1e-5).
    21 graphs at batch 8: the last chunk is padded."""
    rng = np.random.default_rng(1)
    subs = random_subgraphs(rng, 21, 12, N_MAX)
    subs_k = random_subgraphs(rng, 21, 12, N_MAX) if two_views else None
    jcfg, jstate, cfg, model = encoders("eigh", subs)
    want = jx_generate.generate_embeddings(
        jcfg, jstate, _jx(subs), n_max=N_MAX, e_max=E_MAX, batch_size=8,
        subgraphs_k=_jx(subs_k) if two_views else None)
    got = generate.generate_embeddings(
        cfg, model, subs, n_max=N_MAX, e_max=E_MAX, batch_size=8,
        subgraphs_k=subs_k, device="cpu")
    assert got.shape == want.shape == (21, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert model.training            # the encoder's mode is restored


@pytest.mark.parametrize("two_views", [False, True])
def test_generate_embeddings_subspace_matches_jax(two_views, monkeypatch):
    """Subspace PE, eval profile (24 iterated columns in a 32 bucket, the
    guarded Rayleigh-Ritz), JAX's Pallas kernel in interpret mode. The
    two PE kernels' bf16 rounds round differently, so positional
    embeddings agree as tests/test_torch_features.py states (|cos| >=
    0.999 per gap-separated column), which leaves the unit-norm
    embeddings within 2e-2 abs and at cosine >= 0.999 per graph."""
    monkeypatch.setenv("GCC_TPU_PE_PALLAS", "interpret")
    rng = np.random.default_rng(2)
    subs = random_subgraphs(rng, 12, 20, N_MAX)
    subs_k = random_subgraphs(rng, 12, 20, N_MAX) if two_views else None
    jcfg, jstate, cfg, model = encoders("subspace", subs)
    want = jx_generate.generate_embeddings(
        jcfg, jstate, _jx(subs), n_max=N_MAX, e_max=E_MAX, batch_size=8,
        subgraphs_k=_jx(subs_k) if two_views else None)
    got = generate.generate_embeddings(
        cfg, model, subs, n_max=N_MAX, e_max=E_MAX, batch_size=8,
        subgraphs_k=subs_k, device="cpu")
    assert np.isfinite(got).all()
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999, cos.min()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def test_readouts_match_jax():
    """generate_subgraph_readouts (score and every pooled layer) within
    1e-4 relative to each layer's scale, and the composite readout built
    from them, with the exact PE."""
    rng = np.random.default_rng(3)
    subs = random_subgraphs(rng, 11, 12, N_MAX)
    jcfg, jstate, cfg, model = encoders("eigh", subs)
    want = jx_generate.generate_subgraph_readouts(
        jcfg, jstate, _jx(subs), n_max=N_MAX, e_max=E_MAX, batch_size=4)
    got = generate.generate_subgraph_readouts(
        cfg, model, subs, n_max=N_MAX, e_max=E_MAX, batch_size=4,
        device="cpu")
    np.testing.assert_allclose(got["score"], want["score"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["n_nodes"], want["n_nodes"])
    assert len(got["pooled"]) == len(want["pooled"]) == 2
    for g, w in zip(got["pooled"], want["pooled"]):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(w).max()))
    comp = generate.composite_graph_readout(got)
    np.testing.assert_allclose(
        comp, jx_generate.composite_graph_readout(want), rtol=0, atol=1e-4)
    assert comp.shape == (11, (POS + 4 + 1) + 16)


def test_graph_embeddings_readouts_and_bucket_guard():
    """Entire-graph mode: both readouts against JAX on CSR graphs; a
    graph beyond the bucket is never truncated: the score readout routes
    it to the giant path (finite unit rows, the others as without it),
    the composite readout raises."""
    rng = np.random.default_rng(4)
    subs = random_subgraphs(rng, 6, 12, N_MAX)
    graphs = [CSRGraph.from_edges(s.src, s.dst, num_nodes=s.num_nodes,
                                  symmetrize=False) for s in subs]
    from gcc_tpu.graph.csr import CSRGraph as JxCSR

    jgraphs = [JxCSR.from_edges(s.src, s.dst, num_nodes=s.num_nodes,
                                symmetrize=False) for s in subs]
    jcfg, jstate, cfg, model = encoders("eigh", subs)
    for readout in ("score", "composite"):
        want = jx_generate.generate_graph_embeddings(
            jcfg, jstate, jgraphs, n_max=N_MAX, e_max=E_MAX, batch_size=4,
            readout=readout)
        got = generate.generate_graph_embeddings(
            cfg, model, graphs, n_max=N_MAX, e_max=E_MAX, batch_size=4,
            readout=readout, device="cpu")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    routed = generate.generate_graph_embeddings(cfg, model, graphs, n_max=16,
                                                e_max=E_MAX, device="cpu")
    small = [i for i, g in enumerate(graphs) if g.num_nodes <= 16]
    assert 0 < len(small) < len(graphs)
    np.testing.assert_array_equal(
        routed[small], generate.generate_graph_embeddings(
            cfg, model, [graphs[i] for i in small], n_max=16, e_max=E_MAX,
            device="cpu"))
    np.testing.assert_allclose(np.linalg.norm(routed, axis=1), 1.0,
                               atol=1e-5)
    with pytest.raises(NotImplementedError, match="composite"):
        generate.generate_graph_embeddings(cfg, model, graphs, n_max=16,
                                           e_max=E_MAX, readout="composite",
                                           device="cpu")
    with pytest.raises(ValueError, match="readout"):
        generate.generate_graph_embeddings(cfg, model, graphs, n_max=N_MAX,
                                           readout="mean", device="cpu")


def test_generate_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    subs = random_subgraphs(np.random.default_rng(5), 2, 12, 16)
    _, _, cfg, model = encoders("eigh", subs + subs)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate.generate_embeddings(cfg, model, subs, n_max=N_MAX,
                                     e_max=E_MAX)
    with pytest.raises(RuntimeError, match="CUDA"):
        featurize_batch(batch_subgraphs(subs, N_MAX, E_MAX), POS)


def _pe_columns_agree(pos, want_pos, subs, pos_size, min_gap=0.02):
    """|cos| >= 0.999 on every column whose eigenvalue is separated by
    min_gap from its neighbours; returns the number checked."""
    checked = 0
    for g, s in enumerate(subs):
        n_b = s.num_nodes
        k_b = min(max(n_b - 2, 0), pos_size)
        a = np.zeros((n_b, n_b))
        np.add.at(a, (s.dst, s.src), 1.0)
        d = np.maximum(a.sum(axis=1), 1.0)
        lam = np.linalg.eigvalsh(
            a / np.sqrt(d)[:, None] / np.sqrt(d)[None, :])[::-1]
        for j in range(k_b):
            gaps = [abs(lam[j] - lam[i]) for i in (j - 1, j + 1)
                    if 0 <= i < len(lam)]
            if min(gaps) < min_gap:
                continue
            x, y = pos[g, :n_b, j], want_pos[g, :n_b, j]
            if not x.any() and not y.any():
                # A graph smaller than the block: the guarded
                # Rayleigh-Ritz dropped this direction in both packages.
                continue
            cos = abs(x @ y) / (np.linalg.norm(x) * np.linalg.norm(y))
            assert cos >= 0.999, (g, j, cos)
            checked += 1
    return checked


@pytest.mark.parametrize("n_max,sizes", [
    (64, (10, 30, 47, 50, 64, 3, 2, 1)),   # k = 48; graphs with n_b < 48
    (40, (40, 33, 12, 25)),                # a bucket below 48: k = 40
])
def test_featurize_batch_eval_profile_matches_jax(n_max, sizes, monkeypatch):
    """featurize_batch(profile="eval") at the canonical PE width (32
    columns + 16 guards): adjacency, degrees, seed flag and mask exact,
    the same columns zeroed, finite. Graphs smaller than the block
    exercise the relative floor and the ``keep`` mask of the guarded
    Rayleigh-Ritz (columns they drop are zero in both packages); graphs
    of 1-3 nodes have no PE column at all.

    PE columns are compared (|cos| >= 0.999 where the eigenvalue is
    separated, as tests/test_torch_features.py) with the exact finish
    (``torch.linalg.eigh`` here, ``GCC_TPU_PE_RR=eigh`` there) on both
    sides, and the port's 5-sweep Jacobi finish against its own exact
    finish: at the default 3 sweeps a 40- or 48-wide Jacobi is not
    converged on graphs this small (30-64 nodes), and what it returns
    then depends on the last bits of its input, in either package. (The
    port's Jacobi is held against the reference's in
    tests/test_torch_ops.py.)"""
    monkeypatch.setenv("GCC_TPU_PE_PALLAS", "interpret")
    rng = np.random.default_rng(n_max)
    subs = [random_subgraphs(rng, 1, n, n, pos=min(32, max(n - 2, 1)),
                             min_gap=0.0)[0] for n in sizes]
    batch = batch_subgraphs(subs, n_max, 1024)
    monkeypatch.setenv("GCC_TPU_PE_RR", "eigh")
    want = jax.jit(lambda b: jx_featurize_batch(
        b, 32, pe_method="subspace", profile="eval"))(
        jax.device_put(jx_batch_subgraphs(_jx(subs), n_max, 1024)))
    got = featurize_batch(batch, 32, pe_method="subspace", profile="eval",
                          device="cpu")
    for name in ("adj", "degrees", "seed_flag", "node_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    want_pos = np.asarray(want.pos)
    assert got.pos.shape == want_pos.shape == (len(sizes), n_max, 32)
    assert torch.isfinite(got.pos).all()

    def port_pe(**kw):
        return laplacian_positional_embedding(
            got.node_mask, torch.as_tensor(batch.n_nodes), 32, adj=got.adj,
            method="subspace", profile="eval", **kw).numpy()

    exact, jacobi5 = port_pe(rr="eigh"), port_pe(rr_sweeps=5)
    for pos in (got.pos.numpy(), exact, jacobi5):
        np.testing.assert_array_equal(np.abs(pos).sum(axis=1) > 0,
                                      np.abs(want_pos).sum(axis=1) > 0)
    assert _pe_columns_agree(exact, want_pos, subs, 32) >= 20
    assert _pe_columns_agree(jacobi5, exact, subs, 32) >= 20


def test_expand_compact_matches_jax_and_featurize_compact(tmp_path):
    """A sampled compact wire batch expanded on the host
    (``expand_compact``) equals gcc_tpu's expansion field by field, and
    featurizing the expansion (``featurize_batch``) gives what
    ``featurize_compact`` gives straight from the packed edges."""
    from gcc_tpu.graph.batch import (
        CompactWireBatch as JxWire,
        expand_compact as jx_expand,
    )
    from gcc_tpu_torch.config import SamplerConfig
    from gcc_tpu_torch.features.featurize import featurize_compact
    from gcc_tpu_torch.graph.batch import expand_compact
    from gcc_tpu_torch.graph.corpus import synthetic_corpus
    from gcc_tpu_torch.sampling.pipeline import (
        PipelineConfig,
        PretrainPipeline,
    )
    from gcc_tpu_torch.wire import wire_to_device

    store = synthetic_corpus(str(tmp_path / "c"), num_graphs=2,
                             nodes_per_graph=400, avg_degree=6)
    pcfg = PipelineConfig(batch_size=8, n_max=N_MAX, e_max=E_MAX,
                          num_samples=16, num_workers=0, emit="pairs")
    with PretrainPipeline(store, SamplerConfig(rw_hops=16), pcfg) as pipe:
        wire, _ = next(pipe)
    batch = expand_compact(wire, N_MAX)
    want = jx_expand(JxWire(edges=jnp.asarray(wire.edges),
                            meta=jnp.asarray(wire.meta), e_max=wire.e_max,
                            id_bits=wire.id_bits), N_MAX)
    for name in ("edges_src", "edges_dst", "edge_weight", "node_mask",
                 "seed_flag", "n_nodes"):
        got = getattr(batch, name)
        w = np.asarray(getattr(want, name))
        assert got.dtype == w.dtype, name
        # Padding slots (weight 0) may point anywhere inside the graph.
        live = batch.edge_weight > 0 if name.startswith("edges_") else ...
        np.testing.assert_array_equal(got[live], w[live], err_msg=name)
    assert batch.e_max == wire.e_max and batch.n_max == N_MAX
    a = featurize_batch(batch, POS, pe_method="eigh", device="cpu")
    edges, meta = wire_to_device(wire, "cpu")
    b = featurize_compact(edges[None], meta[None], N_MAX, wire.id_bits, POS,
                          pe_method="eigh")
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_pe_beyond_the_kernels_reach_matches_jax(monkeypatch):
    """A bucket of 864 nodes is past both packages' fused kernel
    (N*N*6 > 4 MiB; the port's takes N <= 832): both run the iteration as
    plain batched products (CholeskyQR, bf16-input power steps,
    Newton-Schulz, f32 polish). Eval profile, exact finish on both
    sides; PE columns |cos| >= 0.999 where the eigenvalue is separated by
    0.002 from its neighbours (graphs this large have clustered spectra,
    and the two sides run the same arithmetic, so they agree at smaller
    gaps than the kernels' tests allow)."""
    from gcc_tpu_torch.ops import pe

    n_max = 864
    assert n_max > pe.MAX_NODES and n_max * n_max * 6 > (4 << 20)
    monkeypatch.setattr(pe, "pe_subspace_iterate", None)   # must not be used
    monkeypatch.setenv("GCC_TPU_PE_RR", "eigh")
    rng = np.random.default_rng(6)
    subs = random_subgraphs(rng, 2, 300, n_max, pos=32, min_gap=0.0)
    batch = batch_subgraphs(subs, n_max, 8192)
    want = np.asarray(jax.jit(lambda b: jx_featurize_batch(
        b, 32, pe_method="subspace", profile="eval"))(
        jax.device_put(jx_batch_subgraphs(_jx(subs), n_max, 8192))).pos)
    adj = featurize_batch(batch, 32, pe_method="eigh", device="cpu").adj
    got = laplacian_positional_embedding(
        torch.as_tensor(batch.node_mask), torch.as_tensor(batch.n_nodes), 32,
        adj=adj, method="subspace", profile="eval", rr="eigh").numpy()
    assert got.shape == want.shape == (2, n_max, 32)
    assert _pe_columns_agree(got, want, subs, 32, min_gap=0.002) >= 20


def test_batch_guard_keeps_the_adjacency_under_a_gigabyte():
    assert generate._guarded_batch_size(64, 512) == 64
    assert generate._guarded_batch_size(64, 4096) == 16
    assert generate._guarded_batch_size(64, 40000) == 1
