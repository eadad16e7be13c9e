"""The port's giant-graph path (``gcc_tpu_torch/parallel``) against
gcc_tpu's: partitions bit for bit, the four aggregations against the
reference's on a mesh of 8 virtual CPU devices and the numpy oracle, the
aggregations' gradients, ``giant_gin_encode`` against the dense
subgraph path and the reference's, and the routing of
``generate_graph_embeddings`` (the whole-graph PE:
``test_torch_giant_pe.py``). The port runs the partition axis in one
process, D = 8 (the reference's mesh) and D = 1 (one card).

The reference's JIT program cache (``tests/test_parallel.py:776``) has no
counterpart: the port runs eagerly and compiles no program per shape."""

import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from gcc_tpu import generate as jx_generate  # noqa: E402
from gcc_tpu.config import (  # noqa: E402
    EncoderConfig as JxEncoderConfig,
    TrainConfig as JxTrainConfig,
)
from gcc_tpu.features import featurize_batch as jx_featurize_batch  # noqa: E402
from gcc_tpu.graph.batch import (  # noqa: E402
    Subgraph as JxSubgraph,
    batch_subgraphs as jx_batch_subgraphs,
)
from gcc_tpu.models import GraphEncoder as JxEncoder  # noqa: E402
from gcc_tpu.parallel import giant_features as jx_gf  # noqa: E402
from gcc_tpu.parallel import partitioned as jx_part  # noqa: E402
from gcc_tpu.parallel.giant import giant_gin_encode as jx_giant_gin_encode  # noqa: E402
from gcc_tpu.parallel.mesh import make_mesh  # noqa: E402
from gcc_tpu_torch import generate  # noqa: E402
from gcc_tpu_torch.compat import flax_to_state_dict  # noqa: E402
from gcc_tpu_torch.config import EncoderConfig, TrainConfig  # noqa: E402
from gcc_tpu_torch.features.featurize import featurize_batch  # noqa: E402
from gcc_tpu_torch.graph.batch import Subgraph, batch_subgraphs  # noqa: E402
from gcc_tpu_torch.graph.csr import CSRGraph  # noqa: E402
from gcc_tpu_torch.models import GraphEncoder  # noqa: E402
from gcc_tpu_torch.parallel import giant_features as gf  # noqa: E402
from gcc_tpu_torch.parallel import partitioned as part  # noqa: E402
from gcc_tpu_torch.parallel.giant import giant_gin_encode  # noqa: E402

torch.set_num_threads(1)

SCHEDULES = ("segment", "dense", "ring")
BUILD = {"segment": "partition_edges", "dense": "partition_dense",
         "ring": "partition_edges_ring"}
AGGREGATE = {"segment": "partitioned_aggregate",
             "dense": "partitioned_aggregate_dense",
             "ring": "partitioned_aggregate_ring"}


def _edges(seed, n, e):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e), rng.integers(0, n, e),
            rng.uniform(0.5, 2.0, e).astype(np.float32))


def _symmetric_graph(n, avg_deg, seed=0):
    """tests/test_parallel.py's random symmetric graph (both directions
    of every edge, self-loops dropped)."""
    rng = np.random.default_rng(seed)
    e = n * avg_deg // 2
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return (np.concatenate([src, dst]).astype(np.int64),
            np.concatenate([dst, src]).astype(np.int64))


def _jx_aggregate(schedule, pg, h, d):
    """The reference's aggregation on a (data=1, part=d) mesh."""
    mesh = make_mesh(data=1, part=d)
    if schedule == "dense":
        pg = jx_part.shard_dense_partition(pg, mesh)
    hs = jax.device_put(jnp.asarray(h), NamedSharding(mesh, P("part")))
    return np.asarray(getattr(jx_part, AGGREGATE[schedule])(pg, hs, mesh))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("d", [1, 4, 8])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_partitions_equal_reference_bit_for_bit(schedule, d, weighted):
    """The host builders give the reference's arrays (tests/
    test_parallel.py:26,104), on 50 nodes (padded unless d divides it)."""
    src, dst, w = _edges(3, 50, 400)
    kw = dict(weight=w) if weighted else {}
    ours = getattr(part, BUILD[schedule])(src, dst, 50, d, **kw)
    ref = getattr(jx_part, BUILD[schedule])(src, dst, 50, d, **kw)
    assert ours.num_nodes == ref.num_nodes == -(-50 // d) * d
    for f in ref._fields[:-1]:
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("d", [8, 1])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_aggregate_matches_reference_and_oracle(schedule, d):
    """Each aggregation on weighted multi-edges within 1e-5 of the
    reference's on 8 virtual devices and of the numpy oracle (tests/
    test_parallel.py:35,73,120), with the partition as numpy arrays and
    placed (place_partition)."""
    n, f = 64, 16
    src, dst, w = _edges(4, n, 500)
    rng = np.random.default_rng(5)
    h = rng.normal(size=(n, f)).astype(np.float32)
    want = _jx_aggregate(schedule, getattr(jx_part, BUILD[schedule])(
        src, dst, n, 8, weight=w), h, 8)
    oracle = np.zeros_like(h)
    np.add.at(oracle, dst, h[src] * w[:, None])
    pg = getattr(part, BUILD[schedule])(src, dst, n, d, weight=w)
    agg = getattr(part, AGGREGATE[schedule])
    for p in (pg, part.place_partition(pg, "cpu")):
        got = agg(p, torch.from_numpy(h)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", [2, 1])
def test_batched_aggregate_matches_reference_and_oracle(d):
    """partitioned_aggregate_batched against the reference's on the
    (data=4, part=2) mesh and the oracle per view (tests/
    test_parallel.py:245)."""
    n, f, b = 32, 8, 8
    src, dst, w = _edges(6, n, 200)
    h = np.random.default_rng(7).normal(size=(b, n, f)).astype(np.float32)
    mesh = make_mesh(data=4, part=2)
    ref_pg = jx_part.partition_edges(src, dst, n, 2, weight=w)
    want = np.asarray(jx_part.partitioned_aggregate_batched(
        ref_pg, jax.device_put(jnp.asarray(h),
                               NamedSharding(mesh, P("data", "part"))), mesh))
    pg = part.partition_edges(src, dst, n, d, weight=w)
    got = part.partitioned_aggregate_batched(pg, torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for i in range(b):
        np.testing.assert_allclose(
            got[i], part.giant_graph_embedding_oracle(pg, h[i]), rtol=0,
            atol=1e-5)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_aggregate_gradient_is_the_transposed_aggregation(schedule):
    """torch.autograd's gradient of (aggregate(h)·r).sum() equals the
    transposed aggregation Aᵀr, out[u] = Σ_{(u→v)} w · r[v] (the
    counterpart of tests/test_parallel.py:54,152; the port has no JIT
    half)."""
    n, f = 32, 8
    src, dst, w = _edges(8, n, 100)
    rng = np.random.default_rng(9)
    h = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32))
    r = rng.normal(size=(n, f)).astype(np.float32)
    pg = getattr(part, BUILD[schedule])(src, dst, n, 4, weight=w)
    h.requires_grad_(True)
    (getattr(part, AGGREGATE[schedule])(pg, h) * torch.from_numpy(r)
     ).sum().backward()
    transposed = np.zeros_like(r)
    np.add.at(transposed, src, r[dst] * w[:, None])
    np.testing.assert_allclose(h.grad.numpy(), transposed, rtol=0, atol=1e-5)


def test_dense_partition_count_is_checked():
    """A dense partition built for another partition count raises on
    placement, and features it does not cover raise on aggregation
    (partitioned.py:213-218,233-239)."""
    src, dst, _ = _edges(1, 18, 40)
    pg = part.partition_dense(src, dst, 18, 4)
    with pytest.raises(ValueError, match="partition count"):
        part.shard_dense_partition(pg, 2, "cpu")
    with pytest.raises(ValueError, match="does not cover"):
        part.partitioned_aggregate_dense(pg, torch.zeros(18, 3))
    placed = part.shard_dense_partition(pg, 4, "cpu")
    assert part.partitioned_aggregate_dense(
        placed, torch.zeros(20, 3)).shape == (20, 3)


def test_ring_placement_drops_the_common_padding():
    """place_partition trims the bucket tail that _bucket_ring pads
    (weight-0 0→0 edges) and aggregates to the same values."""
    src, dst, w = _edges(2, 40, 300)
    pg = gf._bucket_ring(part.partition_edges_ring(src, dst, 40, 1, weight=w))
    assert pg.src_local.shape[-1] == 512
    placed = part.place_partition(pg, "cpu")
    assert placed.src_local.shape[-1] == 300
    h = torch.from_numpy(np.random.default_rng(3).normal(
        size=(40, 4)).astype(np.float32))
    np.testing.assert_allclose(part.partitioned_aggregate_ring(placed, h),
                               part.partitioned_aggregate_ring(pg, h),
                               rtol=0, atol=1e-6)


def test_host_helpers_equal_reference():
    """normalized_edge_weights, giant_pe_basis, _bucket_ring and the
    dense/ring policy give the reference's values."""
    src, dst = _symmetric_graph(300, 6, seed=1)
    deg = np.bincount(src, minlength=300)
    assert np.array_equal(gf.normalized_edge_weights(src, dst, deg),
                          jx_gf.normalized_edge_weights(src, dst, deg))
    for n_pad, n, pos, guards in ((512, 500, 32, 16), (40, 33, 8, 3)):
        assert np.array_equal(gf.giant_pe_basis(n_pad, n, pos, guards),
                              jx_gf.giant_pe_basis(n_pad, n, pos, guards))
    ring = part.partition_edges_ring(src, dst, 300, 4)
    ours, ref = gf._bucket_ring(ring), jx_gf._bucket_ring(ring)
    for f in ("src_local", "dst_local", "weight"):
        assert np.array_equal(getattr(ours, f), getattr(ref, f))
    for args in ((1000, 4096, 1), (1000, 5000, 1), (200_000, 7000, 1),
                 (200_000, 7000, 8), (600_000, 12_000, 1), (10, 20_000, 8)):
        assert gf.dense_schedule_wins(*args) == jx_gf.dense_schedule_wins(
            *args), args


def _encoders(seed=0, **enc):
    """A Flax encoder's random weights with non-trivial BatchNorm
    statistics, and the port's GraphEncoder holding them (compat.py)."""
    rng = np.random.default_rng(seed)
    kw = dict(hidden_size=16, output_size=16, positional_embedding_size=8,
              degree_embedding_size=4, pe_method="eigh", final_dropout=0.0)
    kw.update(enc)
    jcfg, cfg = JxEncoderConfig(**kw), EncoderConfig(**kw)
    s = rng.integers(0, 24, 96).astype(np.int32)
    d = rng.integers(0, 24, 96).astype(np.int32)
    toy = jx_batch_subgraphs([JxSubgraph(src=s, dst=d, num_nodes=24)],
                             n_max=32, e_max=256)
    v = JxEncoder(jcfg).init(jax.random.PRNGKey(seed), jx_featurize_batch(
        toy, cfg.positional_embedding_size), train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32),
        v["batch_stats"])
    model = GraphEncoder(cfg)
    model.load_state_dict(flax_to_state_dict(params, stats))
    return jcfg, SimpleNamespace(params=params, batch_stats=stats), cfg, model


@functools.lru_cache(maxsize=1)
def _encode_case():
    """A 24-node graph's node features from the port's dense subgraph
    path, that path's embedding (eval mode), the weights of both
    packages, and the reference's giant_gin_encode on 8 virtual devices
    (its dense schedule; all three compute the same function)."""
    jcfg, jstate, cfg, model = _encoders(num_layers=5)
    rng = np.random.default_rng(0)
    n = 24
    src, dst = rng.integers(0, n, 80), rng.integers(0, n, 80)
    keep = src != dst
    s = np.concatenate([src[keep], dst[keep]]).astype(np.int32)
    t = np.concatenate([dst[keep], src[keep]]).astype(np.int32)
    model.eval()
    feats = featurize_batch(
        batch_subgraphs([Subgraph(src=s, dst=t, num_nodes=n, seed=3)],
                        n_max=32, e_max=256), cfg.positional_embedding_size,
        device="cpu")
    with torch.no_grad():
        dense = model(feats)[0].numpy()
        nf = torch.cat([feats.pos[0],
                        model.degree_embedding(feats.degrees[0]),
                        feats.seed_flag[0][:, None]], dim=-1)
    # n = 24 is a multiple of 8 and 1: no padding rows either way.
    nf, mask = nf.numpy()[:n], feats.node_mask[0].numpy()[:n]
    mesh = make_mesh(data=1, part=8)
    jpg = jx_part.shard_dense_partition(jx_part.partition_dense(s, t, n, 8),
                                        mesh)
    sh = NamedSharding(mesh, P("part"))
    want = np.asarray(jx_giant_gin_encode(
        jstate.params, jstate.batch_stats, jpg,
        jax.device_put(jnp.asarray(nf), sh),
        jax.device_put(jnp.asarray(mask), sh), mesh, num_layers=5))
    return model, (s, t, n), nf, mask, dense, want


@pytest.mark.parametrize("d", [8, 1])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_giant_gin_encode_matches_dense_path_and_reference(schedule, d):
    """giant_gin_encode over each schedule equals the port's dense
    subgraph path (eval mode) and the reference's giant_gin_encode on 8
    virtual devices within 1e-5, the weights carried across by compat.py
    (tests/test_parallel.py:343)."""
    model, (s, t, n), nf, mask, dense, want = _encode_case()
    pg = getattr(part, BUILD[schedule])(s, t, n, d)
    with torch.no_grad():
        got = giant_gin_encode(model, pg, torch.from_numpy(nf),
                               torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _graphs(spec):
    out = []
    for n, davg in spec:
        src, dst = _symmetric_graph(n, davg, seed=n)
        out.append(CSRGraph.from_edges(src, dst, num_nodes=n,
                                       symmetrize=True))
    return out


def _train_cfgs(**enc):
    kw = dict(num_layers=2, hidden_size=16, output_size=16,
              positional_embedding_size=8, degree_embedding_size=4,
              final_dropout=0.0, pe_method="eigh")
    kw.update(enc)
    return (JxTrainConfig(encoder=JxEncoderConfig(**kw)),
            TrainConfig(encoder=EncoderConfig(**kw)))


def test_generate_graph_embeddings_routes_giant():
    """Graphs beyond n_max go to the giant path, rows in input order
    (tests/test_parallel.py:730): small rows within 1e-5 of the
    reference's and equal to the port's own entire-graph batch path;
    giant rows finite, of unit norm, and equal to giant_graph_embedding's.
    (The reference's routing of the same list is not run: its giant
    program compiles for ~40 s, and its small rows do not depend on the
    giant graph.)"""
    jcfg, cfg = _train_cfgs()
    _, jstate, _, model = _encoders(**{k: getattr(cfg.encoder, k) for k in (
        "num_layers", "hidden_size", "output_size",
        "positional_embedding_size", "degree_embedding_size",
        "final_dropout", "pe_method")})
    graphs = _graphs(((60, 6), (700, 8), (50, 4)))
    emb = generate.generate_graph_embeddings(
        cfg, model, graphs, n_max=256, e_max=2048, giant_iters=32,
        device="cpu")
    assert emb.shape == (3, 16) and np.isfinite(emb).all()
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-3)
    want = jx_generate.generate_graph_embeddings(
        jcfg, jstate, [graphs[0], graphs[2]], n_max=256, e_max=2048)
    np.testing.assert_allclose(emb[[0, 2]], want, rtol=0, atol=1e-5)
    direct = generate.generate_embeddings(
        cfg, model, generate.graph_subgraphs([graphs[0], graphs[2]]),
        n_max=256, e_max=2048, device="cpu")
    np.testing.assert_array_equal(emb[[0, 2]], direct)
    model.eval()
    giant = gf.giant_graph_embedding(model, graphs[1], iters=32,
                                     device="cpu").numpy()
    np.testing.assert_array_equal(emb[1], giant)


def test_composite_readout_refuses_giant_graphs():
    """readout='composite' refuses graphs beyond n_max
    (tests/test_parallel.py:819; gcc_tpu/generate.py:262-267)."""
    _, cfg = _train_cfgs()
    model = GraphEncoder(cfg.encoder)
    model.reset_parameters(torch.Generator().manual_seed(0))
    graphs = _graphs(((60, 6), (50, 4)))
    emb = generate.generate_graph_embeddings(
        cfg, model, graphs, n_max=128, e_max=1024, readout="composite",
        device="cpu")
    assert emb.shape == (2, 8 + 4 + 1 + 16) and np.isfinite(emb).all()
    with pytest.raises(NotImplementedError, match="composite"):
        generate.generate_graph_embeddings(
            cfg, model, graphs + _graphs(((600, 6),)), n_max=128,
            e_max=1024, readout="composite", device="cpu")


@pytest.mark.parametrize("enc", [dict(model="gat"), dict(model="mpnn"),
                                 dict(use_selayer=True),
                                 dict(degree_input=False)])
def test_giant_path_refuses_what_the_reference_cannot_run(enc):
    """GAT, MPNN, GIN with SELayer and encoders without degree input are
    refused with a clear error (the reference's giant path fails on them
    with a KeyError on its parameter tree)."""
    _, cfg = _train_cfgs(**enc)
    model = GraphEncoder(cfg.encoder)
    with pytest.raises(ValueError, match="giant-graph path"):
        generate.generate_graph_embeddings(cfg, model, _graphs(((300, 6),)),
                                           n_max=128, device="cpu")


def test_cli_generate_reaches_the_giant_path(tmp_path):
    """`cli generate` on a graph classification dataset routes its graphs
    beyond --n-max to the giant path through generate_graph_embeddings
    (gcc_tpu/cli.py:215-225): a REDDIT-BINARY-layout dataset of three
    graphs, the middle one beyond n_max, from a checkpoint."""
    from gcc_tpu_torch import cli
    from gcc_tpu_torch.training.checkpoint import (
        load_encoder,
        save_checkpoint,
    )
    from gcc_tpu_torch.training.pretrain import create_pretrain_state

    _, cfg = _train_cfgs(pe_method="subspace")
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    save_checkpoint(run_dir, create_pretrain_state(cfg, 10, device="cpu"),
                    cfg)
    graphs = _graphs(((20, 4), (60, 4), (25, 4)))
    root = tmp_path / "data" / "REDDIT-BINARY"
    root.mkdir(parents=True)
    offsets = np.cumsum([0] + [g.num_nodes for g in graphs])
    edges = np.concatenate([
        np.stack([np.repeat(np.arange(g.num_nodes), np.diff(g.indptr)),
                  g.indices], axis=1) + off + 1
        for g, off in zip(graphs, offsets)])
    np.savetxt(root / "REDDIT-BINARY_A.txt", edges, fmt="%d", delimiter=",")
    np.savetxt(root / "REDDIT-BINARY_graph_indicator.txt",
               np.repeat(np.arange(3), [g.num_nodes for g in graphs]) + 1,
               fmt="%d")
    np.savetxt(root / "REDDIT-BINARY_graph_labels.txt", [0, 1, 0], fmt="%d")
    out = str(tmp_path / "emb.npy")
    cli.main(["generate", "--ckpt", os.path.join(run_dir, "current"),
              "--dataset", "rdt-b", "--data-root", str(tmp_path / "data"),
              "--out", out, "--n-max", "32", "--e-max", "512",
              "--device", "cpu"])
    emb = np.load(out)
    model = load_encoder(os.path.join(run_dir, "current"), cfg,
                         device="cpu").eval()
    np.testing.assert_array_equal(
        emb[1], gf.giant_graph_embedding(model, graphs[1],
                                         device="cpu").numpy())
    np.testing.assert_array_equal(emb[[0, 2]], generate.generate_embeddings(
        cfg, model, generate.graph_subgraphs([graphs[0], graphs[2]]),
        n_max=32, e_max=512, device="cpu"))
