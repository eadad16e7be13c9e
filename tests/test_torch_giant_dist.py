"""The giant-graph PE and encode with the partition axis across
``torch.distributed`` ranks (``gcc_tpu_torch/parallel/giant_features.py``,
``giant.py``, ``partitioned.py place_shard``; ``generate_graph_embeddings
(group=...)``) against the port's one-process form at the same partition
count and against the reference's ``giant_graph_embedding`` on
``make_mesh(data=1, part=2)``.

The ranks are children of this file (``python test_torch_giant_dist.py
child <world> <rank> <port> <dir>``), started once for the module as 2
and as 4 gloo ranks; each runs every scenario and leaves its results in
the work directory. They import torch and the port only. The references
are computed here while they run.

Across ranks the Gram and norm sums run in another order than in one
process, and the PE's f32 finish turns such differences into rotations
among near-degenerate Ritz vectors; so the PE is held by its row
cosines pos·posᵀ, and everything on graphs whose leading eigenvalues are
separated (``tests/test_torch_giant_pe.py``'s criterion). The PE is
held with its Rayleigh–Ritz finish run to convergence
(CONVERGED_SWEEPS), and the iterated basis it starts from at the
reference's settings: at the reference's 5 Jacobi sweeps the finish
starts from a basis that the guarded whitening rotates at random (the
iterated Gram is the identity to ~1e-6, so its eigenvectors are any
rotation), and what the sweeps leave unconverged amplifies a last-place
change of a Gram by a factor that varies from draw to draw: the row
cosines across ranks moved by a mean of 2.0e-5 on the ring at 2 ranks
(3.1e-6 at 10 sweeps), and by 1.03e-4 on the segment schedule at 4
ranks in a variant with f64 partial sums (4.5e-6 at 10). The whole
embedding is held at the reference's 5 sweeps."""

import contextlib
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CHILD_TIMEOUT = 240
WORLDS = (2, 4)         # held against the one-process form by tolerances
ALL_WORLDS = (1,) + WORLDS   # world size 1: the one-process bits
# "ring256": the ring with giant_partitions' padding to a multiple of
# 256·D nodes, so every rank past the first holds padding rows only.
SCHEDULES = ("dense", "ring", "ring256", "segment")
BUILD = {"segment": "partition_edges", "dense": "partition_dense",
         "ring": "partition_edges_ring", "ring256": "partition_edges_ring"}
CONVERGED_SWEEPS = 10   # the giant PE's finish runs the reference's 5
SEP_POS = 8
ENC = dict(num_layers=5, hidden_size=16, output_size=16,
           positional_embedding_size=SEP_POS, degree_embedding_size=4,
           pe_method="eigh", final_dropout=0.0)
N_MAX, E_MAX = 32, 512
GIANT_SEEDS = (3, 4)


# ---- inputs shared by the ranks and the references -----------------------

def _separated_graph(pos, min_gap=0.02, seed=3):
    """A ring plus chords of 48-64 nodes (both directions of every edge)
    whose pos + 1 leading eigenvalues of M are at least `min_gap` apart
    (``tests/test_torch_giant_pe.py``'s graph)."""
    from gcc_tpu_torch.parallel.giant_features import normalized_edge_weights

    rng = np.random.default_rng(seed)
    while True:
        n = int(rng.integers(48, 65))
        ring = np.arange(n)
        u = np.concatenate([ring, rng.integers(0, n, n)])
        v = np.concatenate([(ring + 1) % n, rng.integers(0, n, n)])
        keep = u != v
        src = np.concatenate([u[keep], v[keep]]).astype(np.int64)
        dst = np.concatenate([v[keep], u[keep]]).astype(np.int64)
        deg = np.bincount(src, minlength=n)
        w = normalized_edge_weights(src, dst, deg)
        m = np.zeros((n, n))
        np.add.at(m, (dst, src), w.astype(np.float64))
        lam = np.linalg.eigvalsh(m)[::-1][:pos + 1]
        if np.min(-np.diff(lam)) >= min_gap:
            return n, src, dst, w


def _partition(schedule, d, weighted=True):
    """The separated graph's partition for d shards, with the normalized
    weights of the PE or the unit weights of the encoder."""
    from gcc_tpu_torch.parallel import partitioned as part

    n, src, dst, w = _separated_graph(SEP_POS)
    n_pad = -(-n // (256 * d)) * 256 * d if schedule == "ring256" else n
    return n, getattr(part, BUILD[schedule])(
        src, dst, n_pad, d, weight=w if weighted else None)


def _pe_inputs(n, n_pad):
    from gcc_tpu_torch.parallel.giant_features import giant_pe_basis

    q0 = torch.from_numpy(giant_pe_basis(n_pad, n, SEP_POS, guards=16))
    return q0, (torch.arange(n_pad) < n).to(torch.float32)


def _encode_features(n, n_pad):
    """Seeded node features (PE, degree-embedding and seed-flag widths),
    zero on padding rows."""
    f = np.random.default_rng(7).normal(
        size=(n_pad, SEP_POS + ENC["degree_embedding_size"] + 1))
    f[n:] = 0.0
    return torch.from_numpy(f.astype(np.float32))


def _csr(seed):
    from gcc_tpu_torch.graph.csr import CSRGraph

    n, src, dst, _ = _separated_graph(SEP_POS, seed=seed)
    return CSRGraph.from_edges(src, dst, num_nodes=n)


def _small_graph(n, seed):
    from gcc_tpu_torch.graph.csr import CSRGraph

    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)
    keep = src != dst
    return CSRGraph.from_edges(src[keep], dst[keep], num_nodes=n,
                               symmetrize=True)


def _routing_graphs():
    """Giant (beyond N_MAX) and dense-bucket graphs, interleaved."""
    return [_csr(GIANT_SEEDS[0]), _small_graph(20, 1), _csr(GIANT_SEEDS[1]),
            _small_graph(25, 2)]


def _train_cfg():
    from gcc_tpu_torch.config import EncoderConfig, TrainConfig

    return TrainConfig(encoder=EncoderConfig(**ENC))


@contextlib.contextmanager
def _converged_finish():
    """The giant PE's finish with CONVERGED_SWEEPS Jacobi sweeps (it looks
    Kernel 3 up in its module)."""
    from gcc_tpu_torch.parallel import giant_features as gf

    real = gf.jacobi_eigh
    gf.jacobi_eigh = lambda a, **kw: real(
        a, **{**kw, "sweeps": CONVERGED_SWEEPS})
    try:
        yield
    finally:
        gf.jacobi_eigh = real


def _model(work):
    from gcc_tpu_torch.config import EncoderConfig
    from gcc_tpu_torch.models import GraphEncoder

    model = GraphEncoder(EncoderConfig(**ENC))
    model.load_state_dict(torch.load(os.path.join(work, "model.pt")))
    return model.eval()


# ---- the ranks ------------------------------------------------------------

def _child_main(world: int, rank: int, port: int, work: str) -> None:
    import torch.distributed as dist

    from gcc_tpu_torch import generate
    from gcc_tpu_torch.parallel import data_parallel as dp
    from gcc_tpu_torch.parallel import giant_features as gf
    from gcc_tpu_torch.parallel import multihost
    from gcc_tpu_torch.parallel import partitioned as part
    from gcc_tpu_torch.parallel.giant import giant_gin_encode
    from gcc_tpu_torch.parallel.partitioned import place_shard

    torch.set_num_threads(1)
    multihost.initialize_multihost(f"localhost:{port}", world, rank,
                                   device="cpu")
    group = dist.group.WORLD
    model = _model(work)
    out = {}

    # At world size 1 each computation also runs in one process, in this
    # process (the bits of a CPU product may depend on its buffers'
    # alignment, which another process need not share).
    for schedule in SCHEDULES:
        n, pg = _partition(schedule, world)
        rows = pg.num_nodes // world
        lo, hi = rank * rows, (rank + 1) * rows
        q0, mask = _pe_inputs(n, pg.num_nodes)
        with torch.no_grad():
            shard = place_shard(pg, rank, "cpu")
            with _converged_finish():
                out[f"pe_{schedule}"] = gf.giant_laplacian_pe(
                    shard, q0[lo:hi], mask[lo:hi], n, pos_size=SEP_POS,
                    group=group).numpy()
            out[f"span_{schedule}"] = gf.giant_pe_iterate(
                shard, q0[lo:hi], group=group).numpy()
            if world == 1:
                for key, pg_, grp in (
                        ("pe5", place_shard(pg, rank, "cpu"), group),
                        ("pe5_one", part.place_partition(pg, "cpu"), None)):
                    out[f"{key}_{schedule}"] = gf.giant_laplacian_pe(
                        pg_, q0, mask, n, pos_size=SEP_POS,
                        group=grp).numpy()
        n, pg = _partition(schedule, world, weighted=False)
        feats = _encode_features(n, pg.num_nodes)
        mask = (torch.arange(pg.num_nodes) < n).to(torch.float32)
        with torch.no_grad():
            for key, pg_, grp in (("enc", place_shard(pg, rank, "cpu"),
                                   group),
                                  ("enc_one", part.place_partition(pg, "cpu"),
                                   None))[:2 if world == 1 else 1]:
                out[f"{key}_{schedule}"] = giant_gin_encode(
                    model, pg_, feats[lo:hi], mask[lo:hi],
                    group=grp).numpy()

    before = dp.launches.count
    out["e2e"] = gf.giant_graph_embedding(model, _csr(GIANT_SEEDS[0]),
                                          group=group, device="cpu").numpy()
    out["collectives"] = dp.launches.count - before
    if world == 1:
        out["e2e_one"] = gf.giant_graph_embedding(
            model, _csr(GIANT_SEEDS[0]), device="cpu").numpy()

    cfg, graphs = _train_cfg(), _routing_graphs()
    gen = dict(n_max=N_MAX, e_max=E_MAX, device="cpu")
    out["routed"] = generate.generate_graph_embeddings(
        cfg, model, graphs, group=group, **gen)
    out["routed_one"] = generate.generate_graph_embeddings(cfg, model,
                                                           graphs, **gen)

    refusals = {}
    for name, call in (
            ("parts", lambda: gf.giant_graph_embedding(
                model, graphs[0], parts=world + 1, group=group,
                device="cpu")),
            ("composite", lambda: generate.generate_graph_embeddings(
                cfg, model, graphs, readout="composite", group=group,
                **gen))):
        try:
            call()
            refusals[name] = None
        except (ValueError, NotImplementedError) as e:
            refusals[name] = (type(e).__name__, str(e))
    out["refusals"] = refusals
    with open(os.path.join(work, f"w{world}_r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["child"]:
    _child_main(*map(int, sys.argv[2:5]), sys.argv[5])
    sys.exit(0)


# ---- the tests ------------------------------------------------------------

import pytest  # noqa: E402

pytest.importorskip("jax")

import jax  # noqa: E402

from gcc_tpu.config import EncoderConfig as JxEncoderConfig  # noqa: E402
from gcc_tpu.features import featurize_batch as jx_featurize_batch  # noqa: E402
from gcc_tpu.graph.batch import (  # noqa: E402
    Subgraph as JxSubgraph,
    batch_subgraphs as jx_batch_subgraphs,
)
from gcc_tpu.graph.csr import CSRGraph as JxCSRGraph  # noqa: E402
from gcc_tpu.models import GraphEncoder as JxEncoder  # noqa: E402
from gcc_tpu.parallel import giant_features as jx_gf  # noqa: E402
from gcc_tpu.parallel.mesh import make_mesh  # noqa: E402
from gcc_tpu_torch import generate  # noqa: E402
from gcc_tpu_torch.compat import flax_to_state_dict  # noqa: E402
from gcc_tpu_torch.parallel import giant_features as gf  # noqa: E402
from gcc_tpu_torch.parallel import partitioned as part  # noqa: E402
from gcc_tpu_torch.parallel.giant import giant_gin_encode  # noqa: E402

torch.set_num_threads(1)


def _flax_weights(seed=0):
    """A Flax encoder's random weights with non-trivial BatchNorm
    statistics (``tests/test_torch_giant.py``'s recipe)."""
    rng = np.random.default_rng(seed)
    jcfg = JxEncoderConfig(**ENC)
    s = rng.integers(0, 24, 96).astype(np.int32)
    d = rng.integers(0, 24, 96).astype(np.int32)
    toy = jx_batch_subgraphs([JxSubgraph(src=s, dst=d, num_nodes=24)],
                             n_max=32, e_max=256)
    v = JxEncoder(jcfg).init(jax.random.PRNGKey(seed), jx_featurize_batch(
        toy, SEP_POS), train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32),
        v["batch_stats"])
    return jcfg, params, stats


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child_env():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for var in ("LOCAL_WORLD_SIZE", "WORLD_SIZE", "RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    return env


def _wait(procs, timeout):
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """The model's weights first, then the 2 and 4 ranks, and meanwhile
    the reference's embedding of the first separated graph on a (data=1,
    part=2) mesh; returns (reference, {world: [rank results]})."""
    work = str(tmp_path_factory.mktemp("giant_dist"))
    jcfg, params, stats = _flax_weights()
    torch.save(flax_to_state_dict(params, stats),
               os.path.join(work, "model.pt"))
    procs = []
    for world in ALL_WORLDS:
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "child", str(world),
             str(r), str(port), work], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, env=_child_env(), text=True)
            for r in range(world)]
    try:
        g = _csr(GIANT_SEEDS[0])
        ref = np.asarray(jx_gf.giant_graph_embedding(
            jcfg, params, stats,
            JxCSRGraph(indptr=g.indptr, indices=g.indices),
            make_mesh(data=1, part=2)))
    finally:
        _wait(procs, CHILD_TIMEOUT)
    ranks = {}
    for world in ALL_WORLDS:
        ranks[world] = []
        for r in range(world):
            with open(os.path.join(work, f"w{world}_r{r}.pkl"), "rb") as f:
                ranks[world].append(pickle.load(f))
    return ref, ranks, _model(work)


def _row_cosine_errors(a, b):
    return np.abs(a @ a.T - b @ b.T)


def _span_rows(q):
    """Row-normalized orthonormal basis of the span of q's columns (f64
    QR): its row cosines are those of any basis of the span."""
    basis = np.linalg.qr(q.astype(np.float64))[0]
    norm = np.linalg.norm(basis, axis=1, keepdims=True)
    return basis / np.where(norm == 0, 1.0, norm)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_giant_pe_iterate_across_ranks_matches_one_process(dist_run,
                                                           schedule, world):
    """giant_pe_iterate (64 power steps, CholeskyQR every 8) across 2 and
    4 ranks against the one-process form: the iterated span's row cosines
    mean <= 1e-5, max <= 1e-3; padding rows exactly 0."""
    _, ranks, _ = dist_run
    n, pg = _partition(schedule, world)
    q0, _ = _pe_inputs(n, pg.num_nodes)
    with torch.no_grad():
        want = gf.giant_pe_iterate(part.place_partition(pg, "cpu"),
                                   q0).numpy()
    got = np.concatenate([rk[f"span_{schedule}"] for rk in ranks[world]])
    assert got.shape == want.shape
    assert np.abs(got[n:]).max(initial=0.0) == 0.0
    d = _row_cosine_errors(_span_rows(got[:n]), _span_rows(want[:n]))
    print(f"{schedule} D={world}: iterated span row cosines vs one "
          f"process mean {d.mean():.3g}, max {d.max():.3g}")
    assert d.mean() <= 1e-5 and d.max() <= 1e-3, (d.mean(), d.max())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_giant_pe_across_ranks_matches_one_process(dist_run, schedule,
                                                   world):
    """giant_laplacian_pe with its partition axis across 2 and 4 ranks,
    each holding its shard and its block of rows, against the one-process
    form at the same partition count, both with a converged finish
    (module docstring): row cosines mean <= 1e-5, max <= 1e-3 over all
    real rows and over each rank's; padding rows exactly 0 (on ring256,
    ranks past the first hold only padding rows)."""
    _, ranks, _ = dist_run
    n, pg = _partition(schedule, world)
    q0, mask = _pe_inputs(n, pg.num_nodes)
    with torch.no_grad(), _converged_finish():
        want = gf.giant_laplacian_pe(part.place_partition(pg, "cpu"), q0,
                                     mask, n, pos_size=SEP_POS).numpy()
    got = np.concatenate([rk[f"pe_{schedule}"] for rk in ranks[world]])
    assert got.shape == want.shape == (pg.num_nodes, SEP_POS)
    assert np.abs(got[n:]).max(initial=0.0) == 0.0
    d = _row_cosine_errors(got[:n], want[:n])
    print(f"{schedule} D={world}: row cosines vs one process mean "
          f"{d.mean():.3g}, max {d.max():.3g}")
    assert d.mean() <= 1e-5 and d.max() <= 1e-3, (d.mean(), d.max())
    rows = pg.num_nodes // world
    for r in range(world):
        lo, hi = min(r * rows, n), min((r + 1) * rows, n)
        if hi > lo:
            assert d[lo:hi].mean() <= 1e-5 and d[lo:hi].max() <= 1e-3, r


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_giant_encode_across_ranks_matches_one_process(dist_run, schedule,
                                                       world):
    """giant_gin_encode across 2 and 4 ranks on identical features (each
    rank its rows and shard) against the one-process form at the same
    partition count: within 1e-5, and every rank the same bits."""
    _, ranks, model = dist_run
    n, pg = _partition(schedule, world, weighted=False)
    mask = (torch.arange(pg.num_nodes) < n).to(torch.float32)
    with torch.no_grad():
        want = giant_gin_encode(model, part.place_partition(pg, "cpu"),
                                _encode_features(n, pg.num_nodes),
                                mask).numpy()
    got = [rk[f"enc_{schedule}"] for rk in ranks[world]]
    np.testing.assert_allclose(got[0], want, rtol=0, atol=1e-5)
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])


@pytest.mark.parametrize("world", WORLDS)
def test_giant_graph_embedding_across_ranks_matches_reference(dist_run,
                                                              world):
    """giant_graph_embedding across 2 and 4 ranks against the reference's
    on make_mesh(data=1, part=2), the weights bridged by compat.py: within
    1e-5 on the separated graph; every rank the same bits."""
    ref, ranks, _ = dist_run
    got = [rk["e2e"] for rk in ranks[world]]
    np.testing.assert_allclose(got[0], ref, rtol=0, atol=1e-5)
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])


@pytest.mark.parametrize("world", WORLDS)
def test_generate_routes_giant_graphs_across_ranks(dist_run, world):
    """generate_graph_embeddings(group=...) on a list that mixes
    dense-bucket and giant graphs: rows in input order, the dense-bucket
    rows equal to the one-process call's bit for bit, the giant rows
    within 1e-5 of it and of giant_graph_embedding in one process; every
    rank returns the same bits."""
    _, ranks, model = dist_run
    got, one = ranks[world][0]["routed"], ranks[world][0]["routed_one"]
    assert got.shape == (4, ENC["output_size"])
    np.testing.assert_array_equal(got[[1, 3]], one[[1, 3]])
    np.testing.assert_allclose(got[[0, 2]], one[[0, 2]], rtol=0, atol=1e-5)
    graphs = _routing_graphs()
    for i in (0, 2):
        alone = gf.giant_graph_embedding(model, graphs[i],
                                         device="cpu").numpy()
        np.testing.assert_allclose(got[i], alone, rtol=0, atol=1e-5)
    # Each giant row is its own graph's, not the other's.
    assert np.abs(got[0] - got[2]).max() > 1e-2
    for rk in ranks[world][1:]:
        np.testing.assert_array_equal(rk["routed"], got)


def test_collectives_per_giant_graph(dist_run):
    """The calls one giant graph makes on the dense schedule: 9
    CholeskyQR x 2 (norms, Gram), 65 all-gathers (64 power steps and the
    Rayleigh-Ritz product), the whitening and Rayleigh-Ritz Grams, the
    sign rule's max and sum, 4 GIN aggregations and 1 readout: 92 on
    every rank."""
    _, ranks, _ = dist_run
    for world in ALL_WORLDS:
        assert [rk["collectives"] for rk in ranks[world]] == [92] * world


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_world_size_one_gives_the_one_process_bits(dist_run, schedule):
    """In a group of one rank the collectives are identities and the
    path computes what one process computes: the PE, the encode and the
    whole embedding equal the one-process form's bit for bit (as the card
    runs it at world size 1 over NCCL)."""
    _, ranks, _ = dist_run
    (rk,) = ranks[1]
    np.testing.assert_array_equal(rk[f"pe5_{schedule}"],
                                  rk[f"pe5_one_{schedule}"])
    np.testing.assert_array_equal(rk[f"enc_{schedule}"],
                                  rk[f"enc_one_{schedule}"])
    np.testing.assert_array_equal(rk["e2e"], rk["e2e_one"])


@pytest.mark.parametrize("world", WORLDS)
def test_refusals_across_ranks(dist_run, world):
    """A partition count other than the group's size raises ValueError;
    readout='composite' with a giant graph raises NotImplementedError
    with a group too."""
    _, ranks, _ = dist_run
    for rk in ranks[world]:
        assert rk["refusals"]["parts"][0] == "ValueError"
        assert "one shard a rank" in rk["refusals"]["parts"][1]
        assert rk["refusals"]["composite"][0] == "NotImplementedError"


def test_group_without_process_group_raises(dist_run):
    """A group argument without an initialized process group raises, as
    data_parallel() does, from giant_graph_embedding and from
    generate_graph_embeddings' giant path."""
    import torch.distributed as dist

    _, _, model = dist_run
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized process group"):
        gf.giant_graph_embedding(model, _csr(GIANT_SEEDS[0]), group=object(),
                                 device="cpu")
    with pytest.raises(RuntimeError, match="initialized process group"):
        generate.generate_graph_embeddings(
            _train_cfg(), model, _routing_graphs(), n_max=N_MAX,
            e_max=E_MAX, group=object(), device="cpu")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_placed_shard_holds_its_share(schedule, world):
    """place_shard puts 1/D of the partition's array entries on the
    device, those of the rank's own shard: its row block, its edges, or
    its destination buckets (the ring's with the padding common to its
    buckets trimmed, so at most 1/D, and each bucket's edges the same)."""
    n, pg = _partition(schedule, world)
    fields = [f for f in pg._fields if f != "num_nodes"]
    total = sum(getattr(pg, f).size for f in fields)
    for r in range(world):
        sh = part.place_shard(pg, r, "cpu")
        assert (sh.rank, sh.parts, sh.num_nodes) == (r, world, pg.num_nodes)
        held = sum(getattr(sh.shard, f).numel() for f in fields)
        assert all(torch.is_tensor(getattr(sh.shard, f)) for f in fields)
        if not schedule.startswith("ring"):
            assert held * world == total
            for f in fields:
                np.testing.assert_array_equal(getattr(sh.shard, f)[0],
                                              getattr(pg, f)[r])
            continue
        assert held * world <= total
        assert tuple(sh.shard.src_local.shape[:2]) == (1, world)
        for o in range(world):
            def edges(s, d, w):
                live = np.asarray(w) != 0
                return sorted(zip(np.asarray(s)[live], np.asarray(d)[live],
                                  np.asarray(w)[live]))
            assert edges(*(getattr(sh.shard, f)[0, o] for f in fields)) \
                == edges(*(getattr(pg, f)[r, o] for f in fields))
    with pytest.raises(ValueError, match="no shard"):
        part.place_shard(pg, world, "cpu")


def test_cli_generate_across_two_ranks(tmp_path):
    """`cli generate` under torchrun with 2 gloo ranks (--device cpu) on a
    graph-classification dataset whose middle graph is beyond --n-max:
    the ranks join one process group, the giant graph goes across them,
    only rank 0 writes the .npy; its rows equal the one-process command's
    (dense-bucket rows bit for bit, the giant row within 1e-5)."""
    from gcc_tpu_torch import cli
    from gcc_tpu_torch.training.checkpoint import save_checkpoint
    from gcc_tpu_torch.training.pretrain import create_pretrain_state

    cfg = _train_cfg()
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    save_checkpoint(run_dir, create_pretrain_state(cfg, 10, device="cpu"),
                    cfg)
    graphs = [_small_graph(20, 1), _csr(GIANT_SEEDS[0]), _small_graph(25, 2)]
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
    args = ["generate", "--ckpt", os.path.join(run_dir, "current"),
            "--dataset", "rdt-b", "--data-root", str(tmp_path / "data"),
            "--n-max", str(N_MAX), "--e-max", str(E_MAX), "--device", "cpu"]
    two = str(tmp_path / "two.npy")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc-per-node", "2", "--master-addr", "localhost",
         "--master-port", str(_free_port()), "-m", "gcc_tpu_torch.cli",
         *args, "--out", two], capture_output=True, text=True,
        env=_child_env(), cwd=ROOT, timeout=CHILD_TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.count("saved (3, 16)") == 1, res.stdout
    one = str(tmp_path / "one.npy")
    cli.main(args + ["--out", one])
    got, want = np.load(two), np.load(one)
    np.testing.assert_array_equal(got[[0, 2]], want[[0, 2]])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
