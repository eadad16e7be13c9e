"""The port's size-split E2E dispatch against gcc_tpu's: the spec parser,
the slotting, the per-class featurize (on wire batches from the port's
sampler pipeline and on a batch that overflows the large class), three
split steps at bridged weights, and run_pretrain logging the overflow."""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from gcc_tpu.config import (  # noqa: E402
    ContrastConfig as JxContrast,
    EncoderConfig as JxEncoderConfig,
    TrainConfig as JxTrainConfig,
)
from gcc_tpu.contrastive import MoCoQueue as JxQueue  # noqa: E402
from gcc_tpu.graph.batch import CompactWireBatch as JxWire  # noqa: E402
from gcc_tpu.models import GraphEncoder as JxEncoder  # noqa: E402
from gcc_tpu.training.optim import build_optimizer as jx_optimizer  # noqa: E402
from gcc_tpu.training.pretrain import (  # noqa: E402
    PretrainState as JxState,
    featurize_e2e_split as jx_featurize_e2e_split,
    make_e2e_split_step,
    parse_e2e_split as jx_parse_e2e_split,
)
from gcc_tpu.training.schedules import make_lr_schedule  # noqa: E402
from gcc_tpu_torch.compat import flax_to_state_dict, state_dict_to_flax  # noqa: E402
from gcc_tpu_torch.config import (  # noqa: E402
    ContrastConfig,
    EncoderConfig,
    OptimConfig,
    SamplerConfig,
    TrainConfig,
)
from gcc_tpu_torch.features.featurize import BatchFeatures  # noqa: E402
from gcc_tpu_torch.graph.batch import CompactWireBatch, pack_edge_ids  # noqa: E402
from gcc_tpu_torch.graph.corpus import CorpusStore, synthetic_corpus  # noqa: E402
from gcc_tpu_torch.models import GraphEncoder  # noqa: E402
from gcc_tpu_torch.sampling.pipeline import (  # noqa: E402
    PipelineConfig,
    PretrainPipeline,
)
from gcc_tpu_torch.training.loop import run_pretrain  # noqa: E402
from gcc_tpu_torch.training.optim import build_optimizer  # noqa: E402
from gcc_tpu_torch.training.schedules import lr_at  # noqa: E402
from gcc_tpu_torch.training.pretrain import (  # noqa: E402
    PretrainState,
    create_pretrain_state,
    e2e_split_slots,
    e2e_split_step,
    featurize_e2e_split,
    parse_e2e_split,
    train_dispatch,
)
from test_torch_models import SMALL  # noqa: E402
from test_torch_training import _named_leaves, _tree_close  # noqa: E402

torch.set_num_threads(1)

B, N_MAX, POS = 8, 32, 8
SPEC = "16:4"
CLASSES = ((16, 4), (32, 4))


def tiny_cfg(moco=False, e2e_split=SPEC):
    return TrainConfig(
        batch_size=B, epochs=2, num_samples=64, num_workers=0,
        sampler=SamplerConfig(rw_hops=16),
        encoder=EncoderConfig(hidden_size=16, output_size=16,
                              positional_embedding_size=POS,
                              degree_embedding_size=4, pe_method="eigh"),
        contrast=ContrastConfig(moco=moco, nce_k=32, e2e_split=e2e_split),
        optim=OptimConfig(learning_rate=0.01),
    )


def stacked_pcfg(**kw):
    return PipelineConfig(**{**dict(batch_size=B, n_max=N_MAX, e_max=512,
                                    num_samples=64, num_workers=0,
                                    emit="stacked", super_batch=2), **kw})


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("corpus"))
    synthetic_corpus(path, num_graphs=2, nodes_per_graph=300, avg_degree=6)
    return path


@pytest.fixture(scope="module")
def wires(corpus):
    """Two stacked (query, key) items of 2 steps x 8 pairs, n_max 32."""
    with PretrainPipeline(CorpusStore.open(corpus), SamplerConfig(rw_hops=16),
                          stacked_pcfg(), seed=0) as pipe:
        return [next(pipe) for _ in range(2)]


def _random_pair_graph(rng, n):
    e = 3 * n
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = src != dst
    return (np.concatenate([src[keep], dst[keep]]),
            np.concatenate([dst[keep], src[keep]]), n)


def overflow_wires():
    """One step of 8 pairs, 6 of them with a view above 16 nodes: two
    more than the 32 class's 4 slots, so two big pairs are forced into
    the 16 bucket and lose the edges that leave it."""
    rng = np.random.default_rng(3)
    sizes = [(20, 12), (30, 9), (10, 25), (8, 8), (18, 30), (16, 9),
             (32, 17), (12, 28)]
    out = []
    for side in (0, 1):
        graphs = [_random_pair_graph(rng, p[side]) for p in sizes]
        src = np.concatenate([g[0] for g in graphs])
        dst = np.concatenate([g[1] for g in graphs])
        packed, bits = pack_edge_ids(src, dst, N_MAX)
        edges = np.zeros(2048, np.uint16)
        edges[:packed.size] = packed
        meta = np.array([[g[2] for g in graphs], [len(g[0]) for g in graphs],
                         [side] * len(graphs)], np.int32)
        out.append(CompactWireBatch(edges=edges[None], meta=meta[None],
                                    e_max=512, id_bits=bits, n_max=0))
    return tuple(out)


def _jx_wire(w: CompactWireBatch) -> JxWire:
    return JxWire(edges=jnp.asarray(w.edges), meta=jnp.asarray(w.meta),
                  e_max=w.e_max, id_bits=w.id_bits, n_max=w.n_max)


@pytest.mark.parametrize("spec,batch,n_max", [
    ("128:240", 256, 256), ("80:224,128:20", 256, 256), ("", 256, 256),
    ("128:240", 256, None), ("128:240", 240, 256), ("128:256", 256, 256),
    ("128:100,80:100", 256, 256), ("128:100,128:100", 256, 256),
    ("256:100", 256, 256), ("128:0", 256, 256), ("128:240", 8, 32),
    (SPEC, B, N_MAX)])
def test_parse_e2e_split_matches_jax(spec, batch, n_max):
    """The parser's classes (or None where the spec does not apply) are
    the reference's."""
    assert parse_e2e_split(spec, batch, n_max) == jx_parse_e2e_split(
        spec, batch, n_max)


def test_parse_e2e_split_cases():
    assert parse_e2e_split("128:240", 256, 256) == ((128, 240), (256, 16))
    assert parse_e2e_split("128:240", 8, 32) is None
    assert parse_e2e_split(SPEC, B, N_MAX) == CLASSES
    assert parse_e2e_split("", B, N_MAX) is None


def test_plain_step_where_the_split_does_not_apply(wires):
    """The default spec does not fit a batch of 8: the dispatch runs the
    plain E2E step and reports no overflow."""
    state = create_pretrain_state(tiny_cfg(e2e_split="128:240"), 8,
                                  device="cpu")
    metrics = train_dispatch(state, *wires[0], n_max=N_MAX)
    assert "e2e_split_overflow" not in metrics
    assert metrics["loss"].shape == (2,) and state.step == 2


def _exact_top(adj, n_b, k):
    """Descending eigenvalues of the normalized adjacency's real block."""
    a = adj[:n_b, :n_b].astype(np.float64)
    d = np.maximum(a.sum(axis=1), 1.0)
    return np.linalg.eigvalsh(a / np.sqrt(d)[:, None] / np.sqrt(d)[None, :]
                              )[::-1][:k]


@pytest.mark.parametrize("which", ["sampled", "overflow"])
def test_featurize_e2e_split_matches_jax(wires, which):
    """Slot order and rank, overflow, and every class's adjacency,
    degrees, node mask and seed flag equal the reference's exactly; PE
    (exact eigh on both sides) within 1e-4 on every graph whose top
    k_b + 1 eigenvalues are separated by >= 0.02 (within a cluster any
    rotation is an equally valid PE, and the row normalization carries
    it into every column; where two entries tie for a column's largest
    magnitude the sign rule has no preference, and that column is
    compared up to sign), and the same columns masked to zero."""
    checked = 0
    for wq, wk in (wires if which == "sampled" else [overflow_wires()]):
        feats, overflow = featurize_e2e_split(wq, wk, POS, "eigh", CLASSES,
                                              n_max=N_MAX, device="cpu")
        want, want_over = jax.jit(lambda a, b: jx_featurize_e2e_split(
            a, b, POS, "eigh", CLASSES, N_MAX))(_jx_wire(wq), _jx_wire(wk))
        np.testing.assert_array_equal(overflow.numpy(), np.asarray(want_over))
        if which == "overflow":
            assert overflow.tolist() == [2]

        # The reference's slotting lines (pretrain.py:398-402), on its side.
        nq, nk = jnp.asarray(wq.meta[:, 0]), jnp.asarray(wk.meta[:, 0])
        mx = jnp.maximum(nq, nk)
        cls = sum((mx > n_b).astype(mx.dtype) for n_b, _ in CLASSES[:-1])
        jx_order = jnp.argsort(cls, axis=1, stable=True)
        order, rank, _ = e2e_split_slots(torch.as_tensor(wq.meta[:, 0]),
                                         torch.as_tensor(wk.meta[:, 0]),
                                         CLASSES)
        np.testing.assert_array_equal(order.numpy(), np.asarray(jx_order))
        np.testing.assert_array_equal(
            rank.numpy(), np.asarray(jnp.argsort(jx_order, axis=1)))

        for got, ref in zip(feats, want):
            for name in ("adj", "degrees", "node_mask", "seed_flag"):
                np.testing.assert_array_equal(getattr(got, name).numpy(),
                                              np.asarray(getattr(ref, name)),
                                              err_msg=name)
            pos, ref_pos = got.pos.numpy(), np.asarray(ref.pos)
            np.testing.assert_array_equal(np.abs(pos).sum(axis=-2) > 0,
                                          np.abs(ref_pos).sum(axis=-2) > 0)
            adj = np.asarray(ref.adj)
            n_nodes = np.asarray(ref.node_mask).sum(-1).astype(int)
            for idx in np.ndindex(n_nodes.shape):
                n_b = n_nodes[idx]
                k_b = min(max(n_b - 2, 0), POS)
                lam = _exact_top(adj[idx], n_b, k_b + 1)
                if k_b == 0 or np.min(-np.diff(lam)) < 0.02:
                    continue
                a, b = pos[idx][:, :k_b].copy(), ref_pos[idx][:, :k_b]
                for j in range(k_b):
                    top2 = np.sort(np.abs(b[:, j]))[-2:]
                    if top2[1] - top2[0] < 1e-5 and a[:, j] @ b[:, j] < 0:
                        a[:, j] *= -1   # a tie for the largest |entry|
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                           err_msg=str(idx))
                checked += 1
    assert checked >= 10, checked


TOTAL_STEPS = 10  # lr 0 at the first update, then > 0


def test_three_split_steps_match_jax(wires):
    """Three size-split steps against make_e2e_split_step from the same
    parameters and the same features (the reference's featurize, eigh
    PE), dropout off: loss, prob and grad_norm within 1e-5 relative;
    params within 1e-5 abs; the running buffers, threaded q-small →
    q-large → k-small → k-large, within 1e-5 abs + relative, but for
    the GIN MLP's BN-fed biases and the means they shift
    (:func:`hold_params_and_stats`)."""
    steps = []
    for wq, wk in wires:
        feats, _ = jax.jit(lambda a, b: jx_featurize_e2e_split(
            a, b, POS, "eigh", CLASSES, N_MAX))(_jx_wire(wq), _jx_wire(wk))
        for t in range(2):
            steps.append(tuple(jax.tree_util.tree_map(
                lambda x: np.asarray(x[t]), f) for f in feats))
    steps = steps[:3]

    contrast = dict(moco=False, nce_k=B - 1, e2e_split=SPEC)
    jcfg = JxTrainConfig(batch_size=B, encoder=JxEncoderConfig(**SMALL),
                         contrast=JxContrast(**contrast))
    cfg = TrainConfig(batch_size=B, encoder=EncoderConfig(**SMALL),
                      contrast=ContrastConfig(**contrast))
    enc = JxEncoder(jcfg.encoder)
    v = enc.init(jax.random.PRNGKey(0), jax.tree_util.tree_map(
        lambda x: jnp.asarray(x[:4]), steps[0][0]), train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    tx = jx_optimizer(jcfg.optim, make_lr_schedule(
        jcfg.optim.learning_rate, TOTAL_STEPS, jcfg.optim.warmup))
    jstate = JxState(
        params=params, batch_stats=stats, ema_params=params,
        ema_batch_stats=stats,
        queue=JxQueue(memory=jnp.zeros((B - 1, 16)),
                      index=jnp.zeros((), jnp.int32)),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
        dropout_rng=jax.random.PRNGKey(1),
        nce_z=jnp.full((), -1.0, jnp.float32))
    jstep = jax.jit(make_e2e_split_step(jcfg, enc, tx))

    model = GraphEncoder(cfg.encoder)
    model.load_state_dict(flax_to_state_dict(params, stats))
    state = PretrainState(
        cfg=cfg, model=model, ema_model=GraphEncoder(cfg.encoder),
        optimizer=build_optimizer(model.parameters(), cfg.optim),
        queue=create_pretrain_state(cfg, 1, device="cpu").queue,
        dropout_gen=torch.Generator().manual_seed(0),
        total_steps=TOTAL_STEPS)
    delta = 0.0
    for feats in steps:
        jstate, jm = jstep(jstate, tuple(jax.tree_util.tree_map(
            jnp.asarray, f) for f in feats))
        pm = e2e_split_step(state, tuple(
            BatchFeatures(*(torch.as_tensor(np.array(x)) for x in f))
            for f in feats))
        for name in ("loss", "prob", "grad_norm"):
            np.testing.assert_allclose(float(pm[name]), float(jm[name]),
                                       rtol=1e-5, err_msg=name)
        delta = max(delta, bias_drift(model, jstate.params))
    assert state.step == int(jstate.step) == 3
    p, s = state_dict_to_flax(model.state_dict())
    hold_params_and_stats(p, s, params, jstate.params, jstate.batch_stats,
                          sum(lr_at(t, 0.01, TOTAL_STEPS) for t in range(3)),
                          delta)


MLP_BIASES = tuple(f"['GINMLP_{i}']{b}" for i in range(2)
                   for b in ("['Linear_0']['bias']", "['Linear_1']['bias']"))
# The BatchNorms whose input each of those biases shifts.
BN_FED = tuple(f"['GINMLP_{i}']['MaskedBatchNorm_0']['mean']"
               for i in range(2)) + tuple(
    f"['UnsupervisedGIN_0']['MaskedBatchNorm_{2 * i}']['mean']"
    for i in range(2))


def bias_drift(model, jx_params) -> float:
    """Largest |difference| of the BN-fed MLP biases between the port and
    the reference."""
    p = _named_leaves(state_dict_to_flax(model.state_dict())[0])
    jp = _named_leaves(jx_params)
    return max(float(np.abs(p[k] - jp[k]).max())
               for k in p if any(b in k for b in MLP_BIASES))


def hold_params_and_stats(p, s, p0, jx_params, jx_stats, lr_sum, delta):
    """Params within 1e-5 abs and BN buffers within 1e-5 abs + relative,
    except where the GIN MLP's BN-fed biases act. Their true gradient is
    zero, so both chains step on rounding noise
    (tests/test_torch_training.py): each moved by at most the summed lr.
    A bias only shifts the mean of the BatchNorm it feeds (not its
    variance), so that running mean may differ by the largest bias
    difference seen, ``delta``, on top of 1e-5."""
    _tree_close(p, jx_params, 1e-5, skip=MLP_BIASES)
    _tree_close(s, jx_stats, 1e-5, rtol=1e-5, skip=BN_FED)
    _tree_close(s, jx_stats, 1e-5 + delta, rtol=1e-5)
    p_now, p_jx, p_0 = (_named_leaves(x) for x in (p, jx_params, p0))
    for name in p_now:
        if any(b in name for b in MLP_BIASES):
            assert np.abs(p_now[name] - p_0[name]).max() <= lr_sum, name
            assert np.abs(p_jx[name] - p_0[name]).max() <= lr_sum, name


@pytest.mark.parametrize("spec,overflows", [(SPEC, False), ("4:7", True)])
def test_run_pretrain_logs_split_overflow(tmp_path, corpus, spec, overflows):
    """An E2E run whose spec applies writes e2e_split_overflow on every
    metrics line; where pairs overflow (most views exceed 4 nodes, one
    large slot) it warns."""
    logs = []
    summary = run_pretrain(tiny_cfg(e2e_split=spec), corpus,
                           str(tmp_path / "out"), stacked_pcfg(),
                           log_fn=logs.append, steps_per_call=2,
                           device="cpu")
    assert summary["steps"] == 16
    with open(os.path.join(summary["run_dir"], "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [rec["step"] for rec in lines] == list(range(16))
    assert all(np.isfinite(rec["loss"]) for rec in lines)
    over = [rec["e2e_split_overflow"] for rec in lines]
    assert all(isinstance(o, int) and o >= 0 for o in over)
    warned = [line for line in logs if "e2e split overflow" in line]
    assert (min(over) > 0) == overflows
    assert len(warned) == sum(o > 0 for o in over)
