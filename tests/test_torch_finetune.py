"""The port's finetuning (gcc_tpu_torch.training.finetune) against
gcc_tpu's: the BN reset, two steps and the eval predictions at bridged
weights, a fold on ring-vs-dense graphs, micro-F1 against sklearn, the
CV folds, and the node dataset's resampling."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from gcc_tpu.config import (  # noqa: E402
    EncoderConfig as JxEncoderConfig,
    OptimConfig as JxOptimConfig,
    SamplerConfig as JxSamplerConfig,
    TrainConfig as JxTrainConfig,
)
from gcc_tpu.graph.batch import (  # noqa: E402
    Subgraph as JxSubgraph,
    batch_subgraphs as jx_batch_subgraphs,
)
from gcc_tpu.graph.csr import CSRGraph as JxCSRGraph  # noqa: E402
from gcc_tpu.training import finetune as jx_finetune  # noqa: E402
from gcc_tpu_torch.compat import (  # noqa: E402
    finetune_to_state_dicts,
    flax_to_state_dict,
    state_dict_to_flax,
    state_dicts_to_finetune,
)
from gcc_tpu_torch.config import (  # noqa: E402
    EncoderConfig,
    OptimConfig,
    SamplerConfig,
    TrainConfig,
)
from gcc_tpu_torch.graph.batch import batch_subgraphs  # noqa: E402
from gcc_tpu_torch.graph.csr import CSRGraph  # noqa: E402
from gcc_tpu_torch.models import GraphEncoder  # noqa: E402
from gcc_tpu_torch.training import finetune  # noqa: E402
from gcc_tpu_torch.training.schedules import lr_at  # noqa: E402
from test_torch_e2e_split import bias_drift, hold_params_and_stats  # noqa: E402
from test_torch_generate import random_subgraphs  # noqa: E402
from test_torch_training import _named_leaves  # noqa: E402

torch.set_num_threads(1)

N_MAX, E_MAX = 32, 512
ENC = dict(num_layers=3, hidden_size=16, output_size=16,
           positional_embedding_size=8, degree_embedding_size=4,
           pe_method="eigh", final_dropout=0.0)


def tiny_cfg(epochs=4):
    return TrainConfig(batch_size=8, epochs=epochs,
                       sampler=SamplerConfig(rw_hops=8),
                       encoder=EncoderConfig(**ENC),
                       optim=OptimConfig(learning_rate=0.01))


def labeled_graphs(n=40, seed=0):
    """Class 0: sparse rings; class 1: dense random graphs (a copy of
    tests/test_finetune.py's, as the port's CSR graphs)."""
    rng = np.random.default_rng(seed)
    graphs, labels = [], []
    for i in range(n):
        size = int(rng.integers(8, 16))
        ring_src = np.arange(size)
        ring_dst = (ring_src + 1) % size
        if i % 2 == 0:
            g = CSRGraph.from_edges(ring_src, ring_dst, num_nodes=size,
                                    symmetrize=True)
            labels.append(0)
        else:
            extra_s = rng.integers(0, size, 3 * size)
            extra_d = rng.integers(0, size, 3 * size)
            keep = extra_s != extra_d
            g = CSRGraph.from_edges(
                np.concatenate([ring_src, extra_s[keep]]),
                np.concatenate([ring_dst, extra_d[keep]]),
                num_nodes=size, symmetrize=True)
            labels.append(1)
        graphs.append(g)
    return graphs, np.array(labels)


def _flax_encoder(rng, batch, stats_random=True):
    enc = jx_finetune.GraphEncoder(JxEncoderConfig(**ENC))
    feats = jx_finetune.featurize_batch(jax.device_put(batch), 8,
                                        pe_method="eigh", profile="eval")
    v = enc.init(jax.random.PRNGKey(0), feats, train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if stats_random else np.asarray(x), v["batch_stats"])
    return params, stats


def _jx_subs(subs):
    return [JxSubgraph(src=s.src, dst=s.dst, num_nodes=s.num_nodes,
                       seed=s.seed) for s in subs]


def test_reset_batch_stats_matches_jax():
    """Running means 0 and variances 1 in every BatchNorm, as the
    reference's reset leaves them; parameters untouched."""
    rng = np.random.default_rng(0)
    subs = random_subgraphs(rng, 4, 10, N_MAX)
    params, stats = _flax_encoder(
        rng, jx_batch_subgraphs(_jx_subs(subs), N_MAX, E_MAX))
    model = GraphEncoder(EncoderConfig(**ENC))
    model.load_state_dict(flax_to_state_dict(params, stats))
    finetune.reset_batch_stats(model)
    p, s = state_dict_to_flax(model.state_dict())
    want = jax.tree_util.tree_map(np.asarray,
                                  jx_finetune.reset_batch_stats(stats))
    got, ref = _named_leaves(s), _named_leaves(want)
    assert got.keys() == ref.keys() and len(got) == 12
    for name in got:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    jax.tree_util.tree_map(np.testing.assert_array_equal, p, params)


TOTAL_STEPS = 10


def test_two_steps_and_predictions_match_jax():
    """Two finetune steps (eval-profile featurize with exact eigh PE on
    gap-separated graphs, masked NLL, clip by value, Adam at the
    warmup-linear rate) against the reference's step from the same
    weights and batches, dropout off: loss and acc within 1e-5 relative
    at each step; params and BN buffers within 1e-5 (the GIN MLP's
    BN-fed biases as tests/test_torch_e2e_split.py holds them); then the
    eval predictions equal."""
    rng = np.random.default_rng(2)
    subs = [random_subgraphs(rng, 8, 10, N_MAX) for _ in range(3)]
    jbatches = [jx_batch_subgraphs(_jx_subs(s), N_MAX, E_MAX) for s in subs]
    batches = [batch_subgraphs(s, n_max=N_MAX, e_max=E_MAX) for s in subs]
    labels = [rng.integers(0, 3, 8) for _ in range(3)]
    masks = [np.ones(8, np.float32), np.r_[np.ones(5), np.zeros(3)]
             .astype(np.float32), np.ones(8, np.float32)]

    jcfg = JxTrainConfig(batch_size=8, encoder=JxEncoderConfig(**ENC),
                         optim=JxOptimConfig(learning_rate=0.01))
    jstate, modules, tx = jx_finetune.create_finetune_state(
        jax.random.PRNGKey(0), jcfg, 3, jbatches[0], TOTAL_STEPS)
    params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstep, jeval = jx_finetune.make_finetune_step(jcfg, modules, tx, 3)

    cfg = tiny_cfg()
    state = finetune.create_finetune_state(cfg, 3, TOTAL_STEPS, device="cpu")
    enc_sd, head_sd = finetune_to_state_dicts(
        params0, jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    state.model.load_state_dict(enc_sd)
    state.head.load_state_dict(head_sd)
    delta = 0.0
    for t in range(2):
        jstate, jm = jstep(jstate, jax.device_put(jbatches[t]),
                           jnp.asarray(labels[t]), jnp.asarray(masks[t]))
        pm = finetune.finetune_step(state, batches[t],
                                    torch.as_tensor(labels[t]),
                                    torch.as_tensor(masks[t]))
        for name in ("loss", "acc"):
            np.testing.assert_allclose(float(pm[name]), float(jm[name]),
                                       rtol=1e-5, err_msg=name)
        delta = max(delta, bias_drift(state.model,
                                      jstate.params["encoder"]))
    p, s = state_dicts_to_finetune(state.model.state_dict(),
                                   state.head.state_dict())
    hold_params_and_stats(p, s, params0, jstate.params, jstate.batch_stats,
                          sum(lr_at(t, 0.01, TOTAL_STEPS) for t in range(2)),
                          delta)
    want = np.asarray(jeval(jstate, jax.device_put(jbatches[2]),
                            jnp.zeros(8, jnp.int32), jnp.asarray(masks[2])))
    got = finetune.finetune_predict(state, batches[2]).numpy()
    np.testing.assert_array_equal(got, want)
    assert state.model.training


def test_finetune_pair_bridge_round_trip():
    """Finetune params (encoder + head) and stats → state_dicts → back:
    exact."""
    jcfg = JxTrainConfig(batch_size=8, encoder=JxEncoderConfig(**ENC))
    rng = np.random.default_rng(3)
    batch = jx_batch_subgraphs(_jx_subs(random_subgraphs(rng, 4, 10, N_MAX)),
                               N_MAX, E_MAX)
    jstate, _, _ = jx_finetune.create_finetune_state(
        jax.random.PRNGKey(1), jcfg, 5, batch, 10)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    stats = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    p, s = state_dicts_to_finetune(*finetune_to_state_dicts(params, stats))
    for a, b in ((params, p), (stats, s)):
        assert jax.tree_util.tree_structure(a) == \
            jax.tree_util.tree_structure(b)
        jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)


def test_finetune_graph_classification_beats_chance():
    """Sparse rings against dense graphs: nearly separable, micro-F1
    above 0.7 (the reference's test of the same data)."""
    graphs, labels = labeled_graphs()
    data = finetune.GraphLabeledData(graphs, labels, n_max=16, e_max=256)
    idx = np.arange(len(labels))
    f1 = finetune.run_finetune_fold(tiny_cfg(epochs=6), data, idx[:32],
                                    idx[32:], log_fn=lambda s: None,
                                    device="cpu")
    assert f1 > 0.7, f1


@pytest.mark.parametrize("seed,classes", [(0, 2), (1, 5), (2, 10)])
def test_micro_f1_matches_sklearn(seed, classes):
    from sklearn.metrics import f1_score

    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, 97)
    pred = np.where(rng.random(97) < 0.6, y, rng.integers(0, classes, 97))
    assert finetune.micro_f1(y, pred) == pytest.approx(
        f1_score(y, pred, average="micro"), abs=1e-12)


@pytest.mark.parametrize("seed,labels", [
    (0, np.arange(30) % 2),
    (1, np.repeat([3, 0, 7], [40, 25, 12])),
    (2, np.random.default_rng(9).integers(0, 5, 203)),
    (3, np.array(["b", "a"] * 12 + ["c"] * 4))])
def test_stratified_kfold_matches_sklearn(seed, labels):
    """The port's copy of StratifiedKFold(10, shuffle=True) hands out the
    same folds as scikit-learn's, on balanced, skewed, unordered and
    string labels (one class smaller than the fold count)."""
    from sklearn.model_selection import StratifiedKFold

    want = StratifiedKFold(n_splits=10, shuffle=True, random_state=seed
                           ).split(np.zeros(len(labels)), labels)
    got = finetune.stratified_kfold(labels, 10, seed)
    for (a, b), (c, d) in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_cv_folds_match_jax(monkeypatch):
    """run_finetune_cv hands each fold the reference's train/test split
    (StratifiedKFold, shuffled with the seed), and averages the folds."""
    graphs, labels = labeled_graphs(n=30)
    seen = {"port": [], "jax": []}

    def record(side):
        def fold(cfg, data, train_idx, test_idx, *args, **kwargs):
            seen[side].append((train_idx, test_idx))
            return len(seen[side]) / 10
        return fold

    monkeypatch.setattr(finetune, "run_finetune_fold", record("port"))
    monkeypatch.setattr(jx_finetune, "run_finetune_fold", record("jax"))
    data = finetune.GraphLabeledData(graphs, labels, n_max=16, e_max=256)
    res = finetune.run_finetune_cv(tiny_cfg(), data, log_fn=lambda s: None,
                                   device="cpu")
    jx_data = jx_finetune.GraphLabeledData(
        [JxCSRGraph(indptr=g.indptr, indices=g.indices)
         for g in graphs], labels, n_max=16, e_max=256)
    want = jx_finetune.run_finetune_cv(
        JxTrainConfig(batch_size=8), jx_data, log_fn=lambda s: None)
    assert len(seen["port"]) == len(seen["jax"]) == 10
    for (a, b), (c, d) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert res == want


def test_finetune_cv_runs_two_folds():
    graphs, labels = labeled_graphs(n=30)
    data = finetune.GraphLabeledData(graphs, labels, n_max=16, e_max=256)
    res = finetune.run_finetune_cv(tiny_cfg(epochs=2), data, folds=range(2),
                                   log_fn=lambda s: None, device="cpu")
    assert len(res["folds"]) == 2
    assert 0.0 <= res["mean"] <= 1.0


def test_node_data_resamples_per_epoch_and_matches_jax():
    """Each epoch seed draws new RWR subgraphs; the same seed draws the
    same ones — the reference's, from the same C++ sampler."""
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 100, 400), rng.integers(0, 100, 400)
    g = CSRGraph.from_edges(src, dst, num_nodes=100, symmetrize=True)
    y = np.zeros((100, 2), np.float32)
    y[np.arange(100), rng.integers(0, 2, 100)] = 1
    data = finetune.NodeLabeledData(g, y, tiny_cfg(), n_max=16, e_max=128)
    idx = np.arange(8)
    a = data.subgraphs_for(idx, epoch_seed=1)
    b = data.subgraphs_for(idx, epoch_seed=2)
    c = data.subgraphs_for(idx, epoch_seed=1)
    assert any(x.num_nodes != y2.num_nodes or not np.array_equal(x.src, y2.src)
               for x, y2 in zip(a, b))
    for x, y2 in zip(a, c):
        assert np.array_equal(x.src, y2.src) and x.num_nodes == y2.num_nodes
    jx_g = JxCSRGraph.from_edges(src, dst, num_nodes=100, symmetrize=True)
    jx_data = jx_finetune.NodeLabeledData(
        jx_g, y, JxTrainConfig(sampler=JxSamplerConfig(rw_hops=8)),
        n_max=16, e_max=128)
    np.testing.assert_array_equal(data.labels, jx_data.labels)
    for x, y2 in zip(a, jx_data.subgraphs_for(idx, epoch_seed=1)):
        assert x.num_nodes == y2.num_nodes
        np.testing.assert_array_equal(x.src, y2.src)
        np.testing.assert_array_equal(x.dst, y2.dst)
