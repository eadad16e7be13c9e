"""The single-device loose ends of the port against gcc_tpu: the encoder
without degree input (forward in both modes and two MoCo steps against
Flax), the padded pairs wire (``expand_wire`` and ``featurize_pair`` on
``WireBatch`` pairs, ``run_pretrain`` with ``compact_wire=False``) and
the pipeline's forked sampler processes (``mode="process"``)."""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from gcc_tpu.config import (  # noqa: E402
    ContrastConfig as JxContrast,
    EncoderConfig as JxEncoderConfig,
    TrainConfig as JxTrainConfig,
)
from gcc_tpu.contrastive import MoCoQueue as JxQueue  # noqa: E402
from gcc_tpu.features.featurize import BatchFeatures as JxFeatures  # noqa: E402
from gcc_tpu.graph import batch as jx_batch  # noqa: E402
from gcc_tpu.models import GraphEncoder as JxEncoder  # noqa: E402
from gcc_tpu.training import pretrain as jx_pretrain  # noqa: E402
from gcc_tpu.training.optim import build_optimizer as jx_optimizer  # noqa: E402
from gcc_tpu.training.schedules import make_lr_schedule  # noqa: E402
from gcc_tpu_torch.compat import flax_to_state_dict, state_dict_to_flax  # noqa: E402
from gcc_tpu_torch.config import (  # noqa: E402
    ContrastConfig,
    EncoderConfig,
    OptimConfig,
    SamplerConfig,
    TrainConfig,
)
from gcc_tpu_torch.contrastive import MoCoQueue  # noqa: E402
from gcc_tpu_torch.features.featurize import BatchFeatures  # noqa: E402
from gcc_tpu_torch.graph.batch import WireBatch, expand_wire  # noqa: E402
from gcc_tpu_torch.graph.corpus import CorpusStore, synthetic_corpus  # noqa: E402
from gcc_tpu_torch.models import GraphEncoder  # noqa: E402
from gcc_tpu_torch.sampling.pipeline import (  # noqa: E402
    PipelineConfig,
    PretrainPipeline,
    ShardSampler,
)
from gcc_tpu_torch.training.checkpoint import load_checkpoint  # noqa: E402
from gcc_tpu_torch.training.loop import run_pretrain  # noqa: E402
from gcc_tpu_torch.training.optim import build_optimizer  # noqa: E402
from gcc_tpu_torch.training.pretrain import (  # noqa: E402
    PretrainState,
    featurize_pair,
    train_step,
)
from gcc_tpu_torch.training.schedules import lr_at  # noqa: E402
from test_torch_generate import random_subgraphs  # noqa: E402
from test_torch_models import SMALL, random_features  # noqa: E402
from test_torch_training import (  # noqa: E402
    B,
    K,
    TOTAL_STEPS,
    _grad_recorder,
    _named_leaves,
    _port_grads,
    _tree_close,
)

torch.set_num_threads(1)

NO_DEGREE = dict(SMALL, degree_input=False)


def _to_jx(f):
    return JxFeatures(**{k: jnp.asarray(v) for k, v in f.items()})


def _to_pt(f):
    return BatchFeatures(**{k: torch.as_tensor(v) for k, v in f.items()})


@pytest.mark.parametrize("train", [True, False])
def test_encoder_without_degree_input_matches_flax(train):
    """degree_input=False: features [PE, seed flag] (pos + 1 wide), no
    degree embedding on either side; embeddings within 1e-5 abs in train
    and eval mode, and the bridge exact both ways."""
    rng = np.random.default_rng(0)
    f = random_features(rng)
    enc = JxEncoder(JxEncoderConfig(**NO_DEGREE))
    v = enc.init(jax.random.PRNGKey(0), _to_jx(f), train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32),
        v["batch_stats"])
    assert "DegreeEmbedding_0" not in params
    if train:
        want, _ = enc.apply({"params": params, "batch_stats": stats},
                            _to_jx(f), train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(1)})
    else:
        want = enc.apply({"params": params, "batch_stats": stats},
                         _to_jx(f), train=False)
    cfg = EncoderConfig(**NO_DEGREE)
    model = GraphEncoder(cfg)
    assert model.degree_embedding is None and cfg.node_input_dim == 8 + 1
    model.load_state_dict(flax_to_state_dict(params, stats))
    model.train(train)
    got = model(_to_pt(f)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    p2, s2 = state_dict_to_flax(GraphEncoder(cfg).state_dict()
                                | flax_to_state_dict(params, stats))
    assert jax.tree_util.tree_structure(p2) == \
        jax.tree_util.tree_structure(params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, params, p2)
    jax.tree_util.tree_map(np.testing.assert_array_equal, stats, s2)


def test_two_moco_steps_without_degree_input_match_jax(monkeypatch):
    """Two MoCo steps of the encoder without degree input against the
    reference's step, as tests/test_torch_training.py holds the
    canonical encoder's: loss, prob and grad_norm within 1e-5 relative,
    the clipped gradients, params, EMA params and the queue within 1e-5
    abs; the BatchNorm-fed MLP biases (true gradient 0) within the
    summed lr."""
    monkeypatch.setenv("GCC_TPU_MERGED_QK", "0")
    rng = np.random.default_rng(3)
    steps = [(random_features(rng, b=B), random_features(rng, b=B))
             for _ in range(2)]
    queue0 = rng.uniform(-0.4, 0.4, (K, 16)).astype(np.float32)
    jcfg = JxTrainConfig(batch_size=B, encoder=JxEncoderConfig(**NO_DEGREE),
                         contrast=JxContrast(moco=True, nce_k=K))
    enc = JxEncoder(jcfg.encoder)
    v = enc.init(jax.random.PRNGKey(0), _to_jx(steps[0][0]), train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    tx = optax.chain(_grad_recorder(), jx_optimizer(
        jcfg.optim, make_lr_schedule(jcfg.optim.learning_rate, TOTAL_STEPS,
                                     jcfg.optim.warmup)))
    jstate = jx_pretrain.PretrainState(
        params=params, batch_stats=stats, ema_params=params,
        ema_batch_stats=stats,
        queue=JxQueue(memory=jnp.asarray(queue0),
                      index=jnp.zeros((), jnp.int32)),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
        dropout_rng=jax.random.PRNGKey(1),
        nce_z=jnp.full((), -1.0, jnp.float32))
    jstep = jax.jit(jx_pretrain.make_step_from_feats(jcfg, enc, tx))

    cfg = TrainConfig(batch_size=B, encoder=EncoderConfig(**NO_DEGREE),
                      contrast=ContrastConfig(moco=True, nce_k=K))
    model = GraphEncoder(cfg.encoder)
    model.load_state_dict(flax_to_state_dict(params, stats))
    ema = copy.deepcopy(model).requires_grad_(False)
    state = PretrainState(
        cfg=cfg, model=model, ema_model=ema,
        optimizer=build_optimizer(model.parameters(), cfg.optim),
        queue=MoCoQueue(memory=torch.as_tensor(queue0.copy()),
                        index=torch.zeros((), dtype=torch.int64)),
        dropout_gen=torch.Generator().manual_seed(0),
        total_steps=TOTAL_STEPS)
    mlp_biases = tuple(f"['GINMLP_{i}']{b}" for i in range(2)
                       for b in ("['Linear_0']['bias']",
                                 "['Linear_1']['bias']"))
    p0 = _named_leaves(params)
    lr_sum = 0.0
    for t, (fq, fk) in enumerate(steps):
        jstate, jm = jstep(jstate, _to_jx(fq), _to_jx(fk))
        pm = train_step(state, _to_pt(fq), _to_pt(fk))
        for name in ("loss", "prob", "grad_norm"):
            np.testing.assert_allclose(float(pm[name]), float(jm[name]),
                                       rtol=1e-5, err_msg=name)
        lr_sum += lr_at(t, cfg.optim.learning_rate, TOTAL_STEPS,
                        cfg.optim.warmup)
        clip = min(1.0, cfg.optim.clip_norm / float(jm["grad_norm"]))
        jg = {k: v * clip for k, v in
              _named_leaves(jstate.opt_state[0]).items()}
        _tree_close(_named_leaves(_port_grads(model)), jg, 1e-5)
    p, _ = state_dict_to_flax(model.state_dict())
    pe, _ = state_dict_to_flax(ema.state_dict())
    _tree_close(p, jstate.params, 1e-5, skip=mlp_biases)
    _tree_close(pe, jstate.ema_params, 1e-5)
    p_now = _named_leaves(p)
    assert lr_sum > 0
    for name in p_now:
        if any(b in name for b in mlp_biases):
            assert 0 < np.abs(p_now[name] - p0[name]).max() <= lr_sum, name
    np.testing.assert_allclose(state.queue.memory.numpy(),
                               np.asarray(jstate.queue.memory), rtol=0,
                               atol=1e-5)
    assert int(state.queue.index) == int(jstate.queue.index) == 2 * B


N_MAX, E_MAX, POS = 32, 256, 8


def _wire(subs, rng):
    """A padded WireBatch of `subs`, int16 endpoints, with garbage past
    every graph's edge count (which both expansions must ignore)."""
    b = len(subs)
    src = rng.integers(0, N_MAX, (b, E_MAX)).astype(np.int16)
    dst = rng.integers(0, N_MAX, (b, E_MAX)).astype(np.int16)
    for i, s in enumerate(subs):
        src[i, :len(s.src)] = s.src
        dst[i, :len(s.dst)] = s.dst
    return dict(src=src, dst=dst,
                n_nodes=np.array([s.num_nodes for s in subs], np.int32),
                n_edges=np.array([len(s.src) for s in subs], np.int32),
                seed_pos=np.array([s.seed for s in subs], np.int32))


def test_expand_wire_and_featurize_pair_match_jax():
    """expand_wire equals gcc_tpu's field by field; featurize_pair on a
    padded WireBatch pair (both views in one featurize_batch) gives
    gcc_tpu's adjacency, degrees, masks and seed flags exactly and its
    exact-eigh PE within 1e-4 on gap-separated graphs."""
    rng = np.random.default_rng(7)
    subs = random_subgraphs(rng, 8, 12, N_MAX)
    wq, wk = _wire(subs[:4], rng), _wire(subs[4:], rng)
    ours = expand_wire(WireBatch(**wq), N_MAX)
    ref = jx_batch.expand_wire(jx_batch.WireBatch(
        **{k: jnp.asarray(v) for k, v in wq.items()}), N_MAX)
    for field in dataclasses.fields(ours):
        a, b = getattr(ours, field.name), np.asarray(getattr(ref,
                                                             field.name))
        assert a.dtype == b.dtype and np.array_equal(a, b), field.name
    fq, fk = featurize_pair(WireBatch(**wq), WireBatch(**wk), POS,
                            n_max=N_MAX, device="cpu", pe_method="eigh")
    jq, jk = jx_pretrain.featurize_pair(
        *(jx_batch.WireBatch(**{k: jnp.asarray(v) for k, v in w.items()})
          for w in (wq, wk)), POS, "eigh", N_MAX)
    for got, want in ((fq, jq), (fk, jk)):
        for name in ("adj", "degrees", "node_mask", "seed_flag"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
        np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                                   rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("corpus"))
    synthetic_corpus(path, num_graphs=3, nodes_per_graph=300, avg_degree=6)
    return path


def test_run_pretrain_on_the_padded_pairs_wire(tmp_path, corpus):
    """compact_wire=False: run_pretrain trains one step per padded pair
    — 16 steps in 2 epochs, finite metric lines, the queue and the step
    counter advanced in the checkpoint."""
    cfg = TrainConfig(
        batch_size=8, epochs=2, num_samples=64, num_workers=0,
        sampler=SamplerConfig(rw_hops=16),
        encoder=EncoderConfig(hidden_size=16, output_size=16,
                              positional_embedding_size=8,
                              degree_embedding_size=4, pe_method="eigh"),
        contrast=ContrastConfig(moco=True, nce_k=32),
        optim=OptimConfig(learning_rate=0.01))
    pcfg = PipelineConfig(batch_size=8, n_max=32, e_max=512, num_samples=64,
                          num_workers=0, compact_wire=False)
    summary = run_pretrain(cfg, corpus, str(tmp_path / "out"), pcfg,
                           log_fn=lambda _: None, device="cpu")
    assert summary["steps"] == 16 and summary["epoch"] == 2
    with open(os.path.join(summary["run_dir"], "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines] == list(range(16))
    assert all(np.isfinite([r["loss"], r["prob"], r["grad_norm"]]).all()
               for r in lines)
    saved = load_checkpoint(os.path.join(summary["run_dir"], "current"))
    assert saved["step"] == 16
    assert int(saved["queue"]["index"]) == 16 * 8 % 32


def _same_item(a, b) -> bool:
    """Equal (query, key) items; a padded WireBatch is compared as it
    expands (its row tails past n_edges hold whatever the reused sampler
    buffers held)."""
    def fields(x):
        if isinstance(x, WireBatch):
            x = expand_wire(x, 32)
        return [np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)]

    return all(type(x) is type(y) and all(
        np.array_equal(u, v) for u, v in zip(fields(x), fields(y)))
        for x, y in zip(a, b))


@pytest.mark.parametrize("compact_wire", [True, False])
def test_process_mode_yields_the_thread_mode_items(corpus, compact_wire):
    """Forked workers (mode="process") and threads yield the same items
    for one seed, up to the order in which the two workers' streams
    interleave: every item taken is the next one of the stream that
    worker w samples alone (seed + 7919·(w + 1), its shard of the
    corpus)."""
    store = CorpusStore.open(corpus)
    sampler = SamplerConfig(rw_hops=16)
    pcfg = PipelineConfig(batch_size=8, n_max=32, e_max=512, num_samples=64,
                          num_workers=2, prefetch=4,
                          compact_wire=compact_wire)
    taken = 6
    for mode in ("thread", "process"):
        with PretrainPipeline(store, sampler, dataclasses.replace(
                pcfg, mode=mode), seed=5) as pipe:
            items = [next(pipe) for _ in range(taken)]
            jobs = pipe._partition(2, 1)
            final = pipe.pcfg
        assert len(jobs) == 2
        streams = [ShardSampler(store, ids, sampler, final,
                                5 + 7919 * (w + 1)) for w, ids in
                   enumerate(jobs)]
        expected = [[s.next_pair() for _ in range(taken)] for s in streams]
        at = [0, 0]
        for item in items:
            w = next((w for w in (0, 1) if at[w] < taken
                      and _same_item(item, expected[w][at[w]])), None)
            assert w is not None, f"{mode}: an item of no worker's stream"
            at[w] += 1


def test_unknown_sampler_mode_is_refused(corpus):
    with pytest.raises(ValueError, match="sampler mode"):
        PretrainPipeline(CorpusStore.open(corpus), SamplerConfig(rw_hops=16),
                         PipelineConfig(batch_size=8, n_max=32, e_max=512,
                                        num_workers=1, mode="fork"))
