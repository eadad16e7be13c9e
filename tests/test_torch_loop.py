"""The port's pre-training loop, checkpoints and the serve path on the
CPU (corpus → pipeline → run_pretrain → checkpoint → generate →
evaluate), and its E2E and legacy-NCE steps against gcc_tpu's step at
bridged weights."""

import ast
import copy
import dataclasses
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
from gcc_tpu.features.featurize import BatchFeatures as JxFeatures  # noqa: E402
from gcc_tpu.models import GraphEncoder as JxEncoder  # noqa: E402
from gcc_tpu.training.optim import build_optimizer as jx_optimizer  # noqa: E402
from gcc_tpu.training.pretrain import (  # noqa: E402
    PretrainState as JxState,
    make_step_from_feats,
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
from gcc_tpu_torch.contrastive import MoCoQueue  # noqa: E402
from gcc_tpu_torch.features.featurize import BatchFeatures  # noqa: E402
from gcc_tpu_torch.generate import generate_embeddings, node_subgraphs  # noqa: E402
from gcc_tpu_torch.graph.corpus import CorpusStore, synthetic_corpus  # noqa: E402
from gcc_tpu_torch.graph.csr import CSRGraph  # noqa: E402
from gcc_tpu_torch.models import GraphEncoder  # noqa: E402
from gcc_tpu_torch.sampling.pipeline import (  # noqa: E402
    PipelineConfig,
    PretrainPipeline,
)
from gcc_tpu_torch.tasks import evaluate_node_embeddings  # noqa: E402
from gcc_tpu_torch.training.checkpoint import (  # noqa: E402
    load_checkpoint,
    load_config,
    load_encoder,
    save_checkpoint,
)
from gcc_tpu_torch.training.loop import run_pretrain  # noqa: E402
from gcc_tpu_torch.training.optim import build_optimizer  # noqa: E402
from gcc_tpu_torch.training.pretrain import (  # noqa: E402
    PretrainState,
    create_pretrain_state,
    train_dispatch,
    train_step,
)
from test_torch_models import SMALL, random_features  # noqa: E402
from test_torch_training import _named_leaves, _tree_close  # noqa: E402

torch.set_num_threads(1)


def tiny_cfg(moco=False, epochs=2, **contrast):
    return TrainConfig(
        batch_size=8, epochs=epochs, num_samples=64, num_workers=0,
        sampler=SamplerConfig(rw_hops=16),
        encoder=EncoderConfig(hidden_size=16, output_size=16,
                              positional_embedding_size=8,
                              degree_embedding_size=4, pe_method="eigh"),
        contrast=ContrastConfig(moco=moco, nce_k=32, **contrast),
        optim=OptimConfig(learning_rate=0.01),
    )


def tiny_pcfg(**kw):
    return PipelineConfig(**{**dict(batch_size=8, n_max=32, e_max=512,
                                    num_samples=64, num_workers=0), **kw})


def _quiet(_):
    pass


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("corpus"))
    synthetic_corpus(path, num_graphs=2, nodes_per_graph=300, avg_degree=6)
    return path


@pytest.mark.parametrize("moco", [False, True])
def test_run_pretrain_and_checkpoint(tmp_path, corpus, moco):
    """16 steps in 2 epochs, 16 finite metric lines, the sidecar and the
    checkpoint restore (as gcc_tpu's test_run_pretrain_and_checkpoint)."""
    cfg = tiny_cfg(moco=moco)
    summary = run_pretrain(cfg, corpus, str(tmp_path / "out"), tiny_pcfg(),
                           log_fn=_quiet, device="cpu")
    assert summary["steps"] == 16 and summary["epoch"] == 2
    assert summary["steps_per_epoch_skipped"] == 0
    run_dir = summary["run_dir"]
    for name in ("current", "ckpt_1", "ckpt_2", "metrics.jsonl"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [rec["step"] for rec in lines] == list(range(16))
    assert all(np.isfinite([rec["loss"], rec["prob"], rec["grad_norm"]]).all()
               for rec in lines)
    cfg2 = load_config(run_dir)
    assert cfg2 == cfg and cfg2.contrast.moco == moco
    with open(os.path.join(run_dir, "config.json")) as f:
        assert json.load(f)["ckpt_format_version"] == 1
    saved = load_checkpoint(os.path.join(run_dir, "current"))
    assert saved["queue"]["memory"].shape == (32, 16)
    assert saved["step"] == 16
    # MoCo wrote 16 x 8 keys round the 32-row ring; E2E leaves it alone.
    assert int(saved["queue"]["index"]) == 0
    moved = not torch.equal(
        saved["queue"]["memory"],
        create_pretrain_state(cfg, 16, seed=cfg.seed,
                              device="cpu").queue.memory)
    assert moved == moco
    enc = load_encoder(os.path.join(run_dir, "current"), cfg2, device="cpu")
    for name, value in enc.state_dict().items():
        assert torch.equal(value, saved["model"][name]), name


def test_checkpoint_round_trip_is_exact(tmp_path, corpus):
    """A state that took steps, saved and restored into a fresh state of
    the same configuration: every tensor bit for bit (both encoders, the
    queue, Adam's moments and step, nce_z, the dropout generator), and
    the next step from either is the same step."""
    cfg = tiny_cfg(moco=True, use_softmax=False)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, final_dropout=0.5))
    pcfg = tiny_pcfg(emit="stacked", super_batch=2)
    with PretrainPipeline(CorpusStore.open(corpus), cfg.sampler, pcfg,
                          seed=0) as pipe:
        items = [next(pipe) for _ in range(2)]
    live = create_pretrain_state(cfg, 8, seed=3, device="cpu")
    train_dispatch(live, *items[0], n_max=32)
    target = save_checkpoint(str(tmp_path), live, cfg)
    restored = load_checkpoint(
        target, create_pretrain_state(cfg, 8, seed=99, device="cpu"))
    assert restored.step == live.step == 2
    assert float(restored.nce_z) == float(live.nce_z) > 0

    def tensors(state):
        out = dict(state.model.state_dict())
        out.update({f"ema.{k}": v
                    for k, v in state.ema_model.state_dict().items()})
        out.update(queue=state.queue.memory, index=state.queue.index,
                   gen=state.dropout_gen.get_state())
        for name, p in state.model.named_parameters():
            for key, value in state.optimizer.state[p].items():
                out[f"adam.{name}.{key}"] = value
        return out

    for _ in range(2):      # as restored, then after one more dispatch each
        a, b = tensors(live), tensors(restored)
        assert a.keys() == b.keys()
        for name in a:
            assert torch.equal(a[name], b[name]), name
        train_dispatch(live, *items[1], n_max=32)
        train_dispatch(restored, *items[1], n_max=32)


def test_run_pretrain_resume(tmp_path, corpus):
    """A resumed run continues from the saved step (4 + 4 steps) with the
    optimizer moments and the queue."""
    cfg = tiny_cfg(moco=True, epochs=1)
    pcfg = tiny_pcfg(num_samples=32)
    s1 = run_pretrain(cfg, corpus, str(tmp_path / "out"), pcfg, log_fn=_quiet,
                      device="cpu")
    ckpt = os.path.join(s1["run_dir"], "current")
    first = load_checkpoint(ckpt)
    logs = []
    s2 = run_pretrain(cfg, corpus, str(tmp_path / "out2"), pcfg,
                      log_fn=logs.append, resume=ckpt, device="cpu")
    assert s2["steps"] == 4
    assert any("resumed from" in line and "step 4" in line for line in logs)
    second = load_checkpoint(os.path.join(s2["run_dir"], "current"))
    assert first["step"] == 4 and second["step"] == 8
    adam = second["optimizer"]["state"]
    assert {int(s["step"]) for s in adam.values()} == {8}
    assert int(second["queue"]["index"]) == (8 * 8) % 32


def test_run_pretrain_refuses_what_it_does_not_run(tmp_path, corpus):
    out = str(tmp_path / "out")
    with pytest.raises(ValueError, match="routed"):
        run_pretrain(tiny_cfg(moco=False), corpus, out,
                     tiny_pcfg(emit="routed", n_small=16), log_fn=_quiet,
                     device="cpu")
    with pytest.raises(NotImplementedError, match="dp_devices=2"):
        run_pretrain(tiny_cfg(moco=True), corpus, out, tiny_pcfg(),
                     log_fn=_quiet, dp_devices=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_pretrain(tiny_cfg(moco=True), corpus, out, tiny_pcfg(),
                         log_fn=_quiet)


def test_checkpoint_mismatch_is_a_readable_error(tmp_path, corpus):
    cfg = tiny_cfg(moco=True)
    state = create_pretrain_state(cfg, 8, device="cpu")
    target = save_checkpoint(str(tmp_path), state, cfg, step=3)
    assert target.endswith("ckpt_3")
    wider = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, hidden_size=32))
    with pytest.raises(ValueError, match="does not match the current state "
                                         "structure"):
        load_checkpoint(target, create_pretrain_state(wider, 8, device="cpu"))
    longer = dataclasses.replace(cfg, contrast=dataclasses.replace(
        cfg.contrast, nce_k=64))
    with pytest.raises(ValueError, match="queue memory"):
        load_checkpoint(target, create_pretrain_state(longer, 8,
                                                      device="cpu"))
    with pytest.raises(ValueError, match="ckpt_format_version"):
        load_encoder(target, wider, device="cpu")


def community_graph(n_comm=4, size=30, seed=0):
    """Blocks with dense intra-community edges: community id is
    recoverable from structure, giving a label task for the floor test
    (a copy of tests/test_e2e_pipeline.py's)."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for c in range(n_comm):
        base = c * size
        for i in range(size):
            src.append(base + i)
            dst.append(base + (i + 1) % size)
        extra = 3 * size if c % 2 == 0 else size // 2  # density differs
        s = rng.integers(0, size, extra) + base
        d = rng.integers(0, size, extra) + base
        src.extend(s.tolist())
        dst.extend(d.tolist())
    s = rng.integers(0, n_comm * size, n_comm * 2)
    d = rng.integers(0, n_comm * size, n_comm * 2)
    src.extend(s.tolist())
    dst.extend(d.tolist())
    src, dst = np.array(src), np.array(dst)
    keep = src != dst
    g = CSRGraph.from_edges(src[keep], dst[keep], num_nodes=n_comm * size,
                            symmetrize=True)
    labels = np.repeat(np.arange(n_comm) % 2, size)  # density class
    y = np.zeros((n_comm * size, 2), np.float32)
    y[np.arange(n_comm * size), labels] = 1
    return g, y


def test_generate_and_eval_above_chance(tmp_path):
    """Pre-train (E2E, 3 epochs), restore the encoder from the
    checkpoint, generate node embeddings, evaluate: structural embeddings
    separate dense from sparse communities clearly better than the 0.5
    chance rate."""
    corpus = str(tmp_path / "c")
    synthetic_corpus(corpus, num_graphs=2, nodes_per_graph=400, avg_degree=8)
    cfg = tiny_cfg(moco=False, epochs=3)
    summary = run_pretrain(cfg, corpus, str(tmp_path / "out"), tiny_pcfg(),
                           log_fn=_quiet, device="cpu")
    enc = load_encoder(os.path.join(summary["run_dir"], "current"),
                       load_config(summary["run_dir"]), device="cpu")
    g, y = community_graph()
    subs = node_subgraphs(g, cfg, n_max=32, e_max=512)
    emb = generate_embeddings(cfg, enc, subs, n_max=32, e_max=512,
                              batch_size=16, device="cpu")
    assert emb.shape == (g.num_nodes, 16)
    assert np.isfinite(emb).all()
    res = evaluate_node_embeddings(emb, y)
    assert res["Micro-F1"] > 0.6, res


B, K, TOTAL_STEPS = 4, 24, 10


@pytest.mark.parametrize("moco,use_softmax", [(False, True), (True, False)])
def test_e2e_and_legacy_nce_steps_match_jax(moco, use_softmax, monkeypatch):
    """Two steps of the plain E2E objective, and of MoCo with the legacy
    NCE normalization (Z estimated at the first step, reused at the
    second), against gcc_tpu's step from the same parameters, queue and
    features, dropout off. Tolerances as tests/test_torch_training.py
    states for the MoCo step: loss, prob, grad_norm 1e-5 relative;
    params, EMA params, queue 1e-5 abs (the BatchNorm-fed MLP biases,
    whose true gradient is zero, are left to that test); BatchNorm
    buffers 1e-5 abs + relative."""
    monkeypatch.setenv("GCC_TPU_MERGED_QK", "0")
    rng = np.random.default_rng(7)
    steps = [(random_features(rng, b=B), random_features(rng, b=B))
             for _ in range(2)]
    queue0 = rng.uniform(-0.4, 0.4, (K, SMALL["output_size"])).astype(
        np.float32)
    contrast = dict(moco=moco, nce_k=K, use_softmax=use_softmax,
                    e2e_split="")
    jcfg = JxTrainConfig(batch_size=B, num_samples=64,
                         encoder=JxEncoderConfig(**SMALL),
                         contrast=JxContrast(**contrast))
    cfg = TrainConfig(batch_size=B, num_samples=64,
                      encoder=EncoderConfig(**SMALL),
                      contrast=ContrastConfig(**contrast))
    enc = JxEncoder(jcfg.encoder)
    to_jx = lambda f: JxFeatures(**{k: jnp.asarray(v) for k, v in f.items()})  # noqa: E731
    v = enc.init(jax.random.PRNGKey(0), to_jx(steps[0][0]), train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    tx = jx_optimizer(jcfg.optim, make_lr_schedule(
        jcfg.optim.learning_rate, TOTAL_STEPS, jcfg.optim.warmup))
    jstate = JxState(
        params=params, batch_stats=stats, ema_params=params,
        ema_batch_stats=stats,
        queue=JxQueue(memory=jnp.asarray(queue0),
                      index=jnp.zeros((), jnp.int32)),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
        dropout_rng=jax.random.PRNGKey(1),
        nce_z=jnp.full((), -1.0, jnp.float32))
    jstep = jax.jit(make_step_from_feats(jcfg, enc, tx))

    model = GraphEncoder(cfg.encoder)
    model.load_state_dict(flax_to_state_dict(params, stats))
    state = PretrainState(
        cfg=cfg, model=model,
        ema_model=copy.deepcopy(model).requires_grad_(False),
        optimizer=build_optimizer(model.parameters(), cfg.optim),
        queue=MoCoQueue(memory=torch.as_tensor(queue0.copy()),
                        index=torch.zeros((), dtype=torch.int64)),
        dropout_gen=torch.Generator().manual_seed(0),
        total_steps=TOTAL_STEPS)
    to_pt = lambda f: BatchFeatures(**{k: torch.as_tensor(v)  # noqa: E731
                                       for k, v in f.items()})
    for fq, fk in steps:
        jstate, jm = jstep(jstate, to_jx(fq), to_jx(fk))
        pm = train_step(state, to_pt(fq), to_pt(fk))
        for name in ("loss", "prob", "grad_norm"):
            np.testing.assert_allclose(float(pm[name]), float(jm[name]),
                                       rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(state.nce_z), float(jstate.nce_z),
                               rtol=1e-5)
    assert (float(state.nce_z) > 0) == (not use_softmax)
    mlp_biases = tuple(f"['GINMLP_{i}']{b}" for i in range(2)
                       for b in ("['Linear_0']['bias']",
                                 "['Linear_1']['bias']"))
    p, s = state_dict_to_flax(state.model.state_dict())
    pe, se = state_dict_to_flax(state.ema_model.state_dict())
    _tree_close(p, jstate.params, 1e-5, skip=mlp_biases)
    _tree_close(s, jstate.batch_stats, 1e-5, rtol=1e-5)
    _tree_close(pe, jstate.ema_params, 1e-5)
    _tree_close(se, jstate.ema_batch_stats, 1e-5, rtol=1e-5)
    np.testing.assert_allclose(state.queue.memory.numpy(),
                               np.asarray(jstate.queue.memory), rtol=0,
                               atol=1e-5)
    assert int(state.queue.index) == int(jstate.queue.index) == (
        2 * B % K if moco else 0)
    if not moco:
        # E2E trains one encoder: the key encoder's copy stays as made.
        for name, x in _named_leaves(pe).items():
            np.testing.assert_array_equal(x, _named_leaves(params)[name])


def write_airport_layout(data: str):
    """The community graph as the usa_airport dataset under ``data``."""
    g, y = community_graph()
    os.makedirs(os.path.join(data, "struc2vec"))
    prefix = os.path.join(data, "struc2vec", "usa-airports")
    with open(prefix + ".edgelist", "w") as f:
        for u in range(g.num_nodes):
            f.writelines(f"{u} {v}\n" for v in g.neighbors(u) if u < v)
    with open(prefix + ".nodelabel", "w") as f:
        f.writelines(f"{u} {int(y[u].argmax())}\n"
                     for u in range(g.num_nodes))
    return g, y


def test_cli_pretrains_size_split_then_finetunes(tmp_path, capsys):
    """pretrain at the E2E headline's batch and bucket (256, n_max 256),
    where the default split spec "128:240" applies, then finetune from
    its checkpoint, through the CLI on the CPU."""
    from gcc_tpu_torch import cli

    corpus, out, data = (str(tmp_path / d) for d in ("c", "out", "data"))
    write_airport_layout(data)
    cli.main(["synth-corpus", "--out", corpus, "--num-graphs", "2",
              "--nodes-per-graph", "400", "--avg-degree", "8"])
    cli.main(["pretrain", "--corpus", corpus, "--out", out, "--epochs", "1",
              "--batch-size", "256", "--num-samples", "512",
              "--num-workers", "0", "--rw-hops", "16", "--hidden-size", "16",
              "--positional-embedding-size", "8", "--degree-embedding-size",
              "4", "--pe-method", "eigh", "--n-max", "256", "--e-max",
              "2048", "--device", "cpu"])
    run_dir = os.path.join(out, os.listdir(out)[0])
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 2
    assert all(rec["e2e_split_overflow"] == 0 for rec in lines)
    capsys.readouterr()
    cli.main(["finetune", "--ckpt", os.path.join(run_dir, "current"),
              "--dataset", "usa_airport", "--data-root", data, "--epochs",
              "1", "--batch-size", "8", "--n-max", "32", "--e-max", "512",
              "--device", "cpu"])
    res = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(res["folds"]) == 1 and 0.0 <= res["mean"] <= 1.0, res


def test_cli_serves_end_to_end(tmp_path, capsys):
    """synth-corpus → pretrain → generate → eval-node → finetune through
    ``python -m gcc_tpu_torch.cli``'s entry point on the CPU: the
    community graph written in the airport edgelist layout, embeddings
    from two RWR views per node, Micro-F1 above chance; one finetune
    fold from the checkpoint."""
    from gcc_tpu_torch import cli

    corpus, out, data = (str(tmp_path / d) for d in ("c", "out", "data"))
    g, y = write_airport_layout(data)
    cli.main(["synth-corpus", "--out", corpus, "--num-graphs", "2",
              "--nodes-per-graph", "400", "--avg-degree", "8"])
    cli.main(["pretrain", "--corpus", corpus, "--out", out, "--epochs", "3",
              "--batch-size", "8", "--num-samples", "64", "--num-workers",
              "0", "--rw-hops", "16", "--hidden-size", "16",
              "--positional-embedding-size", "8", "--degree-embedding-size",
              "4", "--pe-method", "eigh", "--nce-k", "32", "--learning-rate",
              "0.01", "--n-max", "32", "--e-max", "512", "--device", "cpu"])
    run_dir = os.path.join(out, os.listdir(out)[0])
    emb_path = str(tmp_path / "emb.npy")
    cli.main(["generate", "--ckpt", os.path.join(run_dir, "current"),
              "--dataset", "usa_airport", "--data-root", data, "--out",
              emb_path, "--n-max", "32", "--e-max", "512", "--device", "cpu"])
    emb = np.load(emb_path)
    assert emb.shape == (g.num_nodes, 16) and np.isfinite(emb).all()
    capsys.readouterr()
    cli.main(["eval-node", "--dataset", "usa_airport", "--emb", emb_path,
              "--hidden-size", "16", "--data-root", data])
    printed = capsys.readouterr().out
    assert "Micro-F1" in printed
    assert float(printed.split(":")[1].strip(" }\n")) > 0.6, printed
    cli.main(["finetune", "--ckpt", os.path.join(run_dir, "current"),
              "--dataset", "usa_airport", "--data-root", data, "--epochs",
              "1", "--batch-size", "8", "--n-max", "32", "--e-max", "512",
              "--device", "cpu"])
    res = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(res["folds"]) == 1 and 0.0 <= res["mean"] <= 1.0, res
