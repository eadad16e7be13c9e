"""Data-parallel and multi-host pre-training of the port on
``torch.distributed``: two gloo ranks on the CPU against the port's
single-process step and loop, and against the reference's
``make_dp_train_step`` on ``make_mesh(data=2)`` over the conftest's
virtual CPU devices (``tests/test_parallel.py:184-243, 423-520,
580-660`` hold the reference to the same tolerances).

The ranks are two children of this file (``python test_torch_dp.py
child <rank> <port> <workdir>``), started once for the module; each runs
every scenario in turn and leaves its results in the work directory.
They import torch and the port only. The references are computed here,
first, so the children find the sampler built."""

import dataclasses
import json
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


# ---- configurations shared by the ranks and the references -------------

def _cfg(moco=True, dropout=0.0, **kw):
    from gcc_tpu_torch.config import (
        ContrastConfig, EncoderConfig, OptimConfig, SamplerConfig,
        TrainConfig,
    )
    base = dict(batch_size=8, sampler=SamplerConfig(rw_hops=8),
                encoder=EncoderConfig(hidden_size=16, output_size=16,
                                      positional_embedding_size=8,
                                      degree_embedding_size=4,
                                      pe_method="eigh",
                                      final_dropout=dropout),
                contrast=ContrastConfig(moco=moco, nce_k=64),
                optim=OptimConfig(learning_rate=0.01))
    return TrainConfig(**{**base, **kw})


def _loop_cfg(**kw):
    from gcc_tpu_torch.config import ContrastConfig
    # The default final dropout (0.5): the ranks draw the global batch's
    # masks and keep their rows.
    base = dict(epochs=2, num_samples=32, num_workers=0,
                contrast=ContrastConfig(moco=True, nce_k=32))
    return _cfg(dropout=0.5, **{**base, **kw})


def _loop_pcfg(**kw):
    from gcc_tpu_torch.sampling.pipeline import PipelineConfig
    return PipelineConfig(**{**dict(batch_size=8, n_max=32, e_max=256,
                                    num_samples=32, num_workers=0,
                                    emit="stacked"), **kw})


def _port_state(inp, cfg):
    """A port state holding the reference's initial weights and queue."""
    import copy

    from gcc_tpu_torch.compat import flax_to_state_dict
    from gcc_tpu_torch.contrastive import MoCoQueue
    from gcc_tpu_torch.models import GraphEncoder
    from gcc_tpu_torch.training.optim import build_optimizer
    from gcc_tpu_torch.training.pretrain import PretrainState

    model = GraphEncoder(cfg.encoder)
    model.load_state_dict(flax_to_state_dict(inp["params"], inp["stats"]))
    return PretrainState(
        cfg=cfg, model=model,
        ema_model=copy.deepcopy(model).requires_grad_(False),
        optimizer=build_optimizer(model.parameters(), cfg.optim),
        queue=MoCoQueue(memory=torch.as_tensor(inp["queue0"].copy()),
                        index=torch.zeros((), dtype=torch.int64)),
        dropout_gen=torch.Generator().manual_seed(0), total_steps=10)


def _wires(inp):
    from gcc_tpu_torch.graph.batch import WireBatch
    return WireBatch(**inp["bq"]), WireBatch(**inp["bk"])


def _feats(inp):
    """The reference's features of the wires: eigendecompositions of
    small graphs with repeated eigenvalues are not unique, so the MoCo
    comparisons start both frameworks from the same features."""
    from gcc_tpu_torch.features.featurize import BatchFeatures
    return tuple(BatchFeatures(**{k: torch.as_tensor(np.array(v))
                                  for k, v in inp[f].items()})
                 for f in ("fq", "fk"))


def _flat_params(model):
    return torch.cat([p.detach().reshape(-1)
                      for p in model.parameters()]).numpy()


def _metrics(m):
    return {k: float(v.reshape(-1)[0]) for k, v in m.items()}


def _bn_inputs():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 6, 5)).astype(np.float32)
    mask = (rng.uniform(size=(8, 6)) < 0.7).astype(np.float32)
    wgt = rng.normal(size=(8, 6, 5)).astype(np.float32)
    return x, mask, wgt


def _bn_run(x, mask, wgt):
    """MaskedBatchNorm in train mode, loss Σ y·wgt: output, input and
    parameter gradients, running buffers."""
    from gcc_tpu_torch.models.layers import MaskedBatchNorm

    bn = MaskedBatchNorm(5)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 5))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, 5))
    xt = torch.as_tensor(x).requires_grad_(True)
    y = bn(xt, torch.as_tensor(mask))
    (y * torch.as_tensor(wgt)).sum().backward()
    return dict(y=y.detach().numpy(), gx=xt.grad.numpy(),
                gw=bn.weight.grad.numpy(), gb=bn.bias.grad.numpy(),
                mean=bn.running_mean.numpy(), var=bn.running_var.numpy())


def _partitions():
    """A random multigraph's three partitions for D = 2, features and
    output weights."""
    from gcc_tpu_torch.parallel import partitioned as part

    rng = np.random.default_rng(9)
    n, e, f = 40, 300, 6
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.uniform(0.5, 1.5, e).astype(np.float32)
    pgs = {"segment": part.partition_edges(src, dst, n, 2),
           "dense": part.partition_dense(src, dst, n, 2, weight=w),
           "ring": part.partition_edges_ring(src, dst, n, 2, weight=w)}
    h = rng.normal(size=(n, f)).astype(np.float32)
    g = rng.normal(size=(n, f)).astype(np.float32)
    return pgs, h, g


# ---- the ranks ------------------------------------------------------------

def _child_main(rank: int, port: int, work: str) -> None:
    import torch.distributed as dist

    from gcc_tpu_torch.parallel import data_parallel as dp
    from gcc_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize_multihost(f"localhost:{port}", 2, rank,
                                   device="cpu")
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}

    # The MoCo step: row-sharded queue (make_dp_train_step's placement),
    # then a second step; the same two steps on a replicated queue.
    for shard in (True, False):
        state = _port_state(inp, _cfg())
        if shard:
            dp.shard_state(state)
        step = dp.make_dp_train_step(n_max=16)
        fq, fk = (dp.shard_batch(f) for f in _feats(inp))
        res = dict(metrics=[])
        for t in (1, 2):
            res["metrics"].append(_metrics(step(state, fq, fk)))
            memory = (dp.all_gather(state.queue.memory) if shard
                      else state.queue.memory)
            res[f"memory{t}"] = memory.numpy().copy()
            res[f"index{t}"] = int(state.queue.index)
        res["params"] = _flat_params(state.model)
        out[f"moco_{'sharded' if shard else 'replicated'}"] = res

    # The E2E step over the global batch.
    state = _port_state(inp, _cfg(moco=False))
    bq, bk = (dp.shard_batch(w) for w in _wires(inp))
    m = dp.make_dp_train_step(n_max=16)(state, bq, bk)
    out["e2e"] = dict(metrics=_metrics(m), params=_flat_params(state.model))

    # BatchNorm forward and backward across the ranks.
    x, mask, wgt = _bn_inputs()
    rows = slice(4 * rank, 4 * rank + 4)
    with dp.data_parallel():
        bn = _bn_run(x[rows], mask[rows], wgt[rows])
    for name in ("gw", "gb"):   # parameter gradients: summed by the step
        bn[name] = dp.all_reduce_sum(torch.as_tensor(bn[name])).numpy()
    out["bn"] = bn

    # The partitioned aggregations, rank p holding block p of the rows.
    from gcc_tpu_torch.parallel.partitioned import partitioned_aggregate_dist

    pgs, h, g = _partitions()
    for name, pg in pgs.items():
        r = pg.num_nodes // 2
        hp = torch.as_tensor(np.pad(h, ((0, pg.num_nodes - len(h)), (0, 0)))
                             [rank * r:(rank + 1) * r]).requires_grad_(True)
        gp = np.pad(g, ((0, pg.num_nodes - len(g)), (0, 0)))[rank * r:
                                                             (rank + 1) * r]
        agg = partitioned_aggregate_dist(pg, hp)
        (agg * torch.as_tensor(gp)).sum().backward()
        out[f"agg_{name}"] = dict(out=agg.detach().numpy(),
                                  grad=hp.grad.numpy())

    # The combined step on a (data=1, part=2) grid: each rank its own
    # data group, the two ranks one part group.
    data_group, part_group = dp.make_groups(data=1, part=2)
    state = _port_state(inp, _cfg())
    combined = dp.make_combined_train_step(pgs["segment"], n_max=16,
                                           data_group=data_group,
                                           part_group=part_group)
    r = pgs["segment"].num_nodes // 2
    m, agg = combined(state, *_feats(inp),
                      torch.as_tensor(np.pad(h, ((0, 2 * r - len(h)),
                                                 (0, 0)))[rank * r:
                                                          (rank + 1) * r]))
    out["combined"] = dict(metrics=_metrics(m), agg=agg.numpy())

    # run_pretrain: two ranks of one host, then routed, then two hosts
    # of one rank each; every rank writes into its own directory.
    from gcc_tpu_torch.training.loop import run_pretrain

    corpus = os.path.join(work, "corpus")
    runs = {
        "loop": (_loop_cfg(), _loop_pcfg(e_tot=4 * 256), corpus),
        "routed": (_loop_cfg(epochs=1, num_samples=64),
                   _loop_pcfg(emit="routed", n_small=16, num_samples=64),
                   corpus),
        "hosts": (_loop_cfg(batch_size=16, epochs=1, num_samples=64),
                  _loop_pcfg(batch_size=16, num_samples=64, e_tot=2048),
                  os.path.join(work, "corpus4")),
    }
    for name, (cfg, pcfg, path) in runs.items():
        if name == "hosts":
            os.environ["LOCAL_WORLD_SIZE"] = "1"
        summary = run_pretrain(cfg, path,
                               os.path.join(work, f"{name}_rank{rank}"),
                               pcfg, log_fn=lambda s: None, steps_per_call=4,
                               dp_devices=2, device="cpu")
        os.environ.pop("LOCAL_WORLD_SIZE", None)
        out[name] = dict(summary)
    out["launches"] = dp.launches.count
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["child"]:
    _child_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)


# ---- the tests ------------------------------------------------------------

import pytest  # noqa: E402

pytest.importorskip("jax")

import jax  # noqa: E402


def _reference_step(work):
    """Initial state, wires and the reference's DP step on a (data=2)
    mesh (``tests/test_parallel.py:184-243`` with dropout off, so that
    the two frameworks' random streams do not enter)."""
    from gcc_tpu.config import (
        ContrastConfig, EncoderConfig, OptimConfig, SamplerConfig,
        TrainConfig,
    )
    from gcc_tpu.graph.batch import WireBatch as JxWire
    from gcc_tpu.parallel import make_mesh
    from gcc_tpu.parallel.data_parallel import (
        make_dp_train_step, shard_batch, shard_state,
    )
    from gcc_tpu.training import create_pretrain_state
    from gcc_tpu.training.pretrain import featurize_pair as jx_featurize
    from gcc_tpu_torch.graph.corpus import synthetic_corpus
    from gcc_tpu_torch.sampling.pipeline import PipelineConfig, ShardSampler

    store = synthetic_corpus(os.path.join(work, "c1"), num_graphs=1,
                             nodes_per_graph=300, avg_degree=6)
    pcfg = PipelineConfig(batch_size=8, n_max=16, e_max=128, num_workers=0,
                          super_batch=1, compact_wire=False)
    bq, bk = ShardSampler(store, [0], _cfg().sampler, pcfg,
                          seed=0).next_pair()
    fields = lambda w: {k: np.asarray(getattr(w, k))  # noqa: E731
                        for k in ("src", "dst", "n_nodes", "n_edges",
                                  "seed_pos")}
    jcfg = TrainConfig(
        batch_size=8, sampler=SamplerConfig(rw_hops=8),
        encoder=EncoderConfig(hidden_size=16, output_size=16,
                              positional_embedding_size=8,
                              degree_embedding_size=4, pe_method="eigh",
                              final_dropout=0.0),
        contrast=ContrastConfig(moco=True, nce_k=64),
        optim=OptimConfig(learning_rate=0.01))
    jbq, jbk = JxWire(**fields(bq)), JxWire(**fields(bk))
    state, enc, tx = create_pretrain_state(jax.random.PRNGKey(0), jcfg, jbq,
                                           total_steps=10, n_max=16)
    fq, fk = jax.jit(lambda q, k: jx_featurize(q, k, 8, "eigh", 16))(jbq,
                                                                       jbk)
    inp = dict(params=jax.tree_util.tree_map(np.asarray, state.params),
               stats=jax.tree_util.tree_map(np.asarray, state.batch_stats),
               queue0=np.asarray(state.queue.memory), bq=fields(bq),
               bk=fields(bk),
               fq={k: np.asarray(v) for k, v in fq._asdict().items()},
               fk={k: np.asarray(v) for k, v in fk._asdict().items()})
    mesh = make_mesh(data=2, part=1, devices=jax.devices()[:2])
    step = make_dp_train_step(jcfg, enc, tx, mesh, n_max=16)
    s2, m2 = step(shard_state(mesh, state), shard_batch(mesh, jbq),
                  shard_batch(mesh, jbk))
    ref = dict(loss=float(m2["loss"]), memory=np.asarray(s2.queue.memory),
               index=int(s2.queue.index))
    return inp, ref


def _single(inp, moco=True):
    """The port's single-process step on the whole batch: MoCo on the
    reference's features, E2E on the port's own (as its ranks)."""
    from gcc_tpu_torch.training.pretrain import featurize_pair, train_step

    state = _port_state(inp, _cfg(moco=moco))
    fq, fk = (_feats(inp) if moco else featurize_pair(
        *_wires(inp), 8, 16, device="cpu", pe_method="eigh"))
    return state, [_metrics(train_step(state, fq, fk))]


def _losses(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return np.array([json.loads(line)["loss"] for line in f])


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """References first (the single-process loop builds the sampler),
    then the two ranks; returns (inputs, reference, singles, ranks)."""
    from gcc_tpu_torch.graph.corpus import synthetic_corpus
    from gcc_tpu_torch.training.loop import run_pretrain

    torch.set_num_threads(1)
    work = str(tmp_path_factory.mktemp("dp"))
    inp, ref = _reference_step(work)
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    synthetic_corpus(os.path.join(work, "corpus"), num_graphs=2,
                     nodes_per_graph=300, avg_degree=6)
    synthetic_corpus(os.path.join(work, "corpus4"), num_graphs=4,
                     nodes_per_graph=300, avg_degree=6)
    single = run_pretrain(_loop_cfg(), os.path.join(work, "corpus"),
                          os.path.join(work, "single"),
                          _loop_pcfg(e_tot=8 * 256), log_fn=lambda s: None,
                          steps_per_call=4, device="cpu")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("LOCAL_WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "child", str(r),
         str(port), work], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=env, text=True) for r in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return inp, ref, single, ranks


def test_dp_step_matches_single_device(dp_run):
    """The 2-rank MoCo step (row-sharded queue) against the port's
    single-process step on the same global batch's features: loss within 1e-4
    relative, queue contents within 1e-5, queue index equal
    (``tests/test_parallel.py:184-243``'s tolerances); the ranks agree
    on the loss to 1e-6."""
    inp, _, _, ranks = dp_run
    state, ms = _single(inp)
    for rk in ranks:
        got = rk["moco_sharded"]
        np.testing.assert_allclose(got["metrics"][0]["loss"], ms[0]["loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["memory1"],
                                   state.queue.memory.numpy(), atol=1e-5)
        assert got["index1"] == int(state.queue.index) == 8
    np.testing.assert_allclose(ranks[0]["moco_sharded"]["metrics"][0]["loss"],
                               ranks[1]["moco_sharded"]["metrics"][0]["loss"],
                               rtol=1e-6)


def test_dp_step_matches_reference_make_dp_train_step(dp_run):
    """The port's 2-rank step against the reference's
    ``make_dp_train_step`` on ``make_mesh(data=2)``, from the same
    weights, the port's ranks on the reference's features of its wires:
    loss within 1e-4 relative, the queue within 1e-5, the index equal."""
    _, ref, _, ranks = dp_run
    for rk in ranks:
        got = rk["moco_sharded"]
        np.testing.assert_allclose(got["metrics"][0]["loss"], ref["loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["memory1"], ref["memory"], atol=1e-5)
        assert got["index1"] == ref["index"]


def test_row_sharded_queue_matches_replicated(dp_run):
    """Two steps with the queue row-sharded (K/2 rows a rank, logits over
    the gathered K) and replicated: the same losses, queue and weights."""
    _, _, _, ranks = dp_run
    for rk in ranks:
        a, b = rk["moco_sharded"], rk["moco_replicated"]
        for ma, mb in zip(a["metrics"], b["metrics"]):
            np.testing.assert_allclose(ma["loss"], mb["loss"], rtol=1e-6)
        np.testing.assert_allclose(a["memory2"], b["memory2"], atol=1e-6)
        assert a["index2"] == b["index2"] == 16
        np.testing.assert_allclose(a["params"], b["params"], atol=1e-6)


def test_e2e_dp_step_matches_single_device(dp_run):
    """E2E over 2 ranks (queries all-gathered with their gradient, BN over
    the global batch, gradients summed) against the single-process step:
    loss, positive logit and gradient norm within 1e-4 relative, the
    updated weights within 1e-5."""
    inp, _, _, ranks = dp_run
    state, ms = _single(inp, moco=False)
    want = np.concatenate([p.detach().reshape(-1).numpy()
                           for p in state.model.parameters()])
    for rk in ranks:
        for name in ("loss", "prob", "grad_norm"):
            np.testing.assert_allclose(rk["e2e"]["metrics"][name],
                                       ms[0][name], rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(rk["e2e"]["params"], want, atol=1e-5)


def test_batchnorm_across_ranks(dp_run):
    """MaskedBatchNorm inside a data-parallel step: each rank's output and
    input gradient are its rows of the single-process ones on the global
    batch, the summed parameter gradients and the running buffers those
    of the global batch (1e-5)."""
    _, _, _, ranks = dp_run
    want = _bn_run(*_bn_inputs())
    for r, rk in enumerate(ranks):
        rows = slice(4 * r, 4 * r + 4)
        np.testing.assert_allclose(rk["bn"]["y"], want["y"][rows], atol=1e-5)
        np.testing.assert_allclose(rk["bn"]["gx"], want["gx"][rows],
                                   atol=1e-5)
        for name in ("gw", "gb", "mean", "var"):
            np.testing.assert_allclose(rk["bn"][name], want[name],
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("schedule", ["segment", "dense", "ring"])
def test_partitioned_aggregation_across_ranks(dp_run, schedule):
    """Each schedule with its partition axis across 2 ranks against the
    one-process D = 2 form: every rank's rows of the result and of the
    gradient of Σ out·g (1e-5)."""
    from gcc_tpu_torch.parallel import partitioned as part

    _, _, _, ranks = dp_run
    pgs, h, g = _partitions()
    pg = pgs[schedule]
    fn = {"segment": part.partitioned_aggregate,
          "dense": part.partitioned_aggregate_dense,
          "ring": part.partitioned_aggregate_ring}[schedule]
    hp = torch.as_tensor(np.pad(h, ((0, pg.num_nodes - len(h)), (0, 0)))
                         ).requires_grad_(True)
    gp = np.pad(g, ((0, pg.num_nodes - len(g)), (0, 0)))
    out = fn(pg, hp)
    (out * torch.as_tensor(gp)).sum().backward()
    r = pg.num_nodes // 2
    for p, rk in enumerate(ranks):
        got = rk[f"agg_{schedule}"]
        np.testing.assert_allclose(got["out"], out.detach().numpy()
                                   [p * r:(p + 1) * r], atol=1e-5)
        np.testing.assert_allclose(got["grad"], hp.grad.numpy()
                                   [p * r:(p + 1) * r], atol=1e-5)


def test_combined_data_part_step(dp_run):
    """``make_combined_train_step`` on a (data=1, part=2) grid: each rank's
    step is the single-process step, and the aggregation over the part
    group is the one-process D = 2 form (1e-5)."""
    from gcc_tpu_torch.parallel import partitioned as part

    inp, _, _, ranks = dp_run
    _, ms = _single(inp)
    pgs, h, _ = _partitions()
    pg = pgs["segment"]
    want = part.partitioned_aggregate(
        pg, torch.as_tensor(np.pad(h, ((0, pg.num_nodes - len(h)), (0, 0)))))
    r = pg.num_nodes // 2
    for p, rk in enumerate(ranks):
        np.testing.assert_allclose(rk["combined"]["metrics"]["loss"],
                                   ms[0]["loss"], rtol=1e-5)
        np.testing.assert_allclose(rk["combined"]["agg"],
                                   want.numpy()[p * r:(p + 1) * r],
                                   atol=1e-5)


def test_run_pretrain_dp_matches_single_device(dp_run):
    """``run_pretrain(dp_devices=2)`` — the stacked wire with a device
    axis, each rank its slice, dropout drawn for the global batch —
    against the single-process run on the same sampled graphs: the loss
    trajectory within rtol 5e-4, atol 1e-5
    (``tests/test_parallel.py:423-478``); only rank 0 writes."""
    _, _, single, ranks = dp_run
    l1 = _losses(single["run_dir"])
    l2 = _losses(ranks[0]["loop"]["run_dir"])
    assert len(l1) == len(l2) == 8
    np.testing.assert_allclose(l2, l1, rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(ranks[0]["loop"]["avg_loss"],
                               ranks[1]["loop"]["avg_loss"], rtol=1e-6)
    assert not os.path.exists(os.path.join(ranks[1]["loop"]["run_dir"],
                                           "metrics.jsonl"))


def test_run_pretrain_dp_routed(dp_run):
    """Routed emission under DP (``tests/test_parallel.py:479-520``):
    per-bucket items with a device axis train 8 finite steps."""
    _, _, _, ranks = dp_run
    assert ranks[0]["routed"]["steps"] == 8
    lines = _losses(ranks[0]["routed"]["run_dir"])
    assert len(lines) == 8 and np.isfinite(lines).all()
    np.testing.assert_allclose(ranks[0]["routed"]["avg_loss"],
                               ranks[1]["routed"]["avg_loss"], rtol=1e-6)


def test_two_hosts_run_pretrain(dp_run):
    """Two hosts of one rank each (``LOCAL_WORLD_SIZE=1``,
    ``tests/test_parallel.py:580-660``): per-host corpus shards and
    sampling streams, the global batch of 16 split 8 a host, explicit
    e_tot. Both ranks report the same global losses (rtol 1e-6); rank 0
    alone wrote the metrics (8 finite steps) and the checkpoint; the
    ranks made collective calls."""
    _, _, _, ranks = dp_run
    a, b = ranks[0]["hosts"], ranks[1]["hosts"]
    assert a["steps"] == b["steps"] == 8
    np.testing.assert_allclose(a["avg_loss"], b["avg_loss"], rtol=1e-6)
    assert np.isfinite(a["avg_loss"])
    lines = _losses(a["run_dir"])
    assert len(lines) == 8 and np.isfinite(lines).all()
    assert os.path.exists(os.path.join(a["run_dir"], "current"))
    assert not os.path.exists(os.path.join(b["run_dir"], "current"))
    assert not os.path.exists(os.path.join(b["run_dir"], "metrics.jsonl"))
    assert ranks[0]["launches"] == ranks[1]["launches"] > 0


# ---- one process: the device axis of the wire ------------------------------

def _dp_items(corpus, devices, emit="stacked"):
    """The first item of a pipeline over ``corpus`` (batch 8, 4 steps)."""
    from gcc_tpu_torch.graph.corpus import CorpusStore
    from gcc_tpu_torch.sampling.pipeline import PretrainPipeline

    pcfg = _loop_pcfg(e_tot=(8 // devices) * 256, devices=devices,
                      super_batch=4, emit=emit, n_small=16)
    with PretrainPipeline(CorpusStore.open(corpus), _cfg().sampler, pcfg,
                          seed=3) as pipe:
        return next(pipe)


@pytest.mark.parametrize("emit", ["stacked", "routed"])
def test_pipeline_device_axis_matches_reference(tmp_path, emit):
    """``PipelineConfig(devices=2)``: items carry (K, 2, e_dev) edges and
    (K, 2, 3, b/2) meta, bit for bit the reference pipeline's
    (``gcc_tpu/sampling/pipeline.py:108-120``), and hold the graphs the
    devices=1 pipeline emits from the same seed, in (step, device)
    order."""
    from gcc_tpu.config import SamplerConfig as JxSampler
    from gcc_tpu.graph.corpus import CorpusStore as JxStore
    from gcc_tpu.sampling.pipeline import (
        PipelineConfig as JxPipelineConfig,
        PretrainPipeline as JxPipeline,
    )
    from gcc_tpu_torch.graph.corpus import synthetic_corpus

    corpus = str(tmp_path / "c")
    synthetic_corpus(corpus, num_graphs=2, nodes_per_graph=300, avg_degree=6)
    q2, k2 = _dp_items(corpus, 2, emit)
    assert q2.edges.shape == (4, 2, 4 * 256) and q2.meta.shape == (4, 2, 3, 4)
    jcfg = JxPipelineConfig(batch_size=8, n_max=32, e_max=256, num_samples=32,
                            num_workers=0, emit=emit, n_small=16,
                            e_tot=4 * 256, devices=2, super_batch=4)
    jpcfg = (dict(e_tot_small=4 * 256, e_tot_large=4 * 256)
             if emit == "routed" else {})
    with JxPipeline(JxStore.open(corpus), JxSampler(rw_hops=8),
                    dataclasses.replace(jcfg, **jpcfg), seed=3) as pipe:
        jq, jk = next(pipe)
    if emit == "routed":
        return _check_routed(q2, k2, jq, jk)
    for got, want in ((q2, jq), (k2, jk)):
        np.testing.assert_array_equal(got.edges, np.asarray(want.edges))
        np.testing.assert_array_equal(got.meta, np.asarray(want.meta))
    q1, _ = _dp_items(corpus, 1)
    np.testing.assert_array_equal(
        q2.meta.transpose(0, 2, 1, 3).reshape(4, 3, 8), q1.meta)
    for step in range(4):
        per_dev = [q2.edges[step, d, :int(q2.meta[step, d, 1].sum())]
                   for d in range(2)]
        np.testing.assert_array_equal(
            np.concatenate(per_dev), q1.edges[step, :int(q1.meta[step, 1]
                                                          .sum())])


def _check_routed(q2, k2, jq, jk):
    assert q2.n_max == jq.n_max
    for got, want in ((q2, jq), (k2, jk)):
        np.testing.assert_array_equal(got.meta, np.asarray(want.meta))
        np.testing.assert_array_equal(got.edges, np.asarray(want.edges))


def test_featurize_stacked_dp_matches_reference(tmp_path):
    """``featurize_stacked_dp`` and ``split_feats_qk_dp`` against the
    reference's (``gcc_tpu/training/pretrain.py:543-595``) on one
    DP-stacked item: adjacency, degrees, node masks and seed flags equal
    in (step, device, graph) order, the same PE rows live (its values are
    held in ``tests/test_torch_features.py``)."""
    from gcc_tpu.graph.batch import CompactWireBatch as JxWire
    from gcc_tpu.training.pretrain import (
        featurize_stacked_dp as jx_featurize,
        split_feats_qk_dp as jx_split,
    )
    from gcc_tpu_torch.graph.corpus import synthetic_corpus
    from gcc_tpu_torch.training.pretrain import (
        featurize_stacked_dp,
        split_feats_qk_dp,
    )

    corpus = str(tmp_path / "c")
    synthetic_corpus(corpus, num_graphs=2, nodes_per_graph=300, avg_degree=6)
    q, k = _dp_items(corpus, 2)
    jw = lambda w: JxWire(edges=w.edges, meta=w.meta, e_max=w.e_max,  # noqa: E731
                          id_bits=w.id_bits)
    want = jax.jit(lambda a, b: jx_featurize(a, b, 8, "eigh", 32))(jw(q),
                                                                   jw(k))
    got = featurize_stacked_dp(q, k, 8, n_max=32, device="cpu",
                               pe_method="eigh")
    assert got.node_mask.shape == (4, 2 * 2 * 4, 32)
    for t in range(4):
        g_q, g_k = split_feats_qk_dp(got.map(lambda x: x[t]), 2, 4)
        w_q, w_k = jx_split(jax.tree_util.tree_map(lambda x: x[t], want), 2,
                            4)
        for g, w in ((g_q, w_q), (g_k, w_k)):
            for name in ("adj", "degrees", "node_mask", "seed_flag"):
                np.testing.assert_array_equal(
                    getattr(g, name).numpy(), np.asarray(getattr(w, name)),
                    err_msg=name)
            np.testing.assert_array_equal(
                np.abs(g.pos.numpy()).sum(-1) > 0,
                np.abs(np.asarray(w.pos)).sum(-1) > 0)


def test_dp_stacked_dispatch_in_one_process(tmp_path):
    """Without a process group a DP-stacked dispatch (a device axis of 2)
    is the step on its global batch in (device, graph) order, as one
    program is in the reference (``packed.py:142-163``): the same losses
    as the devices=1 dispatch of the same sampled graphs (1e-5)."""
    from gcc_tpu_torch.graph.corpus import synthetic_corpus
    from gcc_tpu_torch.training.pretrain import (
        create_pretrain_state,
        train_dispatch,
    )

    corpus = str(tmp_path / "c")
    synthetic_corpus(corpus, num_graphs=2, nodes_per_graph=300, avg_degree=6)
    losses = []
    for devices in (1, 2):
        state = create_pretrain_state(_loop_cfg(), 10, seed=0, device="cpu")
        m = train_dispatch(state, *_dp_items(corpus, devices), n_max=32)
        losses.append(m["loss"].numpy())
    assert losses[0].shape == (4,)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


def test_multihost_helpers_in_one_process(tmp_path, monkeypatch):
    """Without a process group: one rank, one host, no initialization
    without topology (and a ValueError with part of one); per-host corpus
    shards are the reference's (``multihost.py:55-68``);
    ``host_local_batch_to_global`` is the upload of the rank's own slice."""
    from gcc_tpu.parallel.multihost import (
        corpus_shard_for_host as jx_shard,
    )
    from gcc_tpu_torch.graph.corpus import synthetic_corpus
    from gcc_tpu_torch.parallel import multihost
    from gcc_tpu_torch.wire import wire_to_device

    for var in ("WORLD_SIZE", "MASTER_ADDR", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    multihost.initialize_multihost(device="cpu")
    assert (multihost.world_size(), multihost.rank(), multihost.host_count(),
            multihost.host_index(), multihost.local_rank()) == (1, 0, 1, 0, 0)
    with pytest.raises(ValueError, match="explicit topology"):
        multihost.initialize_multihost("localhost:1", device="cpu")
    sizes = [300, 120, 90, 400, 15, 60, 61]
    for hosts in (2, 3):
        for h in range(hosts):
            assert multihost.corpus_shard_for_host(sizes, hosts, h) == \
                jx_shard(sizes, hosts, h)
    corpus = str(tmp_path / "c")
    synthetic_corpus(corpus, num_graphs=2, nodes_per_graph=300, avg_degree=6)
    q, _ = _dp_items(corpus, 2)
    placed = multihost.host_local_batch_to_global(q, device="cpu")
    for got, want in zip((placed.edges, placed.meta),
                         wire_to_device(q, "cpu")):
        assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(
        wire_to_device(placed, "cpu"), (placed.edges, placed.meta)))
