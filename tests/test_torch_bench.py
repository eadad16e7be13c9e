"""The port's measurement entry points against the repository's own:
``gcc_tpu_torch.bench`` against ``bench.py`` (edge-message count, the
steady median, the JSON line's keys, a dispatch's loss against
``make_packed_multi_step``), ``scripts.refscale_bench`` and ``hub_ab``
against ``scripts/refscale_bench.py``, ``scripts.giant_bench``'s graph
against ``scripts/giant_bench.py``'s draw, ``scripts.bench_scaling``'s toy
batch against ``__graft_entry__``; each entry's refusal without a card,
and the modules' imports in a fresh interpreter."""

import ast
import dataclasses
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import __graft_entry__  # noqa: E402
from gcc_tpu.config import (  # noqa: E402
    ContrastConfig as JxContrast,
    EncoderConfig as JxEncoderConfig,
    SamplerConfig as JxSampler,
    TrainConfig as JxTrainConfig,
)
from gcc_tpu.graph.batch import CompactWireBatch as JxWire  # noqa: E402
from gcc_tpu.graph.corpus import CorpusStore as JxCorpusStore  # noqa: E402
from gcc_tpu.graph.csr import CSRGraph as JxCSRGraph  # noqa: E402
from gcc_tpu.sampling.pipeline import (  # noqa: E402
    PipelineConfig as JxPipelineConfig,
    PretrainPipeline as JxPipeline,
)
from gcc_tpu.training import (  # noqa: E402
    create_pretrain_state as jx_create_state,
    make_packed_multi_step,
)
from gcc_tpu_torch import bench  # noqa: E402
from gcc_tpu_torch.compat import flax_to_state_dict  # noqa: E402
from gcc_tpu_torch.config import EncoderConfig  # noqa: E402
from gcc_tpu_torch.contrastive import MoCoQueue  # noqa: E402
from gcc_tpu_torch.graph.batch import expand_wire  # noqa: E402
from gcc_tpu_torch.graph.corpus import (  # noqa: E402
    CorpusStore,
    synthetic_corpus,
)
from gcc_tpu_torch.graph.csr import CSRGraph  # noqa: E402
from gcc_tpu_torch.sampling.pipeline import PretrainPipeline  # noqa: E402
from gcc_tpu_torch.scripts import (  # noqa: E402
    bench_scaling,
    giant_bench,
    hub_ab,
    refscale_bench,
)
from gcc_tpu_torch.training.pretrain import (  # noqa: E402
    create_pretrain_state,
    featurize_stacked,
    train_dispatch,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_layers=3, hidden_size=16, output_size=16,
             positional_embedding_size=8, final_dropout=0.0)
# The canonical configs at the tests' size: batch 4 (moco, K 64) or 8
# (e2e), 2 steps a dispatch, one dispatch a chunk.
TINY = {
    "moco": dataclasses.replace(bench.CONFIGS["moco"], batch_size=4,
                                nce_k=64, steps_per_call=2, measure_steps=16),
    "e2e": dataclasses.replace(bench.CONFIGS["e2e"], batch_size=8, nce_k=7,
                               steps_per_call=2, measure_steps=16,
                               device_dispatches=1),
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """2 graphs of ~2,000 nodes, the bench corpus's generator."""
    path = str(tmp_path_factory.mktemp("corpus"))
    synthetic_corpus(path, num_graphs=2, nodes_per_graph=2000, avg_degree=12,
                     seed=0)
    return path


@pytest.fixture(scope="module")
def sorted_corpus(tmp_path_factory):
    """The same shape with sorted rows (the hub A/B's precondition)."""
    path = str(tmp_path_factory.mktemp("sorted"))
    rng = np.random.default_rng(1)
    graphs = []
    for n in (1500, 2500):
        m = n * 12 // 2
        src = (n * rng.random(m) ** 2.0).astype(np.int64)
        dst = rng.integers(0, n, m)
        keep = src != dst
        graphs.append(CSRGraph.from_edges(src[keep], dst[keep], num_nodes=n,
                                          symmetrize=True, sort_rows=True))
    CorpusStore.create(path, graphs)
    return path


def _source_lines(path, first, last):
    """The statements of ``path`` from the line that starts with
    ``first`` through the next that contains ``last``, dedented."""
    with open(os.path.join(ROOT, path)) as f:
        lines = f.read().splitlines()
    i = next(j for j, s in enumerate(lines) if s.strip().startswith(first))
    k = next(j for j in range(i, len(lines)) if last in lines[j])
    return textwrap.dedent("\n".join(lines[i:k + 1]))


def _jx_wire(w):
    return JxWire(edges=jnp.asarray(w.edges), meta=jnp.asarray(w.meta),
                  e_max=w.e_max, id_bits=w.id_bits, n_max=w.n_max)


def test_edge_messages_match_bench_py_on_reference_items(corpus):
    """The port's items equal the reference pipeline's under the bench's
    pipeline config, and the port bench's count a dispatch equals
    ``bench.py``'s formula on the reference's items, exactly."""
    bc = TINY["moco"]
    pcfg = bench.pipeline_config(bc)
    jpcfg = JxPipelineConfig(**dataclasses.asdict(pcfg))
    layers = JxTrainConfig().encoder.num_layers - 1
    with PretrainPipeline(CorpusStore.open(corpus),
                          bench.train_config(bc).sampler, pcfg,
                          seed=0) as pipe, \
            JxPipeline(JxCorpusStore.open(corpus),
                       JxSampler(rw_hops=bench.RW_HOPS), jpcfg,
                       seed=0) as jpipe:
        buckets = set()
        for _ in range(6):
            (sq, sk), (jq, jk) = next(pipe), next(jpipe)
            for w, jw in ((sq, jq), (sk, jk)):
                np.testing.assert_array_equal(w.edges, jw.edges)
                np.testing.assert_array_equal(w.meta, jw.meta)
                assert w.n_max == jw.n_max
            buckets.add(sq.n_max)
            want = (int(jq.meta[:, 1, :].sum(dtype=np.int64))
                    + int(jk.meta[:, 1, :].sum(dtype=np.int64))) * layers
            assert want > 0
            assert bench.edge_messages(sq, sk, layers) == want
    assert bench.N_SMALL in buckets


@pytest.mark.parametrize("steady_count", [8, 7])
def test_steady_median_follows_bench_py(steady_count):
    """``steady_median`` picks the chunk that ``bench.py:220-222`` picks,
    on hand-made chunks with an even and an odd steady count."""
    rule = _source_lines("bench.py", "steady = chunks[warm_chunks:]",
                         "med_msgs, med_secs = steady[")
    rng = np.random.default_rng(steady_count)
    warm = 4
    chunks = [(float(rng.integers(1e5, 1e6)), float(rng.uniform(0.5, 3.0)))
              for _ in range(warm + steady_count)]
    ns = {"chunks": list(chunks), "warm_chunks": warm}
    exec(rule, ns)
    assert bench.steady_median(chunks, warm) == (ns["med_msgs"],
                                                 ns["med_secs"])
    rates = sorted(m / s for m, s in chunks[warm:])
    m, s = bench.steady_median(chunks, warm)
    assert m / s == rates[steady_count // 2]


def test_dispatch_loss_matches_reference_packed_multi_step(corpus,
                                                           monkeypatch):
    """The bench's first routed dispatch item (batch 4, K 64, 2 steps)
    through ``train_dispatch`` against the reference's
    ``make_packed_multi_step`` on the same item, from the same weights
    (bridged by ``compat``) and queue: loss and prob within 1e-5
    relative at each step (``tests/test_torch_training.py``'s
    tolerance). The PE is the one function of the pair whose coordinates
    are not comparable (Ritz vectors rotate within near-degenerate
    clusters on a last-bit difference; ``test_torch_features.py`` holds
    it by column cosines), so the reference is handed the port's PE of
    the item; adjacency, degrees, masks, encoder, loss and update are
    each side's own."""
    monkeypatch.setenv("GCC_TPU_MERGED_QK", "0")  # same math, one apply each
    bc = TINY["moco"]
    enc = EncoderConfig(**SMALL)
    cfg = bench.train_config(bc, enc)
    with PretrainPipeline(CorpusStore.open(corpus), cfg.sampler,
                          bench.pipeline_config(bc), seed=0) as pipe:
        item = next(pipe)
    assert item[0].n_max == bench.N_SMALL

    jcfg = JxTrainConfig(batch_size=bc.batch_size,
                         encoder=JxEncoderConfig(**SMALL),
                         contrast=JxContrast(moco=True, nce_k=bc.nce_k),
                         sampler=JxSampler(rw_hops=bench.RW_HOPS))
    sq = jax.tree_util.tree_map(lambda x: x[0], _jx_wire(item[0]))
    jstate, jenc, tx = jx_create_state(jax.random.PRNGKey(0), jcfg, sq,
                                       total_steps=100_000, n_max=bench.N_MAX)

    state = create_pretrain_state(cfg, total_steps=100_000, seed=0,
                                  device="cpu")
    state.model.load_state_dict(flax_to_state_dict(jstate.params,
                                                   jstate.batch_stats))
    state.ema_model.load_state_dict(flax_to_state_dict(
        jstate.ema_params, jstate.ema_batch_stats))
    state.queue = MoCoQueue(
        memory=torch.as_tensor(np.array(jstate.queue.memory)),
        index=torch.zeros((), dtype=torch.int64))

    feats = featurize_stacked(*item, enc.positional_embedding_size,
                              n_max=bench.N_MAX, device="cpu")
    port_pos = feats.pos.reshape((-1,) + feats.pos.shape[2:]).numpy()

    def port_pe(mb, pos_size, **kw):
        assert mb.node_mask.shape[0] == port_pos.shape[0]
        return jnp.asarray(port_pos)

    import gcc_tpu.features.featurize as jx_featurize
    monkeypatch.setattr(jx_featurize, "laplacian_positional_embedding",
                        port_pe)
    step_fn, pack, _ = make_packed_multi_step(jcfg, jenc, tx, jstate,
                                              n_max=bench.N_MAX)
    _, jm = step_fn(pack(jstate), _jx_wire(item[0]), _jx_wire(item[1]))
    pm = train_dispatch(state, *item, n_max=bench.N_MAX)
    for name in ("loss", "prob"):
        np.testing.assert_allclose(pm[name].numpy(), np.asarray(jm[name]),
                                   rtol=1e-5, err_msg=name)
    assert state.step == bc.steps_per_call


def _bench_py_keys():
    """The keys of ``bench.py``'s JSON line and of its ``detail``, read
    from the dict literal it prints."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            line = node.args[0]
            keys = [k.value for k in line.keys]
            detail = line.values[keys.index("detail")]
            return keys, [k.value for k in detail.keys]
    raise AssertionError("bench.py prints no dict literal")


@pytest.mark.parametrize("name", ["moco", "e2e"])
def test_bench_run_on_cpu_prints_bench_py_line(corpus, name):
    """``bench.run`` at the tests' size on the CPU prints one JSON line
    with ``bench.py``'s keys (and ``detail.gpu``, null without a card),
    vs_roofline and vs_roofline_device null, finite rates and loss."""
    out = io.StringIO()
    bc = TINY[name]
    line = bench.run(bc, corpus=corpus, device="cpu", n_chunks=3,
                     warm_chunks=1, encoder=EncoderConfig(**SMALL), out=out)
    printed = out.getvalue().splitlines()
    assert len(printed) == 1 and json.loads(printed[0]) == line
    keys, detail_keys = _bench_py_keys()
    assert list(line) == keys
    assert list(line["detail"]) == detail_keys + ["gpu"]
    assert line["vs_roofline"] is None
    assert line["detail"]["vs_roofline_device"] is None
    assert line["detail"]["gpu"] is None
    assert line["metric"] == "edge_messages/s/chip"
    assert line["value"] > 0 and math.isfinite(line["detail"]["loss"])
    assert len(line["detail"]["chunk_rates_M"]) == 3
    assert len(line["detail"]["device_step_trials_ms"]) == bench.DEVICE_TRIALS
    assert line["vs_baseline"] == round(
        line["value"] / bench.REFERENCE_EDGE_MSGS_PER_S, 2)
    assert line["detail"]["config"].startswith(
        f"{name} k={bc.nce_k} b={bc.batch_size} gin3x16 rw256 "
        "bucket(256,2048) scan2")
    assert line["detail"]["config"].endswith(
        "" if name == "moco" else " split[128:240]")


def test_canonical_configs_are_bench_py_s():
    """moco: batch 32, K 16384, routed, 64 steps a dispatch; e2e: batch
    256, K 255, stacked, 8 a dispatch; buckets (256, 2048), n_small 128,
    rw_hops 256, 10,000 samples, one worker thread (``bench.py:51-136``);
    the chunk sizes give 1 and 7 dispatches a chunk."""
    moco, e2e = bench.CONFIGS["moco"], bench.CONFIGS["e2e"]
    assert (moco.batch_size, moco.nce_k, moco.emit, moco.steps_per_call) == (
        32, 16384, "routed", 64)
    assert (e2e.batch_size, e2e.nce_k, e2e.emit, e2e.steps_per_call) == (
        256, 255, "stacked", 8)
    for bc in (moco, e2e):
        pcfg = bench.pipeline_config(bc)
        assert (pcfg.n_max, pcfg.e_max, pcfg.n_small, pcfg.num_samples,
                pcfg.num_workers, pcfg.prefetch, pcfg.threads_per_worker,
                pcfg.mode, pcfg.super_batch) == (
            256, 2048, 128, 10_000, 1, 4, 1, "thread", bc.steps_per_call)
        assert bench.train_config(bc).sampler.rw_hops == 256
    assert max(1, moco.measure_steps // 64 // 8) == 1
    assert max(1, e2e.measure_steps // 8 // 8) == 7
    assert bench.train_config(e2e).contrast.e2e_split == "128:240"


def _reference_script(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_refscale_bench_corpus_matches_reference(corpus):
    """The port's ``bench_corpus`` samples what
    ``scripts/refscale_bench.py``'s does: the same pairs, subgraph edges
    and native subgraph count."""
    ref = _reference_script("refscale_bench").bench_corpus(corpus, 256)
    got = refscale_bench.bench_corpus(corpus, 256)
    for key in ("pairs", "subgraph_edges", "graphs", "total_nodes",
                "total_edges"):
        assert got[key] == ref[key], key
    assert got["native_stats"]["subgraphs"] == ref["native_stats"][
        "subgraphs"] == 2 * got["pairs"]


def test_refscale_and_hub_ab_write_only_their_out(corpus, sorted_corpus,
                                                  tmp_path):
    """Both scripts on the tests' corpora: refscale's three rows and its
    ratio, the hub sweep's arms and its 2-thread pair, each written to
    its --out alone; the hub variable restored after."""
    before = os.environ.get(hub_ab.HUB_MULT)
    out = tmp_path / "out"
    r = refscale_bench.main(["--pairs", "64", "--small-corpus", corpus,
                             "--refscale-corpus", sorted_corpus,
                             "--out", str(out / "refscale.json")])
    assert set(r) == {"small", "refscale", "refscale_t2",
                      "refscale_over_small_ms_ratio"}
    assert r["refscale_t2"]["pairs"] >= 64
    h = hub_ab.main(["--pairs", "64", "--final-pairs", "64", "--mults",
                     "0,64", "--corpus", sorted_corpus,
                     "--out", str(out / "hub.json")])
    assert {"mult0_t1", "mult64_t1", "mult0_t2"} <= set(h)
    assert os.environ.get(hub_ab.HUB_MULT) == before
    assert sorted(os.listdir(out)) == ["hub.json", "refscale.json"]
    with open(out / "hub.json") as f:
        assert json.load(f) == h
    with pytest.raises(ValueError, match="sorted-rows"):
        hub_ab.main(["--corpus", corpus, "--out", str(out / "x.json")])


def test_heavy_tailed_graph_is_giant_bench_s_draw():
    """``heavy_tailed_graph`` gives the CSR arrays of
    ``scripts/giant_bench.py:58-66``'s draw, run from that file with the
    reference's ``CSRGraph``."""
    draw = _source_lines("scripts/giant_bench.py",
                         "rng = np.random.default_rng(0)", "symmetrize=True)")
    for nodes, deg in ((5000, 12), (777, 5)):
        ns = {"np": np, "CSRGraph": JxCSRGraph,
              "args": types.SimpleNamespace(nodes=nodes, avg_degree=deg)}
        exec(draw, ns)
        got = giant_bench.heavy_tailed_graph(nodes, deg)
        np.testing.assert_array_equal(got.indptr, ns["g"].indptr)
        np.testing.assert_array_equal(got.indices, ns["g"].indices)
        assert got.num_edges == ns["g"].num_edges


def test_giant_bench_runs_on_cpu():
    out = giant_bench.run(nodes=1500, iters=8, device="cpu")
    assert out["nodes"] == 1500 and out["devices"] == 1
    assert len(out["warm_trials_s"]) == giant_bench.WARM_TRIALS
    assert out["edge_msgs_per_s_encode"] > 0 and out["gpu"] is None


@pytest.mark.parametrize("kw", [{}, dict(batch_size=16, n=32, n_max=64,
                                         e_max=512, seed=2)])
def test_toy_batch_is_graft_entry_s(kw):
    """The scaling script's toy batch equals ``__graft_entry__``'s field
    by field, and its padded wire expands back to it."""
    got = bench_scaling._toy_batch(**kw)
    want = __graft_entry__._toy_batch(**kw)
    back = expand_wire(bench_scaling.wire_from_padded(got), got.n_max)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)
        np.testing.assert_array_equal(getattr(back, f.name),
                                      getattr(got, f.name), err_msg=f.name)


def test_bench_scaling_two_gloo_ranks():
    """World sizes 1 and 2 over gloo, each its own torch.distributed.run
    job: a finite step time each, efficiency 1 at the base."""
    line = bench_scaling.main(["--devices", "1", "2", "--steps", "2",
                               "--device", "cpu"])
    s = line["scaling"]
    assert list(s) == [1, 2] and s[1]["efficiency"] == 1.0
    assert all(math.isfinite(v["step_ms"]) and v["step_ms"] > 0
               for v in s.values())


def test_entries_refuse_cuda_without_a_card(monkeypatch):
    """Asked for the card (their default) where there is none, each entry
    raises before it samples or builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: bench.main(["moco"]),
             lambda: bench.run(bench.CONFIGS["e2e"], corpus="/nonexistent"),
             lambda: giant_bench.main(["--nodes", "100"]),
             lambda: bench_scaling.main(["--devices", "1"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_modules_import_nothing_of_the_reference():
    """``gcc_tpu_torch.bench`` and ``gcc_tpu_torch.scripts.*`` pull in
    neither jax nor gcc_tpu, ``bench.py``, ``scripts/`` or
    ``__graft_entry__``, checked in a fresh interpreter."""
    code = (
        "import sys\n"
        "import gcc_tpu_torch.bench\n"
        "from gcc_tpu_torch.scripts import bench_scaling, e2e_canonical, "
        "giant_bench, graph_readout_ab, hub_ab, pe_ab, refscale_bench\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'gcc_tpu', 'bench', 'scripts', "
        "'__graft_entry__', 'refscale_bench', 'pe_ab', 'e2e_canonical', "
        "'graph_readout_ab', 'role_benchmark', 'graph_benchmark')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=120)
