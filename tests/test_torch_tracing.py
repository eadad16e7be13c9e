"""The port's spans and counters on the CPU: ``utils/profiling.py``'s
``span`` / ``tracing`` / ``span_table`` / ``span_records`` (off: one
shared no-op; on: nesting, roots, self times, the cap), the spans a MoCo
and an E2E dispatch and a generation call emit, the pipeline's
``stats()``, the spans as ``user_annotation`` events of a profiler
trace, ``maybe_profile``'s one-dispatch window and ``run_pretrain``'s
epoch log."""

import json
import os
import time

import numpy as np
import pytest
import torch

from gcc_tpu_torch.config import (
    ContrastConfig,
    EncoderConfig,
    OptimConfig,
    SamplerConfig,
    TrainConfig,
)
from gcc_tpu_torch.generate import generate_embeddings, node_subgraphs
from gcc_tpu_torch.graph.corpus import CorpusStore, synthetic_corpus
from gcc_tpu_torch.graph.csr import CSRGraph
from gcc_tpu_torch.models import GraphEncoder
from gcc_tpu_torch.sampling.pipeline import PipelineConfig, PretrainPipeline
from gcc_tpu_torch.training.loop import run_pretrain
from gcc_tpu_torch.training.pretrain import (
    create_pretrain_state,
    train_dispatch,
)
from gcc_tpu_torch.utils import profiling
from gcc_tpu_torch.utils.profiling import (
    maybe_profile,
    span,
    span_records,
    span_table,
    tracing,
)

torch.set_num_threads(1)

STEP_PARTS = ("gcc.train.forward", "gcc.train.backward",
              "gcc.train.optimizer", "gcc.train.momentum")


def tiny_cfg(moco=True, e2e_split=""):
    return TrainConfig(
        batch_size=8, epochs=1, num_samples=64, num_workers=0,
        sampler=SamplerConfig(rw_hops=16),
        encoder=EncoderConfig(hidden_size=16, output_size=16,
                              positional_embedding_size=8,
                              degree_embedding_size=4, pe_method="eigh"),
        contrast=ContrastConfig(moco=moco, nce_k=32, e2e_split=e2e_split),
        optim=OptimConfig(learning_rate=0.01),
    )


def stacked_pcfg(**kw):
    return PipelineConfig(**{**dict(batch_size=8, n_max=32, e_max=512,
                                    num_samples=64, num_workers=0,
                                    emit="stacked", super_batch=2), **kw})


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("corpus"))
    synthetic_corpus(path, num_graphs=2, nodes_per_graph=300, avg_degree=6)
    return path


@pytest.fixture(scope="module")
def wire(corpus):
    """One stacked (query, key) item: 2 steps of 8 pairs, n_max 32."""
    with PretrainPipeline(CorpusStore.open(corpus), SamplerConfig(rw_hops=16),
                          stacked_pcfg(), seed=0) as pipe:
        return next(pipe)


@pytest.fixture
def fake_clock(monkeypatch):
    """perf_counter_ns reads 0, 10, 20, ... ns."""
    ticks = iter(range(0, 10 ** 9, 10))
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks))


def _forbid(monkeypatch, obj, attr):
    def refuse(*a, **k):
        raise AssertionError(f"{attr} called")
    monkeypatch.setattr(obj, attr, refuse)


def test_spans_off_are_one_shared_noop(monkeypatch):
    """Off (outside tracing(), also after one): the same object for any
    name, no clock read, no record_function, nothing recorded, and no
    gcc.* event in a profiler's trace."""
    with tracing():
        pass
    _forbid(monkeypatch, time, "perf_counter_ns")
    _forbid(monkeypatch, torch.profiler, "record_function")
    _forbid(monkeypatch, torch.autograd.profiler, "record_function")
    noop = span("gcc.a")
    assert span("gcc.b") is noop and span("other") is noop
    with span("gcc.c"):
        pass
    assert span_records()["records"] == [] and span_table() == {}
    monkeypatch.undo()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("gcc.off"):
            torch.ones(4).sum()
    assert not [e for e in prof.events() if e.name.startswith("gcc.")]


def test_spans_on_nest_roots_self_times_and_cap(fake_clock, monkeypatch):
    """Records (id, name, root, parent, t0, t1) on the fake clock: a span
    with no open parent starts a root, its children share it; self time
    is the duration less the children's; past the cap spans are counted;
    no profiler, no record_function."""
    _forbid(monkeypatch, torch.profiler, "record_function")
    with tracing():
        with span("gcc.root"):          # t0 0
            with span("gcc.child"):     # 10 .. 20
                pass
            with span("gcc.child"):     # 30 .. 60
                with span("gcc.leaf"):  # 40 .. 50
                    pass
        # root ends at 70
        with span("gcc.root"):          # 80 .. 90
            pass
        recs = span_records()
        table = span_table()
    rows = [(r["id"], r["name"], r["root"], r["parent"], r["t0_ns"],
             r["t1_ns"]) for r in recs["records"]]
    assert rows == [(1, "gcc.child", 0, 0, 10, 20),
                    (3, "gcc.leaf", 0, 2, 40, 50),
                    (2, "gcc.child", 0, 0, 30, 60),
                    (0, "gcc.root", 0, -1, 0, 70),
                    (4, "gcc.root", 1, -1, 80, 90)]
    assert recs["dropped"] == 0 and recs["cap"] == profiling.SPAN_CAP
    ms = 1e-6
    assert table["gcc.root"]["count"] == 2
    assert table["gcc.root"]["total_ms"] == pytest.approx(80 * ms)
    assert table["gcc.root"]["self_ms"] == pytest.approx(40 * ms)
    assert table["gcc.child"]["count"] == 2
    assert table["gcc.child"]["total_ms"] == pytest.approx(40 * ms)
    assert table["gcc.child"]["self_ms"] == pytest.approx(30 * ms)
    assert table["gcc.leaf"]["self_ms"] == pytest.approx(10 * ms)
    # After the body: spans off, its records still read.
    assert span("gcc.x") is span("gcc.y")
    assert span_table() == table

    monkeypatch.setattr(profiling, "SPAN_CAP", 2)
    with tracing():
        for _ in range(5):
            with span("gcc.s"):
                pass
        assert span_records()["dropped"] == 3
        assert span_table()["gcc.s"]["count"] == 2


@pytest.mark.parametrize("mode", ["moco", "e2e", "e2e_split"])
def test_train_dispatch_spans(wire, mode):
    """One 2-step dispatch: one dispatch root holding one featurize (two
    uploads) and per step step, forward, backward, optimizer and, in
    MoCo only, momentum; the parts fit inside their parents."""
    cfg = tiny_cfg(moco=mode == "moco",
                   e2e_split="16:4" if mode == "e2e_split" else "")
    state = create_pretrain_state(cfg, total_steps=4, device="cpu")
    with tracing():
        metrics = train_dispatch(state, *wire, n_max=32)
        table, recs = span_table(), span_records()["records"]
    assert "e2e_split_overflow" in metrics or mode != "e2e_split"
    counts = {n: r["count"] for n, r in table.items()}
    want = {"gcc.train.dispatch": 1, "gcc.train.featurize": 1,
            "gcc.wire.upload": 2, "gcc.train.step": 2,
            "gcc.train.forward": 2, "gcc.train.backward": 2,
            "gcc.train.optimizer": 2}
    if mode == "moco":
        want["gcc.train.momentum"] = 2
    assert counts == want
    assert {r["root"] for r in recs} == {0}
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        parent = by_id.get(r["parent"])
        if parent is not None:
            assert parent["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] \
                <= parent["t1_ns"]
        elif r["name"] != "gcc.train.dispatch":
            raise AssertionError(f"{r['name']} has no parent")
    parts = sum(table[n]["total_ms"] for n in STEP_PARTS if n in table)
    assert parts <= table["gcc.train.step"]["total_ms"]
    assert (table["gcc.train.step"]["total_ms"]
            + table["gcc.train.featurize"]["total_ms"]
            <= table["gcc.train.dispatch"]["total_ms"])
    for name, row in table.items():
        assert 0 <= row["self_ms"] <= row["total_ms"], name


@pytest.mark.parametrize("batch_size", [64, 24])
def test_generate_spans(batch_size):
    """A call of 40 nodes' two views: batch, featurize and encode once a
    chunk of each view, fetch once, all under the call's root."""
    rng = np.random.default_rng(0)
    n = 40
    src = rng.integers(0, n, 160)
    dst = rng.integers(0, n, 160)
    keep = src != dst
    graph = CSRGraph.from_edges(np.concatenate([src[keep], dst[keep]]),
                                np.concatenate([dst[keep], src[keep]]), n)
    cfg = tiny_cfg()
    subs_q, subs_k = node_subgraphs(graph, cfg, 32, 512, two_views=True)
    model = GraphEncoder(cfg.encoder)
    with tracing():
        emb = generate_embeddings(cfg, model, subs_q, n_max=32, e_max=512,
                                  batch_size=batch_size, subgraphs_k=subs_k,
                                  device="cpu")
        table, recs = span_table(), span_records()["records"]
    assert emb.shape == (n, 16)
    chunks = 2 * -(-n // batch_size)
    assert {k: v["count"] for k, v in table.items()} == {
        "gcc.generate.call": 1, "gcc.generate.batch": chunks,
        "gcc.generate.featurize": chunks, "gcc.generate.encode": chunks,
        "gcc.generate.fetch": 1}
    assert {r["root"] for r in recs} == {0}
    call = next(r for r in recs if r["name"] == "gcc.generate.call")
    assert all(r["parent"] == call["id"] for r in recs if r is not call)


def test_pipeline_stats(corpus):
    """gets, wait_ns and ready_items: in-process (ready 0) and in thread
    mode, where a full queue of 2 counts 2 on the next get."""
    store = CorpusStore.open(corpus)
    with PretrainPipeline(store, SamplerConfig(rw_hops=16), stacked_pcfg(),
                          seed=0) as pipe:
        assert pipe.stats() == {"gets": 0, "wait_ns": 0, "ready_items": 0}
        for _ in range(3):
            next(pipe)
        stats = pipe.stats()
        assert stats["gets"] == 3 and stats["ready_items"] == 0
        assert stats["wait_ns"] > 0
    pcfg = stacked_pcfg(num_workers=1, prefetch=2)
    with PretrainPipeline(store, SamplerConfig(rw_hops=16), pcfg,
                          seed=0) as pipe:
        deadline = time.monotonic() + 30
        while pipe._queue.qsize() < 2:
            assert time.monotonic() < deadline, "the sampler never filled"
            time.sleep(0.01)
        next(pipe)
        assert pipe.stats()["gets"] == 1
        assert pipe.stats()["ready_items"] == 2
        assert pipe.stats()["wait_ns"] > 0


def test_spans_are_profiler_annotations_around_their_ops(wire, tmp_path):
    """Under a CPU profiler inside tracing(), each gcc.* span is a
    user_annotation event of the trace, and the ops it ran lie inside
    it."""
    state = create_pretrain_state(tiny_cfg(), total_steps=4, device="cpu")
    with tracing(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        train_dispatch(state, *wire, n_max=32)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"
             and e["name"].startswith("gcc.")]
    assert spans and all(e["cat"] == "user_annotation" for e in spans)
    assert {e["name"] for e in spans} == set(span_table())
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op"]
    for s in spans:
        a, b = s["ts"], s["ts"] + s["dur"]
        assert any(a <= o["ts"] and o["ts"] + o["dur"] <= b for o in ops), \
            s["name"]


def test_maybe_profile_records_the_second_dispatch(tmp_path):
    """The first dispatch warms, the second is traced with its spans
    (trace.json, spans.json), later ones run with spans off; no
    directory, no profiler."""
    def dispatch(i):
        with span("gcc.train.dispatch"):
            torch.full((8, 8), float(i)).mm(torch.ones(8, 8))

    with maybe_profile(None) as step:
        dispatch(0)
        step()
        assert span("gcc.a") is span("gcc.b")
    out = tmp_path / "prof"
    with maybe_profile(str(out)) as step:
        for i in range(4):
            dispatch(i)
            step()
            assert (span("gcc.a") is span("gcc.b")) == (i != 0)
    with open(out / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("name") == "gcc.train.dispatch"]
    assert len(marks) == 1 and marks[0]["cat"] == "user_annotation"
    with open(out / "spans.json") as f:
        recs = json.load(f)
    assert recs["dropped"] == 0
    assert recs["table"]["gcc.train.dispatch"]["count"] == 1
    assert [(r["name"], r["root"]) for r in recs["records"]] == [
        ("gcc.train.dispatch", 0)]


def test_run_pretrain_profiles_one_dispatch_and_splits_host_time(
        tmp_path, corpus):
    """--profile-dir's path: 2 dispatches of 4 steps, the second traced;
    the epoch log tells sampler wait from enqueue."""
    lines = []
    run_pretrain(tiny_cfg(), corpus, str(tmp_path / "out"),
                 PipelineConfig(batch_size=8, n_max=32, e_max=512,
                                num_samples=64, num_workers=0),
                 log_fn=lines.append, profile_dir=str(tmp_path / "prof"),
                 steps_per_call=4, device="cpu")
    epoch = [x for x in lines if x.startswith("epoch 1 done")]
    assert len(epoch) == 1
    assert "sampler wait" in epoch[0] and "enqueue" in epoch[0]
    assert "0.0 items ready a get" in epoch[0]      # num_workers=0
    with open(tmp_path / "prof" / "spans.json") as f:
        recs = json.load(f)["records"]
    names = [r["name"] for r in recs]
    assert names.count("gcc.train.dispatch") == 1
    assert names.count("gcc.train.step") == 4
    assert names.count("gcc.train.momentum") == 4
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
