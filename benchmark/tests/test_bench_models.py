"""A new encoder is new files: its plain reference and its counts are found
by the configuration's ``model``, its weights are drawn for any parameter
of the program's encoders, and GIN reads exactly what it read before. A
run's record keeps the program's spans and counters and the traced
stretch's graph sizes, and a run without ``--trace`` opens no span."""

from __future__ import annotations

import copy
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
from torch import nn

from benchmark import run
from benchmark.counts import encoder as enc_counts
from benchmark.harness import common, pretrain
from benchmark.harness.weights import make_encoder_tensors
from benchmark.tests.tiny import TINY

BENCH = common.load_json(os.path.join(common.ROOT, "BENCHMARK.json"))


def _config(name: str) -> dict:
    return common.load_json(os.path.join(common.BENCH_DIR, "configs",
                                         f"{name}.json"))


# -- weights ---------------------------------------------------------------

def _frozen_kind(name: str) -> str:
    if name.endswith("running_mean") or name.endswith("running_var"):
        return "stat"
    if name.endswith("num_batches_tracked"):
        return "skip"
    if name.startswith("degree_embedding"):
        return "embedding"
    if ".bn." in name or ".norms." in name:
        return "affine"
    return "linear"


def _frozen_gin_tensors(shapes: dict, gen: torch.Generator, device) -> dict:
    """The GIN weights as the benchmark drew them before it took other
    encoders: a frozen copy."""
    out = {}
    lin = [(n, s) for n, s in shapes.items() if _frozen_kind(n) == "linear"]
    total = sum(math.prod(s) for _, s in lin)
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0,
                                                      generator=gen)
    fan_in = {}
    for n, s in lin:
        if n.endswith(".weight"):
            fan_in[n[:-len(".weight")]] = s[1]
    off = 0
    for n, s in lin:
        size = math.prod(s)
        layer = n.rsplit(".", 1)[0]
        bound = 1.0 / math.sqrt(fan_in[layer])
        out[n] = (flat[off:off + size] * bound).view(s)
        off += size
    emb = [(n, s) for n, s in shapes.items()
           if _frozen_kind(n) == "embedding"]
    for n, s in emb:
        out[n] = torch.empty(s, device=device).normal_(0.0, 1.0,
                                                       generator=gen)
    stats = [(n, s) for n, s in shapes.items() if _frozen_kind(n) == "stat"]
    total = sum(math.prod(s) for _, s in stats)
    flat = torch.empty(total, device=device).uniform_(0.0, 1.0,
                                                      generator=gen)
    off = 0
    for n, s in stats:
        size = math.prod(s)
        u = flat[off:off + size].view(s)
        out[n] = (0.5 + 1.5 * u) if n.endswith("var") else (u - 0.5) * 0.2
        off += size
    for n, s in shapes.items():
        kind = _frozen_kind(n)
        if kind == "affine":
            fill = 1.0 if n.endswith(".weight") else 0.0
            out[n] = torch.full(s, fill, device=device)
        elif kind == "skip":
            out[n] = torch.zeros(s, dtype=torch.int64, device=device)
    return {n: out[n].contiguous() for n in shapes}


def _encoder(model: str, **kw):
    from gcc_tpu_torch.config import EncoderConfig
    from gcc_tpu_torch.models import GraphEncoder

    return GraphEncoder(EncoderConfig(model=model, **kw))


def _shapes(module) -> dict:
    return {n: tuple(t.shape) for n, t in module.state_dict().items()}


@pytest.mark.parametrize("seed", [0, 20260, 4294967311])
@pytest.mark.parametrize("cell_config", ["gcc-moco", "gcc-e2e"])
def test_gin_weights_are_the_same_bit_for_bit(seed, cell_config):
    cfg = pretrain.train_config(_config(cell_config)).encoder
    from gcc_tpu_torch.models import GraphEncoder

    shapes = _shapes(GraphEncoder(cfg))
    seeds = common.derived_seeds(seed)
    want = _frozen_gin_tensors(shapes, torch.Generator().manual_seed(
        seeds[0]), "cpu")
    got = make_encoder_tensors(shapes, torch.Generator().manual_seed(
        seeds[0]), "cpu", "gin")
    assert list(got) == list(want)
    for n in shapes:
        assert torch.equal(got[n], want[n]), n


def _rules(module) -> dict:
    """Each state-dict tensor's rule, from the module types that own it,
    as the program initialises them: ("uniform", bound), ("fill", value),
    ("stat", lo, hi) or ("normal",)."""
    from gcc_tpu_torch.models.gat import GATLayer
    from gcc_tpu_torch.models.layers import DegreeEmbedding, MaskedBatchNorm

    rules = {}
    for prefix, m in module.named_modules():
        own = {n: f"{prefix}.{n}" if prefix else n
               for n, _ in m.named_parameters(recurse=False)}
        own.update({n: f"{prefix}.{n}" if prefix else n
                    for n, _ in m.named_buffers(recurse=False)})
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            rules.update({full: ("uniform", bound) for full in own.values()})
        elif isinstance(m, (MaskedBatchNorm, nn.LayerNorm)):
            for n, full in own.items():
                rules[full] = {"weight": ("fill", 1.0), "bias": ("fill", 0.0),
                               "running_mean": ("stat", -0.1, 0.1),
                               "running_var": ("stat", 0.5, 2.0)}[n]
        elif isinstance(m, GATLayer):
            for n, full in own.items():
                rules[full] = ("uniform", 1.0 / math.sqrt(m.num_heads))
        elif "weight_hh" in own:
            bound = 1.0 / math.sqrt(m.weight_hh.shape[1])
            rules.update({full: ("uniform", bound) for full in own.values()})
        elif isinstance(m, (nn.Embedding, DegreeEmbedding)):
            rules.update({full: ("normal",) for full in own.values()})
    return rules


def _gcn():
    from gcc_tpu_torch.models.gcn import UnsupervisedGCN

    return UnsupervisedGCN(49, 64, num_layers=2, layernorm=True)


@pytest.mark.parametrize("make", [
    lambda: _encoder("gat"), lambda: _encoder("mpnn"), _gcn,
    lambda: _encoder("gin", use_selayer=True), lambda: _encoder("gin")],
    ids=["gat", "mpnn", "gcn", "gin-selayer", "gin"])
def test_every_encoder_gets_every_tensor_by_its_rule(make):
    module = make()
    shapes = _shapes(module)
    tensors = make_encoder_tensors(shapes, torch.Generator().manual_seed(7),
                                   "cpu")
    module.load_state_dict(tensors, strict=True)
    rules = _rules(module)
    assert set(rules) == set(shapes)
    for n, t in tensors.items():
        rule = rules[n]
        assert t.shape == shapes[n] and torch.isfinite(t).all(), n
        if rule[0] == "uniform":
            amax = float(t.abs().max())
            assert amax <= rule[1], n
            if t.numel() >= 64:
                assert amax >= 0.9 * rule[1], n
        elif rule[0] == "fill":
            assert (t == rule[1]).all(), n
        elif rule[0] == "stat":
            assert rule[1] <= float(t.min()) and float(t.max()) <= rule[2], n


def test_a_model_gives_a_bound_of_its_own(monkeypatch):
    """A parameter no rule covers takes the bound of the model's reference
    module's ``init_bound``; without one the draw names the parameter."""
    shapes = {"gnn.gate": (4, 3), "gnn.fc.weight": (2, 9)}
    mod = types.ModuleType("benchmark.reference.models.tinymodel")
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    with pytest.raises(ValueError, match="gnn.gate"):
        make_encoder_tensors(shapes, torch.Generator().manual_seed(1), "cpu",
                             "tinymodel")
    mod.init_bound = lambda name, shape, shapes: (
        0.01 if name == "gnn.gate" else None)
    out = make_encoder_tensors(shapes, torch.Generator().manual_seed(1), "cpu",
                               "tinymodel")
    assert float(out["gnn.gate"].abs().max()) <= 0.01
    assert 0.9 / 3 <= float(out["gnn.fc.weight"].abs().max()) <= 1.0 / 3


# -- counts ----------------------------------------------------------------

# Sizes and the parent's figures for them, recorded before the counts
# were found by model.
N_NODES = [0, 1, 7, 33, 128, 200, 256]
N_EDGES = [0, 0, 12, 90, 1500, 1024, 2048]
WIRE = {
    "qn": [[208, 22, 46, 60, 46, 205, 223, 149],
           [10, 24, 85, 111, 159, 123, 68, 41],
           [177, 188, 8, 29, 116, 100, 228, 132],
           [107, 110, 171, 150, 44, 189, 194, 245]],
    "qe": [[1610, 582, 655, 1328, 1332, 1426, 1781, 599],
           [1923, 3, 157, 1994, 1934, 611, 285, 643],
           [88, 1827, 1357, 1198, 501, 965, 390, 1584],
           [972, 62, 521, 1448, 1064, 766, 519, 186]],
    "kn": [[156, 169, 133, 239, 238, 53, 156, 161],
           [63, 76, 125, 190, 75, 185, 168, 56],
           [99, 213, 216, 169, 1, 175, 57, 210],
           [234, 110, 245, 194, 83, 225, 98, 26]],
    "ke": [[1215, 1741, 1344, 807, 1848, 982, 790, 299],
           [435, 1431, 1637, 598, 1288, 1784, 304, 564],
           [1073, 1151, 815, 818, 264, 1255, 1908, 402],
           [1633, 369, 90, 1530, 371, 1541, 677, 1161]],
}
DISPATCH_OPS = {"gcc-moco": 3599453148.0, "gcc-e2e": 4017470508.0}


def _wire(n, e):
    n, e = np.array(n), np.array(e)
    return types.SimpleNamespace(meta=np.stack([n, e, np.zeros_like(n)],
                                               axis=-2))


@pytest.mark.parametrize("cell_config", ["gcc-moco", "gcc-e2e"])
def test_gin_counts_are_the_parents(cell_config):
    config = _config(cell_config)
    assert enc_counts.forward(N_NODES, N_EDGES, config) == 42588358.0
    no_model = {k: v for k, v in config.items() if k != "model"}
    assert enc_counts.forward(N_NODES, N_EDGES, no_model) == 42588358.0
    sq, sk = _wire(WIRE["qn"], WIRE["qe"]), _wire(WIRE["kn"], WIRE["ke"])
    assert pretrain.dispatch_ops(sq, sk, config, 0) == \
        DISPATCH_OPS[cell_config]


# -- found by name ---------------------------------------------------------

def test_reference_and_counts_import_nothing_of_the_program():
    import ast

    files = []
    for part in ("reference", "reference/models", "counts",
                 "counts/models"):
        folder = os.path.join(common.BENCH_DIR, part)
        files += [os.path.join(folder, f) for f in os.listdir(folder)
                  if f.endswith(".py")]
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("gcc_tpu", "gcc_tpu_torch",
                                               "jax", "jaxlib", "flax"), \
                    (path, n)


def test_a_model_is_found_by_its_name(monkeypatch):
    """The reference's ``encode`` and the counts' ``forward`` are those of
    the module named by the configuration's model."""
    from benchmark.reference import encoder as ref_encoder

    seen = []
    ref = types.ModuleType("benchmark.reference.models.tinymodel")
    ref.encode = lambda *a, **k: seen.append(("encode", a[7]["model"]))
    cnt = types.ModuleType("benchmark.counts.models.tinymodel")
    cnt.forward = lambda n, e, cfg: float(np.sum(n)) + 0.5
    monkeypatch.setitem(sys.modules, ref.__name__, ref)
    monkeypatch.setitem(sys.modules, cnt.__name__, cnt)
    cfg = {"model": "tinymodel"}
    ref_encoder.encode({}, {}, None, None, None, None, None, cfg,
                       training=False)
    assert seen == [("encode", "tinymodel")]
    assert enc_counts.forward([3, 4], [1, 1], cfg) == 7.5


def _run_copy(root, workload: str):
    env = dict(os.environ, PYTHONPATH=common.ROOT)
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "4294967311", "--seconds", "0.3", "--trace", "0",
         "--device", "cpu", "--override", json.dumps(TINY[workload])],
        cwd=root, capture_output=True, text=True, timeout=300, env=env)


def test_a_missing_model_file_stops_set_up(tmp_path):
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(common.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    moved = {}
    for part in ("reference", "counts"):
        path = tmp_path / "benchmark" / part / "models" / "gin.py"
        moved[path] = path.read_text()
        path.unlink()
    proc = _run_copy(tmp_path, "moco-pretrain")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    for name in ("benchmark/reference/models/gin.py",
                 "benchmark/counts/models/gin.py"):
        assert name in proc.stderr
    for path, text in moved.items():
        path.write_text(text)
    proc = _run_copy(tmp_path, "moco-pretrain")
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]


# -- the run's record ------------------------------------------------------

def _record(monkeypatch, workload: str, trace: int):
    """(record, times the program's tracing() was opened) of a tiny run
    of ``workload`` on the CPU."""
    from gcc_tpu_torch.utils import profiling

    opened = []
    orig = profiling.tracing

    def tracing():
        opened.append(1)
        return orig()

    monkeypatch.setattr(profiling, "tracing", tracing)
    cell, cfg_entry = common.find_cell(BENCH, workload)
    config = common.load_json(os.path.join(common.ROOT, cfg_entry["file"]))
    traffic = common.load_json(common.traffic_path(cell["traffic"]))
    config.update(TINY[workload].get("config", {}))
    traffic.update(TINY[workload].get("traffic", {}))
    limits = common.load_json(common.limits_path(workload))
    args = common.parse_args(["--workload", workload, "--seed", "31337",
                              "--seconds", "0.3", "--trace", str(trace),
                              "--device", "cpu"])
    driver = importlib.import_module(run.DRIVERS[traffic["kind"]])
    rec, _ = driver.run(args, config, traffic, torch.device("cpu"),
                        time.time(), limits)
    return rec, len(opened), config, traffic


def test_untraced_run_opens_no_span(monkeypatch):
    rec, opened, _, _ = _record(monkeypatch, "moco-pretrain", 0)
    assert opened == 0
    assert "spans" not in rec and "trace" not in rec
    assert rec["pipeline"]["gets"] == rec["dispatches"]


def test_traced_training_run_keeps_spans_counters_and_sizes(monkeypatch):
    rec, opened, config, traffic = _record(monkeypatch, "moco-pretrain", 1)
    assert opened == 1
    steps = config["steps_per_dispatch"]
    assert rec["spans"]["gcc.train.dispatch"]["count"] == 1
    assert rec["spans"]["gcc.train.step"]["count"] == steps
    assert rec["pipeline"]["gets"] == rec["dispatches"]
    graphs = rec["step_graphs"]
    # The CPU runs every encoder call eagerly: two a step.
    assert graphs["replays"] == 0
    assert graphs["eager"] == 2 * rec["steps"]
    calls = rec["trace"]["encoder_calls"]
    assert len(calls) == 2 * min(traffic["trace_steps"], steps)
    for c in calls:
        assert c["bucket"] in (config["n_small"], config["n_max"])
        assert len(c["n_nodes"]) == len(c["n_edges"]) == config["batch_size"]
        assert (c["n_nodes"] >= 1).all() and (c["n_edges"] >= 0).all()


def test_traced_embed_run_keeps_spans_and_sizes(monkeypatch):
    rec, opened, _, traffic = _record(monkeypatch, "moco-embed", 1)
    # One call for the table, and the profiled stretch.
    assert opened == 2
    assert rec["spans"]["gcc.generate.call"]["count"] == 1
    assert "gcc.generate.batch" in rec["trace"]["idle_by_span"]
    views = rec["trace"]["encoder_calls"]
    assert len(views) == 2 * traffic["trace_calls"]
    for v in views:
        assert v["bucket"] == traffic["n_max"]
        assert len(v["n_nodes"]) == traffic["batch"]


@pytest.mark.parametrize("workload", ["moco-pretrain", "e2e-pretrain"])
def test_stretch_layout_is_the_programs(workload):
    """The encoder calls the layout names for a dispatch are those the
    program makes: as many, at the same batch, bucket and real nodes."""
    from gcc_tpu_torch.graph.corpus import CorpusStore
    from gcc_tpu_torch.sampling.pipeline import PretrainPipeline
    from gcc_tpu_torch.training.pretrain import (create_pretrain_state,
                                                 train_dispatch)

    from benchmark.harness.corpus import ensure_corpus

    cell, cfg_entry = common.find_cell(BENCH, workload)
    config = common.load_json(os.path.join(common.ROOT, cfg_entry["file"]))
    traffic = common.load_json(common.traffic_path(cell["traffic"]))
    config.update(TINY[workload].get("config", {}))
    traffic.update(TINY[workload].get("traffic", {}))
    cfg = pretrain.train_config(config)
    store = CorpusStore.open(ensure_corpus(config["corpus"]))
    seen = []
    with PretrainPipeline(store, cfg.sampler,
                          pretrain.pipeline_config(config, traffic),
                          seed=5) as pipe:
        state = create_pretrain_state(cfg, total_steps=config["total_steps"],
                                      seed=0, device="cpu")
        models = [state.model] + ([state.ema_model] if config["moco"]
                                  else [])
        hooks = [m.register_forward_pre_hook(
            lambda m, a: seen.append(a[0])) for m in models]
        sq, sk = next(pipe)
        first = (copy.deepcopy(sq), copy.deepcopy(sk))
        train_dispatch(state, sq, sk, n_max=config["n_max"])
        for h in hooks:
            h.remove()
    layout = pretrain.encoder_calls(*first, config,
                                    config["steps_per_dispatch"])
    want = sorted((f.adj.shape[0], f.adj.shape[1],
                   int(f.node_mask.sum())) for f in seen)
    got = sorted((len(c["n_nodes"]), c["bucket"],
                  int(np.minimum(c["n_nodes"], c["bucket"]).sum()))
                 for c in layout)
    assert got == want
