"""The harness is driven by data: a configuration, a traffic mix, a cell,
a metric and its limits added as files alone are found by name; the
no-JAX check compares whole top-level module names."""

from __future__ import annotations

import json
import os
import sys

from benchmark.harness import common
from benchmark.tests.tiny import TINY, run_cell


def test_cell_added_from_files_alone(capsys, tmp_path):
    tag = f"t{os.getpid()}"
    bench = common.load_json(os.path.join(common.ROOT, "BENCHMARK.json"))
    made = []

    def write(path, text):
        with open(path, "w") as f:
            f.write(text)
        made.append(path)

    try:
        cfg = common.load_json(os.path.join(common.BENCH_DIR, "configs",
                                            "gcc-moco.json"))
        cfg.update(TINY["moco-pretrain"]["config"], hidden_size=32,
                   output_size=32)
        cfg_file = f"benchmark/configs/{tag}-cfg.json"
        write(os.path.join(common.ROOT, cfg_file), json.dumps(cfg))
        traffic = common.load_json(common.traffic_path("pretrain"))
        traffic.update(TINY["moco-pretrain"]["traffic"], prefetch=2)
        write(common.traffic_path(f"{tag}-mix"), json.dumps(traffic))
        write(common.limits_path(f"{tag}-cell"), json.dumps(
            common.load_json(common.limits_path("moco-pretrain"))))
        write(os.path.join(common.BENCH_DIR, "metrics",
                           f"{tag}_dispatches.py"),
              "def read(rec):\n    return rec.get('dispatches')\n")
        bench["configs"].append({"name": f"{tag}-cfg", "source": "test",
                                 "file": cfg_file, "reduced": [],
                                 "why": "test"})
        bench["workloads"].append({"name": f"{tag}-cell",
                                   "config": f"{tag}-cfg",
                                   "traffic": f"{tag}-mix", "chips": 1,
                                   "why": "test"})
        bench["end_to_end"].append({"name": f"{tag}_dispatches",
                                    "unit": "dispatches", "better": "higher",
                                    "bound": 0.25, "source": "host_clock",
                                    "workloads": [f"{tag}-cell"]})
        path = tmp_path / "BENCHMARK.json"
        path.write_text(json.dumps(bench))
        line = run_cell(capsys, f"{tag}-cell", override={}, bench=str(path))
        assert line["correct"] is True
        assert line["metrics"][f"{tag}_dispatches"]["value"] >= 1
        assert set(line["metrics"]) == {"setup_s", f"{tag}_dispatches"}
    finally:
        for p in made:
            os.remove(p)


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    fake = object()
    for name in ("jaxtyping", "gcc_tpu_torch.fake", "flaxen", "jaxlibx"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert common.forbidden_loaded() == []
    for name in ("gcc_tpu.ops", "jax.numpy", "flax", "jaxlib.xla"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert common.forbidden_loaded() == ["flax", "gcc_tpu.ops", "jax.numpy",
                                         "jaxlib.xla"]


def test_reference_imports_nothing_of_the_program():
    import ast

    ref = os.path.join(common.BENCH_DIR, "reference")
    check = os.path.join(common.BENCH_DIR, "harness", "check.py")
    files = [os.path.join(ref, f) for f in os.listdir(ref)
             if f.endswith(".py")] + [check]
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


def test_copied_corpus_generator_matches_the_program(tmp_path):
    from gcc_tpu_torch.graph.corpus import synthetic_corpus

    from benchmark.harness.corpus import corpus_graphs

    store = synthetic_corpus(str(tmp_path), num_graphs=3,
                             nodes_per_graph=2000, avg_degree=8, seed=5)
    ours = corpus_graphs(3, 2000, 8, 5)
    for i, (indptr, indices) in enumerate(ours):
        g = store.load(i, mmap=False)
        assert (g.indptr == indptr).all() and (g.indices == indices).all()
