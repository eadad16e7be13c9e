"""The port keeps its own copies of gcc_tpu's jax-free modules (``data``,
``tasks``, ``models/emb``) and imports nothing of gcc_tpu: each copy
gives the output of the original on the same seeded inputs."""

import importlib
import os

import numpy as np
import pytest

pytest.importorskip("jax")      # gcc_tpu's package import needs it

PACKAGES = ("gcc_tpu", "gcc_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _random_graph_edges(rng, n, m):
    ring = np.arange(n)
    u = np.concatenate([ring, rng.integers(0, n, m)])
    v = np.concatenate([(ring + 1) % n, rng.integers(0, n, m)])
    keep = u != v
    return u[keep], v[keep]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Files in the reference layouts, made from a seed: two edgelist +
    nodelabel sets (airport and h-index naming), two panther graphs with
    name dictionaries."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for sub, name, classes in (("struc2vec", "usa-airports", 4),
                               ("hindex", "aminer_hindex_rand20intop200_5000",
                                40)):
        os.makedirs(root / sub)
        ids = rng.permutation(500)[:120] + 7          # raw, non-contiguous
        u, v = _random_graph_edges(rng, 120, 300)
        with open(root / sub / f"{name}.edgelist", "w") as f:
            f.writelines(f"{ids[a]} {ids[b]}\n" for a, b in zip(u, v))
        with open(root / sub / f"{name}.nodelabel", "w") as f:
            f.writelines(f"{i} {rng.integers(0, classes)}\n" for i in ids)
    os.makedirs(root / "panther")
    for name in ("kdd", "icdm"):
        u, v = _random_graph_edges(rng, 80, 150)
        with open(root / "panther" / f"{name}.graph", "w") as f:
            f.write(f"80 {len(u)}\n")
            f.writelines(f"{a} {b} {rng.integers(1, 4)}\n"
                         for a, b in zip(u, v))
        with open(root / "panther" / f"{name}.dict", "w") as f:
            f.writelines(f"author {i}\t{rng.integers(0, 90)}\n"
                         for i in rng.permutation(60)[:40])
    return str(root)


def _graph_arrays(g):
    return [np.asarray(g.indptr), np.asarray(g.indices)]


def _tu_graphs(pkg, seed=1, count=30):
    rng = np.random.default_rng(seed)
    csr = _mod(pkg, "graph.csr").CSRGraph
    graphs = []
    for _ in range(count):
        n = int(rng.integers(5, 20))
        graphs.append(csr.from_edges(*_random_graph_edges(rng, n, n),
                                     num_nodes=n))
    return graphs, rng.integers(0, 3, count) * 5     # labels 0, 5, 10


def _embeddings(seed, n, d=8):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def case_edgelist(pkg, root, tmp):
    d = _mod(pkg, "data.formats").create_node_classification_dataset(
        "usa_airport", root)
    return _graph_arrays(d.graph) + [d.y, sorted(d.node2id.items())]


def case_hindex(pkg, root, tmp):
    d = _mod(pkg, "data.formats").create_node_classification_dataset(
        "h-index", root)
    assert d.y.shape[1] == 2
    return _graph_arrays(d.graph) + [d.y]


def case_panther(pkg, root, tmp):
    fm = _mod(pkg, "data.formats")
    single = fm.create_node_classification_dataset("kdd", root)
    out = _graph_arrays(single.graph)
    for d in fm.SSDataset(os.path.join(root, "panther"), "kdd", "icdm").data:
        out += _graph_arrays(d.graph) + [sorted(d.names.items())]
    return out


def case_tu(pkg, root, tmp):
    tu = _mod(pkg, "data.tu")
    graphs, labels = _tu_graphs(pkg)
    tu.save_tu_dataset(tmp, "IMDB-BINARY", graphs, labels)
    loaded, y = tu.load_tu_dataset("imdb-binary", tmp)
    assert len(loaded) == 30 and set(y) == {0, 1, 2}
    out = [y]
    for g in loaded:
        out += _graph_arrays(g)
    for suffix in ("A", "graph_indicator", "graph_labels"):
        with open(os.path.join(tmp, "IMDB-BINARY",
                               f"IMDB-BINARY_{suffix}.txt")) as f:
            out.append(f.read())
    return out


def case_ingest(pkg, root, tmp):
    files = [os.path.join(root, "struc2vec", "usa-airports.edgelist"),
             os.path.join(root, "hindex",
                          "aminer_hindex_rand20intop200_5000.edgelist")]
    store = _mod(pkg, "data.ingest").ingest_edgelists(
        files, os.path.join(tmp, "corpus"))
    out = [list(store.graph_sizes)]
    for i in range(store.num_graphs):
        out += _graph_arrays(store.load(i))
    return out


def case_eval_node(pkg, root, tmp):
    y = np.zeros((200, 3), np.float32)
    lab = np.random.default_rng(2).integers(0, 3, 200)
    y[np.arange(200), lab] = 1
    emb = _embeddings(2, 200) + 2.0 * y @ _embeddings(3, 3)
    res = _mod(pkg, "tasks").evaluate_node_embeddings(emb, y, seed=1)
    assert res["Micro-F1"] > 0.5
    return [res]


def case_eval_graph(pkg, root, tmp):
    lab = np.random.default_rng(4).integers(0, 2, 120)
    emb = _embeddings(4, 120) + 1.5 * lab[:, None]
    ev = _mod(pkg, "tasks").evaluate_graph_embeddings
    return [ev(emb, lab, seed=0), ev(emb * [1, 10, 100, 1, 1, 1, 1, 1], lab,
                                     seed=0, standardize=True)]


def case_eval_sim(pkg, root, tmp):
    e1, e2 = _embeddings(5, 60), _embeddings(5, 70)[:, ::-1] * 0.5
    rng = np.random.default_rng(6)
    d1 = {f"a{i}": int(rng.integers(0, 64)) for i in range(50)}
    d2 = {f"a{i}": int(rng.integers(0, 70)) for i in range(10, 55)}
    return [_mod(pkg, "tasks").evaluate_similarity(e1, e2, d1, d2,
                                                   k_list=(5, 20))]


def _emb_graph(pkg):
    rng = np.random.default_rng(7)
    return _mod(pkg, "graph.csr").CSRGraph.from_edges(
        *_random_graph_edges(rng, 150, 500), num_nodes=150, symmetrize=True)


def case_prone(pkg, root, tmp):
    emb = _mod(pkg, "models.emb").build_model("prone", 16).train(
        _emb_graph(pkg))
    assert emb.shape == (150, 16) and np.isfinite(emb).all()
    return [emb]


def case_graphwave(pkg, root, tmp):
    emb = _mod(pkg, "models.emb").build_model("graphwave", 16).train(
        _emb_graph(pkg))
    assert emb.shape[0] == 150 and np.isfinite(emb).all()
    return [emb]


def case_task_classes(pkg, root, tmp):
    """The task front ends with embeddings read from files (what the
    eval-node / eval-graph / eval-sim commands run), and the zero
    baseline."""
    tasks = _mod(pkg, "tasks")
    path = os.path.join(tmp, "emb.npy")
    np.save(path, _embeddings(8, 120))
    out = [tasks.NodeClassification("usa_airport", 8, 0, model="from_numpy",
                                    data_root=root, emb_path=path).train()]
    graphs, labels = _tu_graphs(pkg, count=40)
    _mod(pkg, "data.tu").save_tu_dataset(tmp, "IMDB-BINARY", graphs, labels)
    gpath = os.path.join(tmp, "gemb.npy")
    np.save(gpath, _embeddings(9, 40) + labels[:, None])
    out.append(tasks.GraphClassification(
        "imdb-binary", 8, 0, model="from_numpy_graph", data_root=tmp,
        emb_path=gpath).train())
    p1, p2 = os.path.join(tmp, "e1.npy"), os.path.join(tmp, "e2.npy")
    sizes = [d.graph.num_nodes for d in _mod(pkg, "data.formats").SSDataset(
        os.path.join(root, "panther"), "kdd", "icdm").data]
    np.save(p1, _embeddings(10, sizes[0]))
    np.save(p2, _embeddings(11, sizes[1]))
    out.append(tasks.SimilaritySearch(
        "kdd", "icdm", 8, model="from_numpy_align", data_root=root,
        emb_path_1=p1, emb_path_2=p2).train())
    out.append(_mod(pkg, "models.emb").build_model("zero", 4).train(
        _emb_graph(pkg)))
    return out


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


# Equal means equal, except where the original itself is not repeatable
# to the last bit: GraphWave bounds its spectrum with a Lanczos run from
# a random start vector (a relative 1e-14 on the bound, seen 5e-15 on the
# embedding).
ATOL = {"graphwave": 1e-9}


def _same(a, b, where, atol=0.0):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]", atol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]", atol)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_gives_the_originals_output(case, data_root, tmp_path):
    outs = []
    for pkg in PACKAGES:
        tmp = tmp_path / pkg
        tmp.mkdir()
        outs.append(CASES[case](pkg, data_root, str(tmp)))
    _same(outs[1], outs[0], case, ATOL.get(case, 0.0))


def test_port_modules_import_without_scikit_learn_or_jax():
    """``import gcc_tpu_torch`` and its generate, loop, tasks and cli
    modules pull in neither scikit-learn (imported inside the evaluators)
    nor jax nor gcc_tpu, checked in a fresh interpreter."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import gcc_tpu_torch, gcc_tpu_torch.generate, gcc_tpu_torch.cli\n"
        "import gcc_tpu_torch.training.loop, gcc_tpu_torch.tasks\n"
        "import gcc_tpu_torch.data, gcc_tpu_torch.models.emb\n"
        "import gcc_tpu_torch.training.checkpoint, gcc_tpu_torch.compat\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('sklearn', 'jax', 'flax', 'optax', 'orbax', 'gcc_tpu')]\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                   timeout=120)
