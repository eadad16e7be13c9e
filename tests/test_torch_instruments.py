"""The port's downstream instruments (gcc_tpu_torch.instruments) against
the reference scripts they copy (scripts/role_benchmark.py,
graph_benchmark.py, sim_benchmark.py, finetune_benchmark.py, pe_ab.py):
every fixture byte for byte and by its pinned hash, the baseline scores
on the same scikit-learn, the frozen embeddings and readouts at bridged
weights, the finetune instrument's two arms, embed -> .npz -> score, and
the graph instrument's fold-local standardization."""

import dataclasses
import os
import re
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "scripts"))

import graph_benchmark as jx_graph  # noqa: E402
import role_benchmark as jx_role  # noqa: E402
import sim_benchmark as jx_sim  # noqa: E402

from gcc_tpu import generate as jx_generate  # noqa: E402
from gcc_tpu_torch import instruments  # noqa: E402
from gcc_tpu_torch.config import TrainConfig  # noqa: E402
from gcc_tpu_torch.instruments import (  # noqa: E402
    graph_families,
    role,
    similarity,
)
from gcc_tpu_torch.instruments import __main__ as cli  # noqa: E402
from gcc_tpu_torch.instruments import finetune as ft_instrument  # noqa: E402
from gcc_tpu_torch.instruments import pretrain as recipe_mod  # noqa: E402
from gcc_tpu_torch.training.checkpoint import save_checkpoint  # noqa: E402
from gcc_tpu_torch.training.pretrain import create_pretrain_state  # noqa: E402
from test_torch_generate import encoders, random_subgraphs  # noqa: E402

torch.set_num_threads(1)


def _same_graph(a, b):
    assert a.num_nodes == b.num_nodes
    assert a.indptr.dtype == b.indptr.dtype
    assert a.indices.dtype == b.indices.dtype
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)


# -- fixtures, byte for byte, and their pins ----------------------------------

def test_role_v1_matches_the_script():
    g, y = role.build_role_graph(60)
    jg, jy = jx_role.build_role_graph(60)
    _same_graph(g, jg)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("kw,pin,nodes", [
    ({}, "fcf2d5d7f2d77871", 6307),            # the role instrument's graph
    ({"blocks": 60}, "10a9ec75cb0e9f7d", 3132),  # the finetune instrument's
])
def test_role_v2_matches_the_script_and_its_pin(kw, pin, nodes):
    """The first pin is tests/test_benchmark_instruments.py's; the second
    pins the finetune instrument's graph, which nothing pinned before."""
    g, y = role.build_role_graph_v2(**kw)
    jg, jy = jx_role.build_role_graph_v2(**kw)
    _same_graph(g, jg)
    np.testing.assert_array_equal(y, jy)
    assert g.num_nodes == nodes
    assert role.role_hash(g) == pin
    assert pin == (role.ROLE_V2_HASH if not kw else role.ROLE_V2_60_HASH)


def test_graph_families_match_the_script_and_their_pin():
    graphs, y = graph_families.build_graph_benchmark(60)
    jgraphs, jy = jx_graph.build_graph_benchmark(60)
    assert len(graphs) == len(jgraphs) == 360
    for a, b in zip(graphs, jgraphs):
        _same_graph(a, b)
    np.testing.assert_array_equal(y, jy)
    assert graph_families.families_hash(graphs) == "51a2967aad3ce4d2"
    assert graph_families.FAMILIES_HASH == "51a2967aad3ce4d2"
    dh = graph_families.degree_histogram_embeddings(graphs)
    np.testing.assert_array_equal(dh, jx_graph.degree_histogram_embeddings(
        jgraphs))


def test_sim_pair_matches_the_script_and_its_pin():
    g1, g2, d1, d2 = similarity.build_sim_pair(1000, rewire=0.05)
    jg1, jg2, jd1, jd2 = jx_sim.build_sim_pair(1000, rewire=0.05)
    _same_graph(g1, jg1)
    _same_graph(g2, jg2)
    assert d1 == jd1 and d2 == jd2
    c1, c2 = similarity.correspondence(d1, d2, 1000)
    np.testing.assert_array_equal(c1, np.arange(1000))
    assert similarity.sim_hash(g1, g2, c2) == "0a9c1af5af7ce34c"
    assert similarity.SIM_HASH == "0a9c1af5af7ce34c"
    for g, jg in ((g1, jg1), (g2, jg2)):
        np.testing.assert_array_equal(
            similarity.degree_feature_embeddings(g),
            jx_sim.degree_feature_embeddings(jg))


# -- baseline scores on the same scikit-learn ---------------------------------

def test_degree_hist_score_equals_the_reference():
    """The port's SVC protocol on the port's histograms gives the
    reference's micro-F1 (calibrated 0.8028), inside the window
    tests/test_benchmark_instruments.py holds."""
    from gcc_tpu.tasks.graph_classification import (
        evaluate_graph_embeddings as jx_evaluate,
    )
    from gcc_tpu_torch.tasks import evaluate_graph_embeddings

    graphs, y = graph_families.build_graph_benchmark(60)
    got = evaluate_graph_embeddings(
        graph_families.degree_histogram_embeddings(graphs), y)["Micro-F1"]
    jgraphs, jy = jx_graph.build_graph_benchmark(60)
    want = jx_evaluate(jx_graph.degree_histogram_embeddings(jgraphs),
                       jy)["Micro-F1"]
    assert got == want
    assert 0.75 < got < 0.88, got


def test_degree_feat_recall_equals_the_reference():
    """Degree features' Recall@20/40 on the calibrated sim pair equal the
    reference's (R@20 0.517 at calibration)."""
    from gcc_tpu.tasks.similarity_search import (
        evaluate_similarity as jx_evaluate,
    )
    from gcc_tpu_torch.tasks import evaluate_similarity

    g1, g2, d1, d2 = similarity.build_sim_pair(1000, rewire=0.05)
    jg1, jg2, jd1, jd2 = jx_sim.build_sim_pair(1000, rewire=0.05)
    with np.errstate(invalid="ignore", divide="ignore"):
        got = evaluate_similarity(similarity.degree_feature_embeddings(g1),
                                  similarity.degree_feature_embeddings(g2),
                                  d1, d2)
        want = jx_evaluate(jx_sim.degree_feature_embeddings(jg1),
                           jx_sim.degree_feature_embeddings(jg2), jd1, jd2)
    assert got == want
    assert got["Recall @ 20"] == pytest.approx(0.517, abs=5e-4)


# -- the slice as a whole at bridged weights ----------------------------------

N_MAX, E_MAX = 32, 512


def test_role_embeddings_match_the_reference(monkeypatch):
    """Role v2 at blocks=4 (213 nodes) through the port's role protocol and
    the reference script's (node_subgraphs, generate_embeddings), a GIN
    of 2 layers, hidden 16, PE 8 with Flax weights bridged: the RWR views
    equal, and the embeddings by tests/test_torch_generate.py's rule for
    the eval profile's subspace PE (JAX's Pallas kernel in interpret
    mode): within 2e-2 abs, cosine >= 0.999 per node. (The exact-PE rule,
    1e-4, has no hold here: cliques, cycles and grids have repeated
    eigenvalues, so an exact eigenvector basis is any rotation within
    them, and LAPACK's choice differs between the packages.)"""
    monkeypatch.setenv("GCC_TPU_PE_PALLAS", "interpret")
    subs0 = random_subgraphs(np.random.default_rng(0), 4, 12, N_MAX)
    jcfg, jstate, cfg, model = encoders("subspace", subs0)
    g, _ = role.build_role_graph_v2(blocks=4)
    jg, _ = jx_role.build_role_graph_v2(blocks=4)
    got, t = role.role_embeddings(cfg, model, g, N_MAX, E_MAX, device="cpu")
    assert set(t) == {"sample_s", "encode_s"}
    jq, jk = jx_generate.node_subgraphs(jg, jcfg, N_MAX, E_MAX,
                                        two_views=True)
    from gcc_tpu_torch.generate import node_subgraphs

    q, k = node_subgraphs(g, cfg, N_MAX, E_MAX, two_views=True)
    for a, b in zip(q + k, jq + jk):
        assert a.num_nodes == b.num_nodes
        np.testing.assert_array_equal(a.src, b.src)
        np.testing.assert_array_equal(a.dst, b.dst)
    want = jx_generate.generate_embeddings(jcfg, jstate, jq, n_max=N_MAX,
                                           e_max=E_MAX, subgraphs_k=jk)
    assert got.shape == want.shape == (213, 16)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999, cos.min()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def test_graph_readouts_match_the_reference():
    """Two graphs a family (12 graphs of 66-115 nodes, n_max 128) through
    the port's graph protocol and the reference script's
    (generate_graph_readouts, composite_graph_readout), bridged weights,
    exact PE: both readouts within 1e-4 (test_torch_generate.py's rule for
    entire-graph readouts; these random graphs have separated spectra)."""
    subs0 = random_subgraphs(np.random.default_rng(0), 4, 12, N_MAX)
    jcfg, jstate, cfg, model = encoders("eigh", subs0)
    graphs, _ = graph_families.build_graph_benchmark(2)
    jgraphs, _ = jx_graph.build_graph_benchmark(2)
    got, t = graph_families.graph_readouts(cfg, model, graphs, 128, 8192,
                                           device="cpu")
    ro = jx_generate.generate_graph_readouts(jcfg, jstate, jgraphs,
                                             n_max=128, e_max=8192)
    np.testing.assert_allclose(got["score"], ro["score"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["composite"],
                               jx_generate.composite_graph_readout(ro),
                               rtol=0, atol=1e-4)
    assert got["composite"].shape == (12, (8 + 4 + 1) + 16)


def test_sim_embeddings_follow_the_protocol():
    """The sim protocol's score rows are generate_embeddings' and its
    composite the two views' mean composite readout, per graph."""
    from gcc_tpu_torch import generate

    subs0 = random_subgraphs(np.random.default_rng(0), 4, 12, N_MAX)
    _, _, cfg, model = encoders("eigh", subs0)
    g1, g2, _, _ = similarity.build_sim_pair(60, rewire=0.05)
    embs, comps, t = similarity.sim_embeddings(cfg, model, (g1, g2), N_MAX,
                                               E_MAX, device="cpu")
    q, k = generate.node_subgraphs(g2, cfg, N_MAX, E_MAX, two_views=True)
    kw = dict(n_max=N_MAX, e_max=E_MAX, device="cpu")
    np.testing.assert_array_equal(embs[1], generate.generate_embeddings(
        cfg, model, q, subgraphs_k=k, **kw))
    ro_q = generate.generate_subgraph_readouts(cfg, model, q, **kw)
    ro_k = generate.generate_subgraph_readouts(cfg, model, k, **kw)
    np.testing.assert_array_equal(comps[1], (
        generate.composite_graph_readout(ro_q)
        + generate.composite_graph_readout(ro_k)) / 2.0)
    assert embs[0].shape == (60, 16) and t["sample_s"] >= 0


# -- the rest of the pipeline on the CPU --------------------------------------

ENC = dict(num_layers=2, hidden_size=16, output_size=16,
           positional_embedding_size=8, degree_embedding_size=4)


def tiny_checkpoint(path, weights_seed=0):
    """A checkpoint of a small GIN's random weights (drawn from
    ``weights_seed``), with its config (seed 0)."""
    from gcc_tpu_torch.config import ContrastConfig, EncoderConfig

    cfg = TrainConfig(batch_size=32, encoder=EncoderConfig(**ENC),
                      contrast=ContrastConfig(moco=True, nce_k=64))
    state = create_pretrain_state(cfg, 10, seed=weights_seed, device="cpu")
    return save_checkpoint(str(path), state, cfg)


def test_finetune_instrument_two_arms(tmp_path, monkeypatch):
    """Both arms at blocks=4, 1 epoch, fold 0 on the CPU: the reference's
    JSON keys, finite F1; the scratch arm reads no tensor (torch.load is
    never called) and does not depend on the checkpoint's weights."""
    ckpt = tiny_checkpoint(tmp_path / "a", weights_seed=1)
    out = tmp_path / "ft.json"
    kw = dict(blocks=4, epochs=1, folds=[0], n_max=N_MAX, e_max=E_MAX,
              log_fn=lambda s: None, device="cpu")
    rec = ft_instrument.run_finetune_instrument(ckpt, out=str(out), **kw)
    import json

    saved = json.loads(out.read_text())
    assert {"ckpt", "blocks", "epochs", "folds", "results"} <= set(saved)
    assert saved["blocks"] == 4 and saved["epochs"] == 1
    assert saved["folds"] == [0]
    for arm in ("pretrained", "scratch"):
        res = rec["results"][arm]
        assert len(res["folds"]) == 1 and np.isfinite(res["mean"])
    loads = []
    real_load = torch.load

    def counting_load(*a, **k):
        loads.append(a)
        return real_load(*a, **k)

    monkeypatch.setattr(torch, "load", counting_load)
    other = tiny_checkpoint(tmp_path / "b", weights_seed=7)
    scratch = ft_instrument.run_finetune_instrument(other, arms=["scratch"],
                                                    **kw)
    assert loads == []
    assert scratch["results"]["scratch"] == rec["results"]["scratch"]
    ft_instrument.run_finetune_instrument(other, arms=["pretrained"], **kw)
    assert len(loads) == 1
    with pytest.raises(ValueError, match="arms"):
        ft_instrument.run_finetune_instrument(other, arms=["frozen"], **kw)


def test_embed_npz_score_round_trip(tmp_path, monkeypatch):
    """embed writes the three files on the CPU (role v2 at blocks=4, 10
    graphs a family, a sim pair of 60 nodes); score rebuilds each fixture,
    holds it to the file's hash and prints every row of the reference's
    tables; a file from other generators, or a missing scikit-learn,
    raises."""
    ckpt = tiny_checkpoint(tmp_path / "run")
    emb_dir = str(tmp_path / "emb")
    done = cli.embed(ckpt, emb_dir, blocks=4, graphs_per_class=10, sim_n=60,
                     log_fn=lambda s: None, device="cpu")
    assert set(done) == {"role", "graph", "sim"}
    z = np.load(os.path.join(emb_dir, "role.npz"))
    assert z["emb"].shape == (213, 16)
    # The mean of two views' unit rows; one view's rows are unit.
    assert np.linalg.norm(z["emb"], axis=1).max() <= 1 + 1e-5
    z = np.load(os.path.join(emb_dir, "graph.npz"))
    assert z["score"].shape == (60, 16)
    np.testing.assert_allclose(np.linalg.norm(z["score"], axis=1), 1.0,
                               atol=1e-5)
    printed = []
    results = cli.score(emb_dir, log_fn=printed.append)
    assert set(results["role"]) == {"gcc", "prone", "graphwave", "zero"}
    rows = ["gcc", "gcc-composite", "degree-hist", "gcc+dh", "composite+dh"]
    assert set(results["graph"]) == (set(rows) | {r + "/std" for r in rows}
                                     | {"majority"})
    assert set(results["sim"]) == {"gcc", "gcc-composite", "degree-feat",
                                   "graphwave", "prone", "composite+degfeat",
                                   "chance"}
    assert all("error" not in r for r in results["sim"].values())
    for table in results.values():
        for res in table.values():
            assert all(np.isfinite(v) for v in res.values())
    assert any(line.startswith("role graph (v2): 213 nodes")
               for line in printed)
    # The main entry point writes the JSON beside the files.
    cli.main(["score", "--in", emb_dir])
    assert os.path.exists(os.path.join(emb_dir, "scores.json"))

    z = dict(np.load(os.path.join(emb_dir, "role.npz")))
    z["blocks"] = np.int64(5)
    np.savez(os.path.join(emb_dir, "role.npz"), **z)
    with pytest.raises(ValueError, match="hashes to"):
        cli.score(emb_dir, log_fn=lambda s: None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(RuntimeError, match="scikit-learn"):
        cli.score(emb_dir, log_fn=lambda s: None)


def test_fold_local_standardization():
    """evaluate_graph_embeddings(standardize=True) fits each fold's
    StandardScaler on that fold's train rows only: a spy on fit sees, fold
    by fold, exactly the rows StratifiedKFold puts in train, never a test
    row. The graph instrument's /std rows rest on this."""
    from sklearn import preprocessing
    from sklearn.model_selection import StratifiedKFold

    from gcc_tpu_torch.tasks import evaluate_graph_embeddings

    rng = np.random.default_rng(0)
    x = rng.standard_normal((100, 4))
    # Row i carries its index in a fifth column, so each fit's rows are
    # known exactly.
    x = np.concatenate([x, np.arange(100, dtype=np.float64)[:, None]], 1)
    y = (x[:, 0] > 0).astype(int)
    seen = []
    real_fit = preprocessing.StandardScaler.fit

    def spy(self, data, *a, **k):
        seen.append(np.asarray(data)[:, -1].astype(int))
        return real_fit(self, data, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(preprocessing.StandardScaler, "fit", spy)
        evaluate_graph_embeddings(x, y, standardize=True)
    folds = list(StratifiedKFold(n_splits=10, shuffle=True,
                                 random_state=0).split(x, y))
    assert len(seen) == len(folds) == 10
    for rows, (train_idx, test_idx) in zip(seen, folds):
        np.testing.assert_array_equal(rows, train_idx)
        assert not set(rows) & set(test_idx)


# -- the pre-training recipe and the package's rules --------------------------

def test_recipe_is_the_reference_child():
    """The (TrainConfig, PipelineConfig) pair of scripts/pe_ab.py:66-81,
    field for field, with epochs and seed taken as arguments."""
    from gcc_tpu.config import (
        ContrastConfig,
        EncoderConfig,
        SamplerConfig,
        TrainConfig as JxTrainConfig,
    )
    from gcc_tpu.sampling.pipeline import PipelineConfig

    cfg, pcfg = recipe_mod.recipe(epochs=16, seed=3)
    want = JxTrainConfig(
        batch_size=32, epochs=16, seed=3, num_samples=2000, num_workers=1,
        sampler=SamplerConfig(rw_hops=256),
        contrast=ContrastConfig(moco=True, nce_k=16384),
        encoder=EncoderConfig(pe_method="subspace"))
    want_p = PipelineConfig(
        batch_size=32, n_max=256, e_max=2048, num_samples=2000,
        num_workers=1, mode="thread", emit="routed", super_batch=62,
        n_small=128)
    got = dataclasses.asdict(cfg)
    assert {k: got[k] for k in dataclasses.asdict(want)} == \
        dataclasses.asdict(want)
    got_p = dataclasses.asdict(pcfg)
    assert {k: got_p[k] for k in dataclasses.asdict(want_p)} == \
        dataclasses.asdict(want_p)
    assert recipe_mod.STEPS_PER_CALL == 62


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    ckpt = tiny_checkpoint(tmp_path / "run")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.embed(ckpt, str(tmp_path / "emb"), which=["graph"],
                  log_fn=lambda s: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ft_instrument.run_finetune_instrument(ckpt, blocks=4, epochs=1,
                                              log_fn=lambda s: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        recipe_mod.pretrain(str(tmp_path / "pre"), epochs=1,
                            corpus=str(tmp_path / "none"),
                            log_fn=lambda s: None)


def test_the_package_imports_nothing_of_the_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|gcc_tpu\b|gcc_tpu\.|"
                         r"role_benchmark|graph_benchmark|sim_benchmark)",
                         re.M)
    root = os.path.dirname(instruments.__file__)
    files = sorted(f for f in os.listdir(root) if f.endswith(".py"))
    assert files == ["__init__.py", "__main__.py", "finetune.py",
                     "graph_families.py", "pretrain.py", "role.py",
                     "similarity.py"]
    for name in files:
        with open(os.path.join(root, name)) as f:
            assert not pattern.search(f.read()), name
