"""The port's accuracy A/B entry points (gcc_tpu_torch.scripts.pe_ab,
e2e_canonical, graph_readout_ab) against the reference scripts they copy
(scripts/pe_ab.py, e2e_canonical.py, graph_readout_ab.py).

The reference scripts build their configurations inside the functions
that train, and select an arm through the environment of a child
process. The tests run those functions with the training and the child
process replaced by recorders (and the compilation cache left alone), so
each arm's configuration, environment and corpus are read from the
reference's own code, then held field for field against the port's.
The readout compositions are held to the reference's on the same numpy
readouts, the summary to hand computations on the reference's recorded
seeds, the eigh-pinned role transfer to the reference's generate at
bridged weights, and every card entry point to its refusal without CUDA.
"""

import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "scripts"))

import e2e_canonical as jx_e2e  # noqa: E402
import graph_readout_ab as jx_readout  # noqa: E402
import pe_ab as jx_pe_ab  # noqa: E402
import role_benchmark as jx_role  # noqa: E402

from gcc_tpu import generate as jx_generate  # noqa: E402
from gcc_tpu_torch.config import EncoderConfig  # noqa: E402
from gcc_tpu_torch.instruments import role  # noqa: E402
from gcc_tpu_torch.scripts import (  # noqa: E402
    e2e_canonical,
    graph_readout_ab,
    pe_ab,
)
from test_torch_generate import encoders, random_subgraphs  # noqa: E402

torch.set_num_threads(1)

# The encoder fields the port adds to the reference's, which reads them
# from the environment: the storage levers and the PE guards.
SWITCH_FIELDS = ("adj_dtype", "jacobi_v_dtype", "pe_guards")


class _Trained(Exception):
    """Raised by the recorder that stands in for run_pretrain."""


def _recorder(seen):
    def run_pretrain(cfg, corpus, out, pcfg=None, steps_per_call=None,
                     **kw):
        seen.update(cfg=cfg, corpus=corpus, pcfg=pcfg,
                    steps_per_call=steps_per_call)
        raise _Trained
    return run_pretrain


def _corpus_dir(path):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write("{}")
    return str(path)


def _reference_arm_envs(tmp_path, monkeypatch):
    """{arm: the environment scripts/pe_ab.py's parent loop hands that
    arm's child}, read by running the loop with subprocess.run recording
    each call and writing the result the loop then reads."""
    monkeypatch.setattr(jx_pe_ab, "DIVERSE_CORPUS",
                        _corpus_dir(tmp_path / "diverse"))
    envs = {}

    def run(cmd, env=None, **kw):
        arm = cmd[cmd.index("--method") + 1]
        envs[arm] = env
        out = cmd[cmd.index("--out") + 1]
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "pe_ab_v2.json"), "w") as f:
            json.dump({"method": arm, "seed": 0, "avg_loss": 0.0,
                       "role": {"Micro-F1": 0.5}}, f)
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(jx_pe_ab.subprocess, "run", run)
    monkeypatch.setattr(sys, "argv", [
        "pe_ab.py", "--seeds", "0", "--root", str(tmp_path / "root"),
        "--arms", *jx_pe_ab.ARMS])
    jx_pe_ab.main()
    return envs


@pytest.fixture(scope="module")
def reference_arms(tmp_path_factory):
    """{arm: (environment, TrainConfig, PipelineConfig, whether the corpus
    is the diverse one, steps_per_call)} of the reference's parent loop
    and child at seed 1, 16 epochs."""
    tmp = tmp_path_factory.mktemp("pe_ab")
    mp = pytest.MonkeyPatch()
    try:
        envs = _reference_arm_envs(tmp, mp)
        import gcc_tpu.cli
        import gcc_tpu.training.loop

        mp.setattr(gcc_tpu.cli, "_enable_compilation_cache", lambda: None)
        out = {}
        for arm, env in envs.items():
            seen = {}
            mp.setattr(gcc_tpu.training.loop, "run_pretrain", _recorder(seen))
            corpus = env.get("GCC_TPU_BENCH_CORPUS",
                             _corpus_dir(tmp / "bench"))
            with mp.context() as m:
                m.setattr(os, "environ", dict(env))
                m.setenv("GCC_TPU_BENCH_CORPUS", corpus)
                args = types.SimpleNamespace(
                    method=arm, seed=1, epochs=16, out=str(tmp / arm),
                    bench="v2", motifs=200)
                with pytest.raises(_Trained):
                    jx_pe_ab.child(args)
            out[arm] = (env, seen["cfg"], seen["pcfg"],
                        seen["corpus"] == jx_pe_ab.DIVERSE_CORPUS,
                        seen["steps_per_call"])
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("arm", list(pe_ab.ARMS))
def test_pe_ab_arm_matches_the_reference(arm, reference_arms):
    """Each arm's (TrainConfig, PipelineConfig) field for field against the
    reference child's (pe_ab.py:66-81); the port's levers and the guards
    its training PE gets against the variables the parent loop sets for
    the arm (:196-215); the guards a later use of its checkpoint gets
    (the eval profile's 16 for every arm: the reference's variable lives
    in the child process, not in its checkpoint); its corpus (the diverse
    one for -div, made by the same generator at the same seed) and its
    62 steps a dispatch."""
    from gcc_tpu_torch.features.positional import pe_guards
    from gcc_tpu_torch.instruments.pretrain import STEPS_PER_CALL

    env, want_cfg, want_pcfg, diverse, steps = reference_arms[arm]
    cfg, pcfg = pe_ab.arm_config(arm, epochs=16, seed=1)
    got = dataclasses.asdict(cfg)
    switches = {k: got["encoder"].pop(k) for k in SWITCH_FIELDS}
    assert got == dataclasses.asdict(want_cfg)
    got_p = dataclasses.asdict(pcfg)
    assert {k: got_p[k] for k in dataclasses.asdict(want_pcfg)} == \
        dataclasses.asdict(want_pcfg)
    lever = lambda v: "bfloat16" if env.get(v) == "bf16" else "float32"  # noqa: E731
    guards = switches.pop("pe_guards")
    assert switches == {"adj_dtype": lever("GCC_TPU_ADJ_DTYPE"),
                        "jacobi_v_dtype": lever("GCC_TPU_JACOBI_V_DTYPE")}
    assert not {"GCC_TPU_PE_RR", "GCC_TPU_PE_RR_SWEEPS"} & set(env)
    profile = lambda p: pe_guards(p) if guards is None else guards  # noqa: E731
    assert profile("train") == int(env["GCC_TPU_PE_GUARDS"])
    assert profile("eval") == 16
    assert pe_ab.ARMS[arm].diverse == diverse
    assert steps == STEPS_PER_CALL
    assert set(pe_ab.ARMS) == set(jx_pe_ab.ARMS)
    assert pe_ab.DEFAULT_ARMS == jx_pe_ab.ARMS[:3]


@pytest.mark.parametrize("arm", ["subspace-g0", "subspace"])
def test_an_arm_checkpoint_generates_at_16_guards(arm, tmp_path,
                                                  monkeypatch):
    """generate_embeddings from an arm's checkpoint sidecar (its
    configuration as load_config reads it back) runs the subspace PE at
    the eval profile's 16 guards, the g0 arms' included, as generate
    from one of the reference's checkpoints does."""
    from gcc_tpu_torch import generate
    from gcc_tpu_torch.features import positional
    from gcc_tpu_torch.models import GraphEncoder
    from gcc_tpu_torch.training.checkpoint import load_config

    cfg, _ = pe_ab.arm_config(arm)
    os.makedirs(tmp_path / "run")
    with open(tmp_path / "run" / "config.json", "w") as f:
        f.write(cfg.to_json())
    cfg = load_config(str(tmp_path / "run"))
    seen = []

    def recorder(*args, guards, **kw):
        seen.append(guards)
        raise _Trained

    monkeypatch.setattr(positional, "subspace_topk", recorder)
    subs = random_subgraphs(np.random.default_rng(0), 2, 12, 32)
    with pytest.raises(_Trained):
        generate.generate_embeddings(cfg, GraphEncoder(cfg.encoder), subs,
                                     n_max=32, e_max=256, device="cpu")
    assert seen == [16]


def test_e2e_canonical_config_matches_the_reference(tmp_path, monkeypatch):
    """e2e_config against the configuration scripts/e2e_canonical.py hands
    run_pretrain (:50-64), with its 8 steps a dispatch."""
    import gcc_tpu.cli
    import gcc_tpu.training.loop

    seen = {}
    monkeypatch.setattr(gcc_tpu.cli, "_enable_compilation_cache",
                        lambda: None)
    monkeypatch.setattr(gcc_tpu.training.loop, "run_pretrain",
                        _recorder(seen))
    monkeypatch.setenv("GCC_TPU_BENCH_CORPUS",
                       _corpus_dir(tmp_path / "corpus"))
    monkeypatch.setattr(sys, "argv", ["e2e_canonical.py", "--out",
                                      str(tmp_path / "out")])
    with pytest.raises(_Trained):
        jx_e2e.main()
    cfg, pcfg = e2e_canonical.e2e_config()
    got = dataclasses.asdict(cfg)
    switches = {k: got["encoder"].pop(k) for k in SWITCH_FIELDS}
    assert switches == {k: getattr(EncoderConfig(), k) for k in SWITCH_FIELDS}
    assert got == dataclasses.asdict(seen["cfg"])
    got_p = dataclasses.asdict(pcfg)
    want_p = dataclasses.asdict(seen["pcfg"])
    assert {k: got_p[k] for k in want_p} == want_p
    assert seen["steps_per_call"] == e2e_canonical.STEPS_PER_CALL


def test_assemble_variants_matches_the_reference():
    """The 15 compositions, bit for bit the reference script's on the same
    readouts (a GIN of 5 layers: the pooled input and 4 conv layers)."""
    rng = np.random.default_rng(0)
    g = 30
    ro = {"score": rng.standard_normal((g, 16)).astype(np.float32),
          "pooled": [rng.standard_normal((g, w)).astype(np.float32)
                     for w in (13, 16, 16, 16, 16)],
          "n_nodes": rng.integers(5, 100, g).astype(np.float32)}
    ro["pooled"][2][3] = 0.0          # a zero row: the L2 guard
    got = graph_readout_ab.assemble_variants(ro)
    want = jx_readout.assemble_variants(ro)
    assert list(got) == list(want) and len(got) == 15
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert graph_readout_ab.HEADLINE == ("score", "inmean+convl2",
                                         "layercat", "in_pooled_mean")


def test_summary_means_stds_and_paired_deltas():
    """summarize on the reference's recorded v2 readings (docs/PERF.md,
    round 4): its means (to the 4 places it prints), its stds (np.std
    over seeds, within 1e-4 of the table's, which the reference took from
    the unrounded readings) and its paired g0 − eigh deltas, +0.0086 /
    +0.0118 / +0.0119; a delta only over the seeds both arms ran; pairs
    with a missing arm left out."""
    f1 = {"eigh": {0: 0.7577, 1: 0.7507, 2: 0.7606},
          "subspace": {0: 0.7582, 1: 0.7515, 2: 0.7644},
          "subspace-g0": {0: 0.7663, 1: 0.7625, 2: 0.7725},
          "subspace-g0-stacked": {0: 0.7699, 1: 0.7506}}
    out = pe_ab.summarize(f1)
    for arm, mean, std in (("eigh", 0.7563, 0.0041),
                           ("subspace", 0.7580, 0.0052),
                           ("subspace-g0", 0.7671, 0.0041)):
        seeds = list(f1[arm].values())
        assert out["arms"][arm]["mean"] == pytest.approx(np.mean(seeds))
        assert out["arms"][arm]["std"] == pytest.approx(np.std(seeds))
        assert round(out["arms"][arm]["mean"], 4) == mean
        assert abs(out["arms"][arm]["std"] - std) <= 1e-4
    d = out["deltas"]["g0 - eigh"]
    np.testing.assert_allclose([d["per_seed"][s] for s in range(3)],
                               [0.0086, 0.0118, 0.0119], atol=1e-12)
    assert d["mean"] == pytest.approx(np.mean([0.0086, 0.0118, 0.0119]))
    assert d["std"] == pytest.approx(np.std([0.0086, 0.0118, 0.0119]))
    r = out["deltas"]["routed - stacked"]
    assert sorted(r["per_seed"]) == [0, 1]
    assert r["per_seed"][1] == pytest.approx(0.7625 - 0.7506)
    assert set(out["deltas"]) == {"g0 - eigh", "g16 - eigh", "g0 - g16",
                                  "routed - stacked"}
    assert out["arms"]["subspace-g0-stacked"]["seeds"] == {0: 0.7699,
                                                           1: 0.7506}


N_MAX, E_MAX = 64, 1024


def test_eigh_pinned_role_transfer_matches_the_reference(tmp_path):
    """The role-v2 transfer (blocks=4, 213 nodes, bucket 64 for speed) of
    a tiny checkpoint trained with the subspace PE, 16 guards and both
    levers. The pin: transfer's embeddings equal the port's own
    generate_embeddings under the eigh, default-switch configuration, bit
    for bit, and not under the checkpoint's. Against the reference: the
    RWR views equal, and the embeddings within 1e-4 (the exact-PE rule of
    test_torch_generate.py) with the PE rows of the weights that read the
    input features (the first GIN layer's MLP and the input's prediction
    head) zeroed on both sides. (With it left in, the exact PE has no
    rule to be held to here: cliques, cycles and grids have repeated
    eigenvalues and eigenvectors whose largest entries tie in magnitude
    with opposite signs, so LAPACK's choice of basis and the sign rule's
    tie differ between the packages; 3 of the 213 nodes have two views
    free of both.)"""
    from gcc_tpu_torch import generate
    from gcc_tpu_torch.compat import flax_to_state_dict
    from gcc_tpu_torch.training.checkpoint import save_checkpoint
    from gcc_tpu_torch.training.pretrain import create_pretrain_state

    subs0 = random_subgraphs(np.random.default_rng(0), 4, 12, 32)
    jcfg, jstate, cfg, model = encoders("eigh", subs0)
    gin = jstate.params["UnsupervisedGIN_0"]
    for layer in (gin["GINMLP_0"]["Linear_0"], gin["Linear_0"]):
        # The first GIN layer's MLP and the input's prediction head.
        assert layer["kernel"].shape[0] == cfg.encoder.node_input_dim
        layer["kernel"] = np.array(layer["kernel"])
        layer["kernel"][:cfg.encoder.positional_embedding_size] = 0.0
    model.load_state_dict(flax_to_state_dict(jstate.params,
                                             jstate.batch_stats))
    trained = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, pe_method="subspace", pe_guards=16,
        adj_dtype="bfloat16", jacobi_v_dtype="bfloat16"))
    state = create_pretrain_state(trained, 10, seed=0, device="cpu")
    state.model.load_state_dict(model.state_dict())
    run_dir = os.path.dirname(save_checkpoint(str(tmp_path / "run"), state,
                                              trained))
    path = str(tmp_path / "role.npz")
    t = pe_ab.transfer(run_dir, path, "v2", blocks=4, device="cpu",
                       n_max=N_MAX, e_max=E_MAX)
    z = np.load(path)
    g, y = role.build_role_graph_v2(blocks=4)
    assert t["eval_nodes"] == g.num_nodes == 213
    np.testing.assert_array_equal(z["labels"], y)
    assert str(z["hash"]) == role.role_hash(g)

    pinned = pe_ab.eval_config(trained)
    assert pinned.encoder == dataclasses.replace(
        EncoderConfig(**{f.name: getattr(cfg.encoder, f.name)
                         for f in dataclasses.fields(EncoderConfig)
                         if f.name not in SWITCH_FIELDS}), pe_method="eigh")
    q, k = generate.node_subgraphs(g, pinned, N_MAX, E_MAX, two_views=True)
    kw = dict(n_max=N_MAX, e_max=E_MAX, subgraphs_k=k, device="cpu")
    np.testing.assert_array_equal(
        z["emb"], generate.generate_embeddings(pinned, model, q, **kw))

    jg, _ = jx_role.build_role_graph_v2(blocks=4)
    jq, jk = jx_generate.node_subgraphs(jg, jcfg, N_MAX, E_MAX,
                                        two_views=True)
    for a, b in zip(q + k, jq + jk):
        np.testing.assert_array_equal(a.src, b.src)
        np.testing.assert_array_equal(a.dst, b.dst)
    want = jx_generate.generate_embeddings(jcfg, jstate, jq, n_max=N_MAX,
                                           e_max=E_MAX, subgraphs_k=jk)
    np.testing.assert_allclose(z["emb"], want, rtol=0, atol=1e-4)


def test_entry_points_need_the_card(tmp_path, monkeypatch):
    """run_arm, the pe_ab loop, e2e_canonical.run and graph_readout_ab's
    encode refuse without CUDA before they make a corpus or train; only
    the scoring runs on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: pe_ab.main(["run", "--root", str(tmp_path / "a")]),
             lambda: pe_ab.run_arm(str(tmp_path / "b"), "eigh", 0),
             lambda: e2e_canonical.main(["run", "--out",
                                         str(tmp_path / "c")]),
             lambda: graph_readout_ab.encode(["x/current"],
                                             str(tmp_path / "d"))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not any(os.scandir(tmp_path))
