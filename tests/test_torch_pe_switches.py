"""The reference's three PE switches in the port.

gcc_tpu reads ``GCC_TPU_PE_GUARDS``, ``GCC_TPU_PE_RR`` and
``GCC_TPU_PE_RR_SWEEPS`` from the environment while it traces
(``gcc_tpu/features/positional.py:373-429``). The port reads no variable:
the guards are ``EncoderConfig.pe_guards``, which every entry point hands
to the PE and the accuracy A/Bs turn; the finisher and its sweeps are
``laplacian_positional_embedding``'s keyword arguments ``rr`` and
``rr_sweeps``, which only tests set, as only the reference's tests and a
diagnostic script set its two variables. Each test here sets the
variables with monkeypatch. The reference's PE is called unjitted, so it
reads them at every call, and its jitted parts take none of them (the
Pallas kernel's static arguments are its schedule; the guards change its
shapes): no program traced under other settings is reused, and the
module clears JAX's caches only before its first test and after its
last (clearing them for each case measured the same values in four
times the time). CPU tensors run the kernels' plain versions; JAX runs
its Pallas PE kernel in interpret mode.

Tolerances, each with its reason:

* the PE: the column masks equal, and |cos| >= 0.999 on every column
  whose eigenvalue is 0.02 from its neighbours
  (``test_torch_generate.py``'s rule), on ring-and-chord graphs whose
  leading spectrum is so separated. One cell is the exception: at 16
  guards the default 3-sweep Jacobi finish of the 24-wide block is not
  converged on graphs of 20-32 nodes, and what it returns then depends
  on the last bits of its input, in either package
  (``test_torch_generate.py``); there the reference's own contract for
  its Jacobi finish holds (``tests/test_ops_features.py
  test_pe_jacobi_rr_matches_eigh_rr``): median per-column |cos| above
  0.999, more than 80% of the columns above 0.99 (measured: median
  0.99999, 87.5%, the least 0.932);
* a MoCo dispatch at 16 guards (and 5 sweeps, where the finish
  converges): the port's ``train_dispatch`` (its own featurization at
  the configuration's guards) against the reference's features under
  ``GCC_TPU_PE_GUARDS=16``, ``GCC_TPU_PE_RR_SWEEPS=5`` and its step from
  bridged weights: the PE by the rule above; loss, prob and grad_norm
  within 1e-4 relative and the gradients within 1e-4 abs — the f32
  step's 1e-5 (``test_torch_training.py``) widened by the two PEs' own
  difference, which the step carries.
"""

import copy
import dataclasses
import json

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
from gcc_tpu.features.featurize import (  # noqa: E402
    featurize_compact as jx_featurize_compact,
)
from gcc_tpu.features.positional import (  # noqa: E402
    laplacian_positional_embedding as jx_pe,
)
from gcc_tpu.graph.batch import batch_subgraphs as jx_batch  # noqa: E402
from gcc_tpu.models import GraphEncoder as JxEncoder  # noqa: E402
from gcc_tpu.training import pretrain as jx_pretrain  # noqa: E402
from gcc_tpu.training.optim import build_optimizer as jx_optimizer  # noqa: E402
from gcc_tpu.training.schedules import make_lr_schedule  # noqa: E402
from gcc_tpu_torch.compat import flax_to_state_dict  # noqa: E402
from gcc_tpu_torch.config import (  # noqa: E402
    ContrastConfig,
    EncoderConfig,
    TrainConfig,
    with_levers,
    without_switches,
)
from gcc_tpu_torch.contrastive import MoCoQueue  # noqa: E402
from gcc_tpu_torch.features import featurize  # noqa: E402
from gcc_tpu_torch.features.featurize import featurize_batch  # noqa: E402
from gcc_tpu_torch.features.positional import (  # noqa: E402
    laplacian_positional_embedding,
)
from gcc_tpu_torch.graph.batch import (  # noqa: E402
    CompactWireBatch,
    batch_subgraphs,
)
from gcc_tpu_torch.models import GraphEncoder  # noqa: E402
from gcc_tpu_torch.training.optim import build_optimizer  # noqa: E402
from gcc_tpu_torch.training.pretrain import (  # noqa: E402
    PretrainState,
    featurize_stacked,
    train_dispatch,
)
from test_torch_generate import (  # noqa: E402
    E_MAX,
    N_MAX,
    POS,
    _jx,
    _pe_columns_agree,
    random_subgraphs,
)
from test_torch_training import (  # noqa: E402
    _grad_recorder,
    _named_leaves,
    _port_grads,
)

torch.set_num_threads(1)

SWITCHES = ("GCC_TPU_PE_GUARDS", "GCC_TPU_PE_RR", "GCC_TPU_PE_RR_SWEEPS")


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_caches():
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def reference_env(monkeypatch):
    """Sets the reference's switches (None: unset) with its Pallas PE in
    interpret mode."""
    monkeypatch.setenv("GCC_TPU_PE_PALLAS", "interpret")
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)

    def set_switches(guards=None, rr=None, sweeps=None):
        for name, value in zip(SWITCHES, (guards, rr, sweeps)):
            if value is not None:
                monkeypatch.setenv(name, str(value))

    return set_switches


# ---- the PE at every setting of the three switches -------------------------

# The finishes: (rr, rr_sweeps); the eigh finish takes no sweeps.
FINISHES = {"jacobi-3": ("jacobi", 3), "jacobi-5": ("jacobi", 5),
            "eigh": ("eigh", None)}


@pytest.mark.parametrize("finish", list(FINISHES))
@pytest.mark.parametrize("profile", ["train", "eval"])
@pytest.mark.parametrize("guards", [0, 16])
def test_pe_matches_reference_under_its_switches(guards, profile, finish,
                                                 reference_env):
    """The port's subspace PE at guards (featurize_batch's ``guards``)
    and a finish (laplacian_positional_embedding's ``rr`` and
    ``rr_sweeps``; the default one through featurize_batch alone) against
    the reference's under GCC_TPU_PE_GUARDS / GCC_TPU_PE_RR /
    GCC_TPU_PE_RR_SWEEPS, on 8 graphs of 20-32 nodes (module docstring).
    The guards override the profile's own count on both sides, so each
    (guards, profile) pair computes the same block."""
    rr, sweeps = FINISHES[finish]
    rng = np.random.default_rng(100 + guards + (sweeps or 3))
    subs = random_subgraphs(rng, 8, 20, N_MAX)
    reference_env(guards, rr, sweeps)
    want = np.asarray(jx_pe(jax.device_put(jx_batch(_jx(subs), N_MAX, E_MAX)),
                            POS, method="subspace", profile=profile))
    batch = batch_subgraphs(subs, N_MAX, E_MAX)
    feats = featurize_batch(batch, POS, pe_method="subspace", profile=profile,
                            device="cpu", guards=guards)
    got = feats.pos
    if finish != "jacobi-3":
        got = laplacian_positional_embedding(
            feats.node_mask, torch.as_tensor(batch.n_nodes), POS,
            adj=feats.adj, method="subspace", profile=profile, guards=guards,
            rr=rr, rr_sweeps=sweeps or 3)
    got = got.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(np.abs(got).sum(axis=1) > 0,
                                  np.abs(want).sum(axis=1) > 0)
    if guards and finish == "jacobi-3":
        cos = _separated_column_cosines(got, want, subs)
        assert len(cos) >= 40 and np.median(cos) > 0.999 \
            and (cos > 0.99).mean() > 0.8, (np.median(cos), np.sort(cos)[:5])
    else:
        assert _pe_columns_agree(got, want, subs, POS) >= 40


def _separated_column_cosines(pos, want, subs, min_gap=0.02):
    """|cos| of every column whose eigenvalue is min_gap from its
    neighbours (the columns _pe_columns_agree holds)."""
    out = []
    for g, s in enumerate(subs):
        n_b = s.num_nodes
        a = np.zeros((n_b, n_b))
        np.add.at(a, (s.dst, s.src), 1.0)
        d = np.maximum(a.sum(axis=1), 1.0)
        lam = np.linalg.eigvalsh(
            a / np.sqrt(d)[:, None] / np.sqrt(d)[None, :])[::-1]
        for j in range(min(max(n_b - 2, 0), POS)):
            if min(abs(lam[j] - lam[i]) for i in (j - 1, j + 1)
                   if 0 <= i < len(lam)) < min_gap:
                continue
            x, y = pos[g, :n_b, j], want[g, :n_b, j]
            out.append(abs(x @ y) / (np.linalg.norm(x) * np.linalg.norm(y)))
    return np.array(out)


# ---- a MoCo dispatch at 16 guards ------------------------------------------

def _compact_wire(subs, e_tot, id_bits=8):
    """One stacked step (K = 1) of a compact wire holding ``subs``, its
    edge buffer of ``e_tot`` slots ending in stale bytes."""
    packed = np.full(e_tot, np.iinfo(np.uint16).max, np.uint16)
    edges = np.concatenate([
        s.src.astype(np.int64) | (s.dst.astype(np.int64) << id_bits)
        for s in subs])
    packed[:edges.size] = edges
    meta = np.array([[s.num_nodes for s in subs],
                     [len(s.src) for s in subs],
                     [s.seed for s in subs]], np.int32)
    return CompactWireBatch(edges=packed[None], meta=meta[None], e_max=E_MAX,
                            id_bits=id_bits, n_max=N_MAX)


def test_moco_dispatch_at_16_guards_matches_reference(reference_env,
                                                      monkeypatch):
    """train_dispatch with EncoderConfig.pe_guards = 16 (its own
    featurize_stacked at those guards) against the reference's
    featurize_compact under GCC_TPU_PE_GUARDS=16 and its MoCo step, from
    bridged weights, both finishes at 5 sweeps (GCC_TPU_PE_RR_SWEEPS=5;
    the port's through the PE's ``rr_sweeps``), where they converge
    (module docstring). The port's PE is also held apart from its train
    profile's 0 guards, so that the switch is seen to reach the
    dispatch."""
    monkeypatch.setenv("GCC_TPU_MERGED_QK", "0")
    pe = featurize.laplacian_positional_embedding
    monkeypatch.setattr(featurize, "laplacian_positional_embedding",
                        lambda *a, **kw: pe(*a, **{**kw, "rr_sweeps": 5}))
    rng = np.random.default_rng(5)
    b, nce_k = 4, 24
    subs = random_subgraphs(rng, 2 * b, 20, N_MAX)
    e_tot = max(sum(len(s.src) for s in half)
                for half in (subs[:b], subs[b:])) + 16
    wq, wk = _compact_wire(subs[:b], e_tot), _compact_wire(subs[b:], e_tot)
    enc_kw = dict(num_layers=3, hidden_size=16, output_size=16,
                  positional_embedding_size=POS, final_dropout=0.0)
    cfg = TrainConfig(batch_size=b, encoder=EncoderConfig(
        **enc_kw, pe_guards=16),
        contrast=ContrastConfig(moco=True, nce_k=nce_k))

    port = featurize_stacked(wq, wk, POS, device="cpu",
                             guards=cfg.encoder.pe_guards)
    g0 = featurize_stacked(wq, wk, POS, device="cpu")
    reference_env(guards=16, sweeps=5)
    edges = np.concatenate([wq.edges, wk.edges])
    meta = np.concatenate([wq.meta, wk.meta])
    want = jx_featurize_compact(jnp.asarray(edges), jnp.asarray(meta), N_MAX,
                                8, POS, pe_method="subspace", e_cap=E_MAX)
    pos = port.pos[0].numpy()
    assert _pe_columns_agree(pos, np.asarray(want.pos), subs, POS) >= 40
    assert np.abs(pos - g0.pos[0].numpy()).max() > 1e-3

    jcfg = JxTrainConfig(batch_size=b, encoder=JxEncoderConfig(**enc_kw),
                         contrast=JxContrast(moco=True, nce_k=nce_k))
    from gcc_tpu.features.featurize import BatchFeatures as JxFeatures

    fq = JxFeatures(*(x[:b] for x in want))
    fk = JxFeatures(*(x[b:] for x in want))
    enc = JxEncoder(jcfg.encoder)
    v = enc.init(jax.random.PRNGKey(0), fq, train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    queue0 = rng.uniform(-0.4, 0.4, (nce_k, 16)).astype(np.float32)
    tx = optax.chain(_grad_recorder(), jx_optimizer(
        jcfg.optim, make_lr_schedule(jcfg.optim.learning_rate, 10,
                                     jcfg.optim.warmup)))
    jstate = jx_pretrain.PretrainState(
        params=params, batch_stats=stats, ema_params=params,
        ema_batch_stats=stats,
        queue=JxQueue(memory=jnp.asarray(queue0),
                      index=jnp.zeros((), jnp.int32)),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
        dropout_rng=jax.random.PRNGKey(1),
        nce_z=jnp.full((), -1.0, jnp.float32))
    jstate, jm = jax.jit(jx_pretrain.make_step_from_feats(jcfg, enc, tx))(
        jstate, fq, fk)

    model = GraphEncoder(cfg.encoder)
    model.load_state_dict(flax_to_state_dict(params, stats))
    state = PretrainState(
        cfg=cfg, model=model,
        ema_model=copy.deepcopy(model).requires_grad_(False),
        optimizer=build_optimizer(model.parameters(), cfg.optim),
        queue=MoCoQueue(memory=torch.as_tensor(queue0.copy()),
                        index=torch.zeros((), dtype=torch.int64)),
        dropout_gen=torch.Generator().manual_seed(0), total_steps=10)
    pm = train_dispatch(state, wq, wk)
    for name in ("loss", "prob", "grad_norm"):
        np.testing.assert_allclose(float(pm[name][0]), float(jm[name]),
                                   rtol=1e-4, err_msg=name)
    clip = min(1.0, cfg.optim.clip_norm / float(jm["grad_norm"]))
    jg = _named_leaves(jax.tree_util.tree_map(
        lambda x: np.asarray(x) * clip, jstate.opt_state[0]))
    pg = _named_leaves(_port_grads(model))
    assert pg.keys() == jg.keys()
    for name in jg:
        np.testing.assert_allclose(pg[name], jg[name], rtol=0, atol=1e-4,
                                   err_msg=name)


# ---- every entry point hands the switches to the PE -------------------------

class _Seen(Exception):
    """Raised by a recorder once it has what it records."""


def _switches_of(monkeypatch, module, name):
    """Replace ``module.name`` by a recorder of the guards it is handed
    (``laplacian_positional_embedding``'s keyword) that then stops."""
    seen = {}

    def recorder(*args, **kw):
        seen["guards"] = kw.get("guards")
        raise _Seen

    monkeypatch.setattr(module, name, recorder)
    return seen


@pytest.mark.parametrize("path", ["generate", "finetune", "e2e_split",
                                  "giant"])
def test_every_entry_point_hands_the_switches_to_the_pe(path, monkeypatch):
    """The configuration's guards reach the PE from generate's encode
    calls, a finetune step's featurize, the E2E size split through
    train_dispatch, and the giant path. A configuration without them
    leaves the giant path the eval profile's 16 guards."""
    import types

    from gcc_tpu_torch import generate
    from gcc_tpu_torch.features import featurize
    from gcc_tpu_torch.parallel import giant_features as gf
    from gcc_tpu_torch.training import finetune
    from gcc_tpu_torch.training import pretrain as pt

    enc = EncoderConfig(num_layers=2, hidden_size=16, output_size=16,
                        positional_embedding_size=POS,
                        degree_embedding_size=4, pe_guards=2)
    cfg = TrainConfig(batch_size=4, encoder=enc)
    subs = random_subgraphs(np.random.default_rng(1), 4, 12, N_MAX)
    want = dict(guards=2)
    if path == "giant":
        from gcc_tpu_torch.graph.csr import CSRGraph

        guards = []
        monkeypatch.setattr(gf, "giant_pe_basis",
                            lambda *a, **kw: guards.append(a[3]) or _stop())
        g = CSRGraph.from_edges(subs[0].src, subs[0].dst,
                                num_nodes=subs[0].num_nodes)
        for e, k in ((enc, 2), (EncoderConfig(**{
                **dataclasses.asdict(enc), "pe_guards": None}), 16)):
            with pytest.raises(_Seen):
                gf.giant_graph_embedding(GraphEncoder(e), g, device="cpu")
            assert guards.pop() == k
        return
    if path == "e2e_split":
        seen = _switches_of(monkeypatch, pt, "laplacian_positional_embedding")
        cfg = dataclasses.replace(cfg, contrast=ContrastConfig(
            moco=False, e2e_split="16:2"))
        e_tot = max(sum(len(s.src) for s in subs[:2]),
                    sum(len(s.src) for s in subs[2:])) + 16
        wq = _compact_wire(subs[:2] * 2, 2 * e_tot)
        wk = _compact_wire(subs[2:] * 2, 2 * e_tot)
        state = types.SimpleNamespace(cfg=cfg, device=torch.device("cpu"))
        with pytest.raises(_Seen):
            pt.train_dispatch(state, wq, wk)
    else:
        seen = _switches_of(monkeypatch, featurize,
                            "laplacian_positional_embedding")
        batch = batch_subgraphs(subs, N_MAX, E_MAX)
        with pytest.raises(_Seen):
            if path == "generate":
                generate.generate_embeddings(cfg, GraphEncoder(enc), subs,
                                             n_max=N_MAX, e_max=E_MAX,
                                             device="cpu")
            else:
                finetune._featurize(types.SimpleNamespace(
                    cfg=cfg, device=torch.device("cpu")), batch)
    assert seen == want


def _stop():
    raise _Seen


# ---- configuration ----------------------------------------------------------

def test_a_config_json_from_before_the_switches_loads_with_the_defaults():
    """A sidecar written before ``pe_guards`` (the sidecars of the earlier
    releases, levers included) loads with None; the field survives the
    sidecar; bad values are refused; with_levers replaces it only where
    given, and without_switches puts every lever and the guards back."""
    old = json.loads(TrainConfig().to_json())
    del old["encoder"]["pe_guards"]
    loaded = TrainConfig.from_json(json.dumps(old))
    assert loaded == TrainConfig()
    assert loaded.encoder.pe_guards is None
    cfg = TrainConfig(encoder=EncoderConfig(pe_guards=16,
                                            adj_dtype="bfloat16"))
    assert TrainConfig.from_json(cfg.to_json()) == cfg
    for bad in (-1, 1.5, "16"):
        with pytest.raises(ValueError, match="pe_guards"):
            EncoderConfig(pe_guards=bad)
    over = with_levers(cfg, pe_guards=0)
    assert over.encoder == dataclasses.replace(cfg.encoder, pe_guards=0)
    assert with_levers(cfg, None, None, None) is cfg
    assert without_switches(cfg) == TrainConfig()


def test_cli_flags_set_and_override_the_switches(monkeypatch):
    """pretrain's --pe-guards sets a new run's guards (None when omitted,
    0 kept as 0); generate's and finetune's override a checkpoint's only
    where given; a bad value is refused on every command."""
    from gcc_tpu_torch import cli

    seen = {}
    for name in ("cmd_pretrain", "cmd_generate", "cmd_finetune"):
        monkeypatch.setattr(cli, name,
                            lambda args, name=name: seen.__setitem__(name,
                                                                     args))
    cli.main(["pretrain", "--pe-guards", "16"])
    assert cli._cfg_from_args(seen["cmd_pretrain"]).encoder.pe_guards == 16
    cli.main(["pretrain", "--pe-guards", "0"])
    assert cli._cfg_from_args(seen["cmd_pretrain"]).encoder.pe_guards == 0
    cli.main(["pretrain"])
    assert cli._cfg_from_args(seen["cmd_pretrain"]).encoder == EncoderConfig()
    ckpt = TrainConfig(encoder=EncoderConfig(pe_guards=16))
    cli.main(["generate", "--ckpt", "x", "--dataset", "y", "--pe-guards",
              "0"])
    assert cli._with_flags(ckpt, seen["cmd_generate"]).encoder.pe_guards == 0
    cli.main(["finetune"])
    assert cli._with_flags(ckpt, seen["cmd_finetune"]) is ckpt
    cli.main(["pretrain", "--pe-guards", "-1"])
    with pytest.raises(ValueError, match="pe_guards"):
        cli._cfg_from_args(seen["cmd_pretrain"])
    for cmd in (["generate", "--ckpt", "x", "--dataset", "y"],
                ["finetune"]):
        cli.main(cmd + ["--pe-guards", "-1"])
        with pytest.raises(ValueError, match="pe_guards"):
            cli._with_flags(ckpt, seen[f"cmd_{cmd[0]}"])


def test_the_port_reads_no_switch():
    """No module of the port reads the three variables."""
    import os
    import re

    import gcc_tpu_torch

    root = os.path.dirname(gcc_tpu_torch.__file__)
    reads = re.compile(r"(os\.environ|getenv)[^\n]*GCC_TPU_PE_(GUARDS|RR)")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    assert not reads.search(f.read()), name
