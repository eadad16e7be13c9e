"""The port's alternate encoders (GAT, MPNN, GIN with SELayer; GCN and
Set2Set on their own) and its recurrent cells against gcc_tpu's Flax
modules at bridged weights: forward in train and eval mode, the gradient
of a scalar, the bridge both ways, two MoCo steps of GAT and MPNN, and
the sgd / adagrad / clip-by-value optimizer chains against optax."""

import copy

import numpy as np
import pytest

pytest.importorskip("jax")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from gcc_tpu.config import (  # noqa: E402
    ContrastConfig as JxContrast,
    EncoderConfig as JxEncoderConfig,
    OptimConfig as JxOptimConfig,
    TrainConfig as JxTrainConfig,
)
from gcc_tpu.contrastive import MoCoQueue as JxQueue  # noqa: E402
from gcc_tpu.features.featurize import BatchFeatures as JxFeatures  # noqa: E402
from gcc_tpu.models import GraphEncoder as JxEncoder  # noqa: E402
from gcc_tpu.models.gcn import UnsupervisedGCN as JxGCN  # noqa: E402
from gcc_tpu.models.set2set import Set2Set as JxSet2Set  # noqa: E402
from gcc_tpu.training.optim import build_optimizer as jx_optimizer  # noqa: E402
from gcc_tpu.training.pretrain import (  # noqa: E402
    PretrainState as JxState,
    make_step_from_feats,
)
from gcc_tpu.training.schedules import make_lr_schedule  # noqa: E402
from gcc_tpu_torch.compat import (  # noqa: E402
    cell_to_flax,
    cell_to_torch,
    flax_to_state_dict,
    state_dict_to_flax,
)
from gcc_tpu_torch.config import (  # noqa: E402
    ContrastConfig,
    EncoderConfig,
    OptimConfig,
    TrainConfig,
)
from gcc_tpu_torch.contrastive import MoCoQueue  # noqa: E402
from gcc_tpu_torch.features.featurize import BatchFeatures  # noqa: E402
from gcc_tpu_torch.models import GraphEncoder  # noqa: E402
from gcc_tpu_torch.models.gcn import UnsupervisedGCN  # noqa: E402
from gcc_tpu_torch.models.mpnn import GRUCell  # noqa: E402
from gcc_tpu_torch.models.set2set import LSTMCell, Set2Set  # noqa: E402
from gcc_tpu_torch.training.optim import build_optimizer, clip_gradients_  # noqa: E402
from gcc_tpu_torch.training.pretrain import PretrainState, train_step  # noqa: E402
from gcc_tpu_torch.training.schedules import lr_at  # noqa: E402
from test_torch_models import SMALL, random_features  # noqa: E402
from test_torch_training import _named_leaves, _tree_close  # noqa: E402

torch.set_num_threads(1)

ALT = {"gat": dict(model="gat"), "mpnn": dict(model="mpnn"),
       "gin_se": dict(model="gin", use_selayer=True)}


def _flax(kind, f, seed=0):
    enc = JxEncoder(JxEncoderConfig(**SMALL, **ALT[kind]))
    feats = JxFeatures(**{k: jnp.asarray(v) for k, v in f.items()})
    v = enc.init(jax.random.PRNGKey(seed), feats, train=False)
    assert not v.get("batch_stats")          # no BatchNorm in these
    return enc, feats, jax.tree_util.tree_map(np.asarray, v["params"])


def _port(kind, params):
    model = GraphEncoder(EncoderConfig(**SMALL, **ALT[kind]))
    model.load_state_dict(flax_to_state_dict(params, {}))
    return model


def _pt(f):
    return BatchFeatures(**{k: torch.as_tensor(v) for k, v in f.items()})


def _port_grads(model):
    sd = dict(model.state_dict())
    sd.update({n: p.grad for n, p in model.named_parameters()})
    return state_dict_to_flax(sd)[0]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kind", list(ALT))
def test_alt_encoder_forward_matches_flax(kind, train):
    """Embeddings within 1e-5 abs (unit vectors; the same f32 math with
    other orders of sums). SELayer runs the same in both modes."""
    rng = np.random.default_rng(0)
    f = random_features(rng)
    enc, feats, params = _flax(kind, f)
    if train:
        want, _ = enc.apply({"params": params}, feats, train=True,
                            mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(1)})
    else:
        want = enc.apply({"params": params}, feats, train=False)
    model = _port(kind, params).train(train)
    got, pooled = model(_pt(f), return_all_outputs=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    assert (pooled is None) == (kind != "gin_se")


@pytest.mark.parametrize("kind", list(ALT))
def test_alt_encoder_gradient_matches_flax(kind):
    """The gradient of Σ emb · R (R fixed random) with respect to every
    parameter within 1e-5 abs — for MPNN within 5e-5 of each leaf's
    largest entry: its three GRU steps over the random multigraph (row
    sums up to 41) grow gradients to ~10, and both sides then sit ~2e-5
    (relative) from a float64 evaluation of the same function. The
    port holds as many parameter entries as Flax, none unmapped."""
    rng = np.random.default_rng(1)
    f = random_features(rng)
    enc, feats, params = _flax(kind, f)
    r = rng.standard_normal((f["pos"].shape[0], SMALL["output_size"])
                            ).astype(np.float32)

    def scalar(p):
        emb, _ = enc.apply({"params": p}, feats, train=True,
                           mutable=["batch_stats"],
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(emb * r)

    want = jax.grad(scalar)(params)
    model = _port(kind, params).train()
    (model(_pt(f)) * torch.as_tensor(r)).sum().backward()
    got, ref = _named_leaves(_port_grads(model)), _named_leaves(want)
    assert got.keys() == ref.keys()
    for name, g in got.items():
        tol = 5e-5 * np.abs(ref[name]).max() if kind == "mpnn" else 1e-5
        np.testing.assert_allclose(g, ref[name], rtol=0, atol=tol,
                                   err_msg=name)
    assert sum(p.numel() for p in model.parameters()) == sum(
        v.size for v in ref.values())


@pytest.mark.parametrize("kind", list(ALT))
def test_alt_bridge_is_exact_both_ways(kind):
    """Flax → state_dict → Flax, and a port-initialized state_dict →
    Flax → state_dict, both bit for bit."""
    rng = np.random.default_rng(2)
    _, _, params = _flax(kind, random_features(rng))
    p2, s2 = state_dict_to_flax(flax_to_state_dict(params, {}))
    assert s2 == {}
    assert jax.tree_util.tree_structure(p2) == \
        jax.tree_util.tree_structure(params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, params, p2)
    model = GraphEncoder(EncoderConfig(**SMALL, **ALT[kind]))
    model.reset_parameters(torch.Generator().manual_seed(5))
    sd = model.state_dict()
    back = flax_to_state_dict(*state_dict_to_flax(sd))
    assert back.keys() == sd.keys()
    for name in sd:
        assert torch.equal(back[name], sd[name]), name


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_recurrent_cell_matches_flax(kind):
    """One step of the port's cell against Flax's GRUCell / LSTMCell
    from random weights and carry: output and carry within 1e-6, the
    gradient of a scalar in every weight and the input within 1e-5; the
    bridge is exact both ways, and the cell holds as many parameter
    entries as Flax's."""
    rng = np.random.default_rng(3)
    d_in, h = 6, 5
    x = rng.standard_normal((4, d_in)).astype(np.float32)
    hid = rng.standard_normal((4, h)).astype(np.float32)
    c0 = rng.standard_normal((4, h)).astype(np.float32)
    cell = fnn.GRUCell(h) if kind == "gru" else fnn.LSTMCell(h)
    carry = hid if kind == "gru" else (c0, hid)
    p = cell.init(jax.random.PRNGKey(0), carry, x)["params"]
    # Nonzero biases, so that their placement is tested.
    p = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
        if a.ndim == 1 else np.asarray(a), p)
    out_j, vjp = jax.vjp(lambda p, x: cell.apply({"params": p}, carry, x),
                         p, jnp.asarray(x))
    port = GRUCell(d_in, h) if kind == "gru" else LSTMCell(d_in, h)
    port.load_state_dict(cell_to_torch(kind, p))
    xt = torch.as_tensor(x).requires_grad_()
    if kind == "gru":
        new = port(xt, torch.as_tensor(hid))
        got = (new, new)
    else:
        got = port(xt, (torch.as_tensor(c0), torch.as_tensor(hid)))
    flat_got = [t.detach().numpy() for t in jax.tree_util.tree_leaves(got)]
    flat_want = [np.asarray(t) for t in jax.tree_util.tree_leaves(out_j)]
    for a, b in zip(flat_got, flat_want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    weights = [rng.standard_normal(np.shape(t)).astype(np.float32)
               for t in flat_want]
    sum(torch.sum(t * torch.as_tensor(w)) for t, w in zip(
        jax.tree_util.tree_leaves(got), weights)).backward()
    g_p, g_x = vjp(jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(out_j), [jnp.asarray(w)
                                              for w in weights]))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=0,
                               atol=1e-5)
    grads = cell_to_flax(kind, {k: t.grad for k, t in
                                port.named_parameters()})
    _tree_close(grads, g_p, 1e-5)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           cell_to_flax(kind, port.state_dict()),
                           jax.tree_util.tree_map(np.asarray, p))
    assert sum(t.numel() for t in port.parameters()) == sum(
        np.size(a) for a in jax.tree_util.tree_leaves(p))


def test_set2set_matches_flax():
    """Set2Set (3 stacked LSTM cells, 6 iterations, masked softmax) on
    padded node states: output within 1e-5; padded nodes change
    nothing."""
    rng = np.random.default_rng(4)
    f = random_features(rng)
    h = rng.standard_normal((5, 16, 8)).astype(np.float32)
    mask = f["node_mask"]
    flax_mod = JxSet2Set(8, 6, 3)
    p = flax_mod.init(jax.random.PRNGKey(0), h, mask)["params"]
    want = flax_mod.apply({"params": p}, h, mask)
    port = Set2Set(8, 6, 3)
    port.load_state_dict({f"lstms.{i}.{k}": v for i in range(3)
                          for k, v in cell_to_torch(
                              "lstm", p[f"lstm_{i}"]).items()})
    got = port(torch.as_tensor(h), torch.as_tensor(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    noisy = h + 100.0 * (1 - mask)[..., None]
    np.testing.assert_allclose(
        port(torch.as_tensor(noisy), torch.as_tensor(mask)).detach().numpy(),
        got.detach().numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("readout,layernorm", [("avg", False),
                                               ("root", False),
                                               ("avg", True)])
def test_gcn_matches_flax(readout, layernorm):
    """GCN (dead code in the reference's encoder dispatch): forward and
    the gradient of a scalar within 1e-5."""
    rng = np.random.default_rng(5)
    f = random_features(rng)
    h = rng.standard_normal((5, 16, 8)).astype(np.float32) \
        * f["node_mask"][..., None]
    args = (h, f["adj"], f["node_mask"], f["seed_flag"])
    flax_mod = JxGCN(16, 2, readout, layernorm)
    p = jax.tree_util.tree_map(np.asarray, flax_mod.init(
        jax.random.PRNGKey(0), *args)["params"])
    if layernorm:
        p["LayerNorm_0"] = {"scale": rng.uniform(0.5, 1.5, 16).astype(
            np.float32), "bias": rng.uniform(-0.5, 0.5, 16).astype(
            np.float32)}
    r = rng.standard_normal((5, 16)).astype(np.float32)
    want, g_want = jax.value_and_grad(
        lambda p: jnp.sum(flax_mod.apply({"params": p}, *args) * r))(p)
    port = UnsupervisedGCN(8, 16, 2, readout, layernorm)
    sd = {}
    for i in range(2):
        sd[f"layers.{i}.weight"] = torch.as_tensor(p[f"Linear_{i}"]["kernel"].T)
        sd[f"layers.{i}.bias"] = torch.as_tensor(p[f"Linear_{i}"]["bias"])
    if layernorm:
        sd["norm.weight"] = torch.as_tensor(p["LayerNorm_0"]["scale"])
        sd["norm.bias"] = torch.as_tensor(p["LayerNorm_0"]["bias"])
    port.load_state_dict(sd)
    got = (port(*(torch.as_tensor(a) for a in args))
           * torch.as_tensor(r)).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for i in range(2):
        np.testing.assert_allclose(port.layers[i].weight.grad.numpy().T,
                                   np.asarray(g_want[f"Linear_{i}"]["kernel"]),
                                   rtol=0, atol=1e-5)
    if layernorm:
        np.testing.assert_allclose(port.norm.weight.grad.numpy(),
                                   np.asarray(g_want["LayerNorm_0"]["scale"]),
                                   rtol=0, atol=1e-5)


B, K, TOTAL_STEPS = 4, 24, 10


@pytest.mark.parametrize("model", ["gat", "mpnn"])
def test_two_moco_steps_match_jax(model, monkeypatch):
    """Two MoCo steps with the alternate encoder against the reference's
    step from the same parameters, queue and features: loss, prob and
    grad_norm within 1e-5 relative; params, EMA params and the queue
    within 1e-5 abs (no BatchNorm here, so every parameter is held)."""
    monkeypatch.setenv("GCC_TPU_MERGED_QK", "0")
    rng = np.random.default_rng(6)
    steps = [(random_features(rng, b=B), random_features(rng, b=B))
             for _ in range(2)]
    queue0 = rng.uniform(-0.4, 0.4, (K, 16)).astype(np.float32)
    # Temperature 1: the alternate encoders map these random graphs to
    # near-equal embeddings, so at 0.07 the loss is ~1e-3 and its
    # relative error is that of a logit difference over 1e-3.
    contrast = dict(moco=True, nce_k=K, nce_t=1.0)
    jcfg = JxTrainConfig(batch_size=B, encoder=JxEncoderConfig(
        **SMALL, model=model), contrast=JxContrast(**contrast))
    cfg = TrainConfig(batch_size=B, encoder=EncoderConfig(**SMALL,
                                                          model=model),
                      contrast=ContrastConfig(**contrast))
    enc, _, params = _flax(model, steps[0][0])
    tx = jx_optimizer(jcfg.optim, make_lr_schedule(
        jcfg.optim.learning_rate, TOTAL_STEPS, jcfg.optim.warmup))
    jstate = JxState(
        params=params, batch_stats={}, ema_params=params, ema_batch_stats={},
        queue=JxQueue(memory=jnp.asarray(queue0),
                      index=jnp.zeros((), jnp.int32)),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
        dropout_rng=jax.random.PRNGKey(1),
        nce_z=jnp.full((), -1.0, jnp.float32))
    jstep = jax.jit(make_step_from_feats(jcfg, enc, tx))
    port = _port(model, params)
    state = PretrainState(
        cfg=cfg, model=port, ema_model=copy.deepcopy(port).requires_grad_(
            False),
        optimizer=build_optimizer(port.parameters(), cfg.optim),
        queue=MoCoQueue(memory=torch.as_tensor(queue0.copy()),
                        index=torch.zeros((), dtype=torch.int64)),
        dropout_gen=torch.Generator().manual_seed(0),
        total_steps=TOTAL_STEPS)
    to_jx = lambda f: JxFeatures(**{k: jnp.asarray(v) for k, v in f.items()})  # noqa: E731
    for fq, fk in steps:
        jstate, jm = jstep(jstate, to_jx(fq), to_jx(fk))
        pm = train_step(state, _pt(fq), _pt(fk))
        for name in ("loss", "prob", "grad_norm"):
            np.testing.assert_allclose(float(pm[name]), float(jm[name]),
                                       rtol=1e-5, err_msg=name)
    moved = _named_leaves(state_dict_to_flax(port.state_dict())[0])
    assert any(not np.array_equal(v, _named_leaves(params)[k])
               for k, v in moved.items())
    _tree_close(state_dict_to_flax(port.state_dict())[0], jstate.params, 1e-5)
    _tree_close(state_dict_to_flax(state.ema_model.state_dict())[0],
                jstate.ema_params, 1e-5)
    np.testing.assert_allclose(state.queue.memory.numpy(),
                               np.asarray(jstate.queue.memory), rtol=0,
                               atol=1e-5)
    assert int(state.queue.index) == int(jstate.queue.index) == 2 * B


@pytest.mark.parametrize("optimizer,clip_mode", [
    ("sgd", "norm"), ("adagrad", "norm"), ("adam", "value"),
    ("sgd", "value"), ("adagrad", "value")])
def test_optimizer_chain_matches_optax(optimizer, clip_mode):
    """Three updates of clip → L2 decay → optimizer → warmup-linear rate
    against the reference's optax chain on the same parameters and
    gradients (large enough that both clips act): params within 1e-6
    abs + 1e-5 relative after every update."""
    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: 3.0 * rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    kw = dict(optimizer=optimizer, learning_rate=0.1, weight_decay=0.01)
    total = 4
    tx = jx_optimizer(JxOptimConfig(**kw), make_lr_schedule(0.1, total, 0.1),
                      clip_mode=clip_mode)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    cfg = OptimConfig(**kw)
    tensors = {k: torch.nn.Parameter(torch.as_tensor(v.copy()))
               for k, v in params.items()}
    opt = build_optimizer(tensors.values(), cfg)
    for t, g in enumerate(grads):
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tensors.items():
            p.grad = torch.as_tensor(g[k].copy())
        clip_gradients_(tensors.values(), cfg, clip_mode)
        for group in opt.param_groups:
            group["lr"] = lr_at(t, 0.1, total, 0.1)
        opt.step()
        for k, p in tensors.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} step {t}")


@pytest.mark.parametrize("kind", list(ALT))
def test_alt_training_state_crosses_over(kind, tmp_path, monkeypatch):
    """A gcc_tpu MoCo state of the alternate encoder after two steps,
    through gcc_tpu's Orbax checkpoint, into the port and back: every
    leaf bit for bit (Adam's flat moments in ravel order included). A third
    step then agrees at the tolerances of test_two_moco_steps_match_jax."""
    from gcc_tpu.training import checkpoint as jx_checkpoint
    from gcc_tpu_torch.compat import (
        pretrain_state_from_numpy,
        pretrain_state_to_numpy,
    )
    from test_torch_state_bridge import _flat

    monkeypatch.setenv("GCC_TPU_MERGED_QK", "0")
    rng = np.random.default_rng(8)
    steps = [(random_features(rng, b=B), random_features(rng, b=B))
             for _ in range(3)]
    contrast = dict(moco=True, nce_k=K, nce_t=1.0)
    jcfg = JxTrainConfig(batch_size=B, encoder=JxEncoderConfig(
        **SMALL, **ALT[kind]), contrast=JxContrast(**contrast))
    cfg = TrainConfig(batch_size=B, encoder=EncoderConfig(**SMALL,
                                                          **ALT[kind]),
                      contrast=ContrastConfig(**contrast))
    enc, _, params = _flax(kind, steps[0][0])
    tx = jx_optimizer(jcfg.optim, make_lr_schedule(
        jcfg.optim.learning_rate, TOTAL_STEPS, jcfg.optim.warmup))
    jstate = JxState(
        params=params, batch_stats={}, ema_params=params, ema_batch_stats={},
        queue=JxQueue(memory=jnp.asarray(rng.uniform(
            -0.4, 0.4, (K, 16)).astype(np.float32)),
            index=jnp.zeros((), jnp.int32)),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
        dropout_rng=jax.random.PRNGKey(1),
        nce_z=jnp.full((), -1.0, jnp.float32))
    jstep = jax.jit(make_step_from_feats(jcfg, enc, tx))
    to_jx = lambda f: JxFeatures(**{k: jnp.asarray(v) for k, v in f.items()})  # noqa: E731
    for fq, fk in steps[:2]:
        jstate, _ = jstep(jstate, to_jx(fq), to_jx(fk))
    tree = jx_checkpoint.load_checkpoint(
        jx_checkpoint.save_checkpoint(str(tmp_path), jstate, jcfg))
    state = pretrain_state_from_numpy(tree, cfg, TOTAL_STEPS, device="cpu")
    back = _flat(pretrain_state_to_numpy(state))
    want = _flat({k: v for k, v in tree.items() if k != "dropout_rng"})
    assert back.keys() == want.keys()
    for name, x in want.items():
        if x is None:
            assert back[name] is None, name
        else:
            np.testing.assert_array_equal(back[name], x, err_msg=name)
    assert np.abs(want["/opt_state/2/mu"]).max() > 0
    jstate, jm = jstep(jstate, to_jx(steps[2][0]), to_jx(steps[2][1]))
    pm = train_step(state, _pt(steps[2][0]), _pt(steps[2][1]))
    for name in ("loss", "prob", "grad_norm"):
        np.testing.assert_allclose(float(pm[name]), float(jm[name]),
                                   rtol=1e-5, err_msg=name)
    got = pretrain_state_to_numpy(state)
    _tree_close(got["params"], jstate.params, 1e-5)
    _tree_close(got["ema_params"], jstate.ema_params, 1e-5)
