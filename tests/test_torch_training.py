"""Three MoCo steps of the port vs gcc_tpu's make_step_from_feats from the
same parameters, queue and features (dropout off)."""

import copy

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
from gcc_tpu.features.featurize import BatchFeatures as JxFeatures  # noqa: E402
from gcc_tpu.models import GraphEncoder as JxEncoder  # noqa: E402
from gcc_tpu.training.optim import build_optimizer as jx_optimizer  # noqa: E402
from gcc_tpu.training.pretrain import (  # noqa: E402
    PretrainState as JxState,
    make_step_from_feats,
)
from gcc_tpu.training.schedules import make_lr_schedule  # noqa: E402
from gcc_tpu_torch.compat import flax_to_state_dict, state_dict_to_flax  # noqa: E402
from gcc_tpu_torch.config import (  # noqa: E402
    ContrastConfig,
    EncoderConfig,
    TrainConfig,
)
from gcc_tpu_torch.contrastive import MoCoQueue  # noqa: E402
from gcc_tpu_torch.features.featurize import BatchFeatures  # noqa: E402
from gcc_tpu_torch.models import GraphEncoder  # noqa: E402
from gcc_tpu_torch.training.optim import build_optimizer  # noqa: E402
from gcc_tpu_torch.training.pretrain import PretrainState, train_step  # noqa: E402
from gcc_tpu_torch.training.schedules import lr_at  # noqa: E402
from test_torch_models import SMALL, random_features  # noqa: E402

torch.set_num_threads(1)

TOTAL_STEPS = 10  # lr: 0 at step 0 (optax count 0), then > 0
B, K = 4, 24


def _named_leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tree_close(a, b, atol, rtol=0.0, skip=()):
    a, b = _named_leaves(a), _named_leaves(b)
    assert a.keys() == b.keys()
    for name, x in a.items():
        if not any(s in name for s in skip):
            np.testing.assert_allclose(x, b[name], rtol=rtol, atol=atol,
                                       err_msg=name)


def _grad_recorder():
    """An optax stage that passes the gradient on unchanged and keeps it
    as its state, so the jitted step exposes the raw gradient it used."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


def _port_grads(model):
    """The port's (clipped) gradients as a Flax-layout params tree."""
    sd = dict(model.state_dict())
    sd.update({n: p.grad for n, p in model.named_parameters()})
    return state_dict_to_flax(sd)[0]


def test_three_moco_steps_match_jax(monkeypatch):
    """loss, prob and grad_norm within 1e-5 relative and the clipped
    gradients within 1e-5 abs at every step; after three steps params, EMA params and the queue within 1e-5 abs
    (the same f32 math in other summation orders), BN running buffers
    within 1e-5 abs + 1e-5 relative (running variances reach ~20, where
    an f32 ulp is 2e-6)."""
    monkeypatch.setenv("GCC_TPU_MERGED_QK", "0")  # same math, one apply each
    rng = np.random.default_rng(0)
    steps = [(random_features(rng, b=B), random_features(rng, b=B))
             for _ in range(3)]
    queue0 = rng.uniform(-0.4, 0.4, (K, SMALL["output_size"])).astype(
        np.float32)

    jcfg = JxTrainConfig(batch_size=B, encoder=JxEncoderConfig(**SMALL),
                         contrast=JxContrast(moco=True, nce_k=K))
    enc = JxEncoder(jcfg.encoder)
    to_jx = lambda f: JxFeatures(**{k: jnp.asarray(v) for k, v in f.items()})  # noqa: E731
    v = enc.init(jax.random.PRNGKey(0), to_jx(steps[0][0]), train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    tx = optax.chain(_grad_recorder(), jx_optimizer(
        jcfg.optim, make_lr_schedule(jcfg.optim.learning_rate, TOTAL_STEPS,
                                     jcfg.optim.warmup)))
    jstate = JxState(
        params=params, batch_stats=stats, ema_params=params,
        ema_batch_stats=stats,
        queue=JxQueue(memory=jnp.asarray(queue0),
                      index=jnp.zeros((), jnp.int32)),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
        dropout_rng=jax.random.PRNGKey(1),
        nce_z=jnp.full((), -1.0, jnp.float32))
    jstep = jax.jit(make_step_from_feats(jcfg, enc, tx))

    cfg = TrainConfig(batch_size=B, encoder=EncoderConfig(**SMALL),
                      contrast=ContrastConfig(moco=True, nce_k=K))
    model = GraphEncoder(cfg.encoder)
    model.load_state_dict(flax_to_state_dict(params, stats))
    ema = copy.deepcopy(model).requires_grad_(False)
    state = PretrainState(
        cfg=cfg, model=model, ema_model=ema,
        optimizer=build_optimizer(model.parameters(), cfg.optim),
        queue=MoCoQueue(memory=torch.as_tensor(queue0.copy()),
                        index=torch.zeros((), dtype=torch.int64)),
        dropout_gen=torch.Generator().manual_seed(0),
        total_steps=TOTAL_STEPS)

    to_pt = lambda f: BatchFeatures(**{k: torch.as_tensor(v)  # noqa: E731
                                       for k, v in f.items()})
    # The biases of the GIN MLP's two Linears feed a BatchNorm, which
    # removes any per-feature constant: their true gradient is 0, and
    # both chains compute rounding noise instead (held below 1e-7 here,
    # where the other gradients are ~1e-2). Adam normalizes that noise
    # into a step of up to lr in a noise-chosen direction, so on these
    # leaves the two sides differ by up to the summed lr and move no
    # output; they are held to that bound, every other parameter to 1e-5.
    mlp_biases = tuple(f"['GINMLP_{i}']{b}" for i in range(2)
                       for b in ("['Linear_0']['bias']",
                                 "['Linear_1']['bias']"))
    p0 = _named_leaves(params)
    lr_sum = 0.0
    for t, (fq, fk) in enumerate(steps):
        jstate, jm = jstep(jstate, to_jx(fq), to_jx(fk))
        pm = train_step(state, to_pt(fq), to_pt(fk))
        for name in ("loss", "prob", "grad_norm"):
            np.testing.assert_allclose(float(pm[name]), float(jm[name]),
                                       rtol=1e-5, err_msg=name)
        lr_sum += lr_at(t, cfg.optim.learning_rate, TOTAL_STEPS,
                        cfg.optim.warmup)
        # Gradients after clipping to global norm 1 (the port clips in
        # place) agree within 1e-5 abs (seen: <= 1.3e-6, on leaves whose
        # largest entry is ~0.2); the bias leaves are at rounding level
        # on both sides (seen: <= 2.3e-8).
        clip = min(1.0, cfg.optim.clip_norm / float(jm["grad_norm"]))
        jg = {k: v * clip for k, v in
              _named_leaves(jstate.opt_state[0]).items()}
        pg = _named_leaves(_port_grads(model))
        _tree_close(pg, jg, 1e-5)
        for name in jg:
            if any(b in name for b in mlp_biases):
                assert np.abs(jg[name]).max() <= 1e-7, name
                assert np.abs(pg[name]).max() <= 1e-7, name

    p, s = state_dict_to_flax(model.state_dict())
    pe, se = state_dict_to_flax(ema.state_dict())
    _tree_close(p, jstate.params, 1e-5, skip=mlp_biases)
    p_now, p_jx = _named_leaves(p), _named_leaves(jstate.params)
    # The bias leaves are trained (they moved) by at most the summed lr.
    assert lr_sum > 0
    n_bias = 0
    for name in p_now:
        if any(b in name for b in mlp_biases):
            n_bias += 1
            moved = np.abs(p_now[name] - p0[name]).max()
            assert 0 < moved <= lr_sum, name
            assert np.abs(p_jx[name] - p0[name]).max() <= lr_sum, name
    assert n_bias == 4
    _tree_close(pe, jstate.ema_params, 1e-5)
    _tree_close(s, jstate.batch_stats, 1e-5, rtol=1e-5)
    _tree_close(se, jstate.ema_batch_stats, 1e-5, rtol=1e-5)
    np.testing.assert_allclose(state.queue.memory.numpy(),
                               np.asarray(jstate.queue.memory), rtol=0,
                               atol=1e-5)
    assert int(state.queue.index) == int(jstate.queue.index) == 3 * B % K
