"""The whole training state carried across: a gcc_tpu PretrainState that
took steps, written by gcc_tpu's Orbax checkpoint, read back as a numpy
tree and bridged into the port (``compat.pretrain_state_from_numpy``);
the next step agrees on both sides, and the bridge round-trips exactly."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from gcc_tpu.config import (  # noqa: E402
    ContrastConfig as JxContrast,
    EncoderConfig as JxEncoderConfig,
    TrainConfig as JxTrainConfig,
)
from gcc_tpu.contrastive import MoCoQueue as JxQueue  # noqa: E402
from gcc_tpu.features.featurize import BatchFeatures as JxFeatures  # noqa: E402
from gcc_tpu.models import GraphEncoder as JxEncoder  # noqa: E402
from gcc_tpu.training import checkpoint as jx_checkpoint  # noqa: E402
from gcc_tpu.training.optim import build_optimizer as jx_optimizer  # noqa: E402
from gcc_tpu.training.pretrain import (  # noqa: E402
    PretrainState as JxState,
    make_step_from_feats,
)
from gcc_tpu.training.schedules import make_lr_schedule  # noqa: E402
from gcc_tpu_torch.compat import (  # noqa: E402
    pretrain_state_from_numpy,
    pretrain_state_to_numpy,
)
from gcc_tpu_torch.config import (  # noqa: E402
    ContrastConfig,
    EncoderConfig,
    TrainConfig,
)
from gcc_tpu_torch.features.featurize import BatchFeatures  # noqa: E402
from gcc_tpu_torch.training.pretrain import train_step  # noqa: E402
from test_torch_models import SMALL, random_features  # noqa: E402
from test_torch_training import _named_leaves, _tree_close  # noqa: E402

torch.set_num_threads(1)

B, K, TOTAL_STEPS = 4, 24, 10


def _flat(tree, prefix=""):
    """{path: array} of a nested dict/list tree; None entries (optimizer
    stages without state) keep their place as None."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: None if tree is None else np.asarray(tree)}
    out = {}
    for key, value in items:
        out.update(_flat(value, f"{prefix}/{key}"))
    return out


def test_orbax_state_continues_in_the_port(tmp_path, monkeypatch):
    """Two JAX MoCo steps → save_checkpoint → load_checkpoint → numpy →
    the port's state. The bridged state equals the tree exactly
    (to_numpy(from_numpy(x)) == x: parameters, BatchNorm buffers, EMA
    copies, queue and ring index, Adam's flat moments and count, step,
    nce_z). A third step on the same features then agrees on both sides
    at the MoCo test's tolerances (1e-5 abs on params, EMA params, queue
    and Adam's moments; BatchNorm buffers 1e-5 abs + relative)."""
    monkeypatch.setenv("GCC_TPU_MERGED_QK", "0")
    rng = np.random.default_rng(11)
    steps = [(random_features(rng, b=B), random_features(rng, b=B))
             for _ in range(3)]
    queue0 = rng.uniform(-0.4, 0.4, (K, SMALL["output_size"])).astype(
        np.float32)
    jcfg = JxTrainConfig(batch_size=B, encoder=JxEncoderConfig(**SMALL),
                         contrast=JxContrast(moco=True, nce_k=K))
    cfg = TrainConfig(batch_size=B, encoder=EncoderConfig(**SMALL),
                      contrast=ContrastConfig(moco=True, nce_k=K))
    enc = JxEncoder(jcfg.encoder)
    to_jx = lambda f: JxFeatures(**{k: jnp.asarray(v) for k, v in f.items()})  # noqa: E731
    v = enc.init(jax.random.PRNGKey(0), to_jx(steps[0][0]), train=False)
    tx = jx_optimizer(jcfg.optim, make_lr_schedule(
        jcfg.optim.learning_rate, TOTAL_STEPS, jcfg.optim.warmup))
    jstate = JxState(
        params=v["params"], batch_stats=v["batch_stats"],
        ema_params=v["params"], ema_batch_stats=v["batch_stats"],
        queue=JxQueue(memory=jnp.asarray(queue0),
                      index=jnp.zeros((), jnp.int32)),
        opt_state=tx.init(v["params"]), step=jnp.zeros((), jnp.int32),
        dropout_rng=jax.random.PRNGKey(1),
        nce_z=jnp.full((), -1.0, jnp.float32))
    jstep = jax.jit(make_step_from_feats(jcfg, enc, tx))
    for fq, fk in steps[:2]:
        jstate, _ = jstep(jstate, to_jx(fq), to_jx(fk))

    target = jx_checkpoint.save_checkpoint(str(tmp_path), jstate, jcfg)
    tree = jx_checkpoint.load_checkpoint(target)
    state = pretrain_state_from_numpy(tree, cfg, TOTAL_STEPS, device="cpu")
    assert state.step == 2 and int(state.queue.index) == 2 * B

    back = _flat(pretrain_state_to_numpy(state))
    want = _flat({k: v for k, v in tree.items() if k != "dropout_rng"})
    assert back.keys() == want.keys()
    for name, x in want.items():
        if x is None:
            assert back[name] is None, name
        else:
            assert back[name].dtype == x.dtype, name
            np.testing.assert_array_equal(back[name], x, err_msg=name)
    assert np.abs(want["/opt_state/2/mu"]).max() > 0   # real moments

    fq, fk = steps[2]
    jstate, jm = jstep(jstate, to_jx(fq), to_jx(fk))
    to_pt = lambda f: BatchFeatures(**{k: torch.as_tensor(v)  # noqa: E731
                                       for k, v in f.items()})
    pm = train_step(state, to_pt(fq), to_pt(fk))
    for name in ("loss", "prob", "grad_norm"):
        np.testing.assert_allclose(float(pm[name]), float(jm[name]),
                                   rtol=1e-5, err_msg=name)
    got = pretrain_state_to_numpy(state)
    mlp_biases = tuple(f"['GINMLP_{i}']{b}" for i in range(2)
                       for b in ("['Linear_0']['bias']",
                                 "['Linear_1']['bias']"))
    _tree_close(got["params"], jstate.params, 1e-5, skip=mlp_biases)
    _tree_close(got["ema_params"], jstate.ema_params, 1e-5)
    _tree_close(got["batch_stats"], jstate.batch_stats, 1e-5, rtol=1e-5)
    _tree_close(got["ema_batch_stats"], jstate.ema_batch_stats, 1e-5,
                rtol=1e-5)
    np.testing.assert_allclose(got["queue"]["memory"],
                               np.asarray(jstate.queue.memory), rtol=0,
                               atol=1e-5)
    assert int(got["queue"]["index"]) == int(jstate.queue.index) == 3 * B
    adam, jadam = got["opt_state"][2], jstate.opt_state[2]
    assert int(adam["count"]) == int(jadam.count) == 3
    np.testing.assert_allclose(adam["mu"], np.asarray(jadam.mu), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(adam["nu"], np.asarray(jadam.nu), rtol=0,
                               atol=1e-5)
    assert int(got["step"]) == int(jstate.step) == 3
    assert _named_leaves(got["params"]).keys() == _named_leaves(
        jstate.params).keys()


def test_bridge_refuses_a_state_of_another_shape():
    cfg = TrainConfig(batch_size=B, encoder=EncoderConfig(**SMALL),
                      contrast=ContrastConfig(moco=True, nce_k=K))
    from gcc_tpu_torch.training.pretrain import create_pretrain_state

    tree = pretrain_state_to_numpy(create_pretrain_state(cfg, 4,
                                                         device="cpu"))
    assert int(tree["opt_state"][2]["count"]) == 0      # no step taken yet
    short = dict(tree, queue={"memory": tree["queue"]["memory"][:8],
                              "index": tree["queue"]["index"]})
    with pytest.raises(ValueError, match="queue memory"):
        pretrain_state_from_numpy(short, cfg, 4, device="cpu")
    cut = dict(tree, opt_state=[None, None, dict(
        tree["opt_state"][2], mu=tree["opt_state"][2]["mu"][:-1]),
        tree["opt_state"][3]])
    with pytest.raises(ValueError, match="flat optimizer vector"):
        pretrain_state_from_numpy(cut, cfg, 4, device="cpu")
