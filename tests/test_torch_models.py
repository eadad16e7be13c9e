"""The port's GraphEncoder vs gcc_tpu's Flax GraphEncoder at bridged
weights (gcc_tpu_torch.compat), in train and eval mode."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from gcc_tpu.config import EncoderConfig as JxEncoderConfig  # noqa: E402
from gcc_tpu.features.featurize import BatchFeatures as JxFeatures  # noqa: E402
from gcc_tpu.models import GraphEncoder as JxEncoder  # noqa: E402
from gcc_tpu_torch.compat import flax_to_state_dict, state_dict_to_flax  # noqa: E402
from gcc_tpu_torch.config import EncoderConfig  # noqa: E402
from gcc_tpu_torch.features.featurize import BatchFeatures  # noqa: E402
from gcc_tpu_torch.models import GraphEncoder  # noqa: E402

torch.set_num_threads(1)

SMALL = dict(num_layers=3, hidden_size=16, output_size=16,
             positional_embedding_size=8, final_dropout=0.0)


def random_features(rng, b=5, n=16, pos=8):
    """numpy BatchFeatures fields: varied node counts, symmetric
    multi-edge adjacency on real nodes, degrees past the 512 clamp."""
    n_nodes = rng.integers(3, n + 1, b)
    mask = (np.arange(n)[None, :] < n_nodes[:, None]).astype(np.float32)
    adj = rng.integers(0, 3, (b, n, n)).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) * mask[:, :, None] * mask[:, None, :]
    deg = adj.sum(axis=2).astype(np.int32)
    deg[:, 0] += 600 * (np.arange(b) % 2).astype(np.int32)
    seed = np.zeros((b, n), np.float32)
    seed[np.arange(b), rng.integers(0, n_nodes)] = 1.0
    pe = rng.standard_normal((b, n, pos)).astype(np.float32) * mask[..., None]
    return dict(pos=pe, degrees=deg, seed_flag=seed, node_mask=mask, adj=adj)


def _flax_variables(rng, f):
    enc = JxEncoder(JxEncoderConfig(**SMALL))
    feats = JxFeatures(**{k: jnp.asarray(v) for k, v in f.items()})
    v = enc.init(jax.random.PRNGKey(0), feats, train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    # Non-trivial running statistics, so eval mode tests the bridge.
    stats = jax.tree_util.tree_map(
        lambda x: (rng.uniform(0.5, 1.5, x.shape) if x.ndim else x
                   ).astype(np.float32), v["batch_stats"])
    return enc, feats, params, stats


@pytest.mark.parametrize("train", [True, False])
def test_encoder_matches_flax(train):
    """Embeddings (and, in train mode, the updated running statistics)
    within 1e-5 abs: the same f32 math in another order of sums."""
    rng = np.random.default_rng(0)
    f = random_features(rng)
    enc, feats, params, stats = _flax_variables(rng, f)
    if train:
        want, mut = enc.apply({"params": params, "batch_stats": stats},
                              feats, train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(1)})
    else:
        want = enc.apply({"params": params, "batch_stats": stats}, feats,
                         train=False)
    model = GraphEncoder(EncoderConfig(**SMALL))
    model.load_state_dict(flax_to_state_dict(params, stats))
    model.train(train)
    got = model(BatchFeatures(**{k: torch.as_tensor(v) for k, v in f.items()}))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    if train:
        _, new_stats = state_dict_to_flax(model.state_dict())
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                                    atol=1e-5),
            new_stats, jax.tree_util.tree_map(np.asarray,
                                              mut["batch_stats"]))


def test_bridge_round_trip_from_flax():
    """Flax variables → state_dict → Flax variables is exact."""
    rng = np.random.default_rng(1)
    _, _, params, stats = _flax_variables(rng, random_features(rng))
    p2, s2 = state_dict_to_flax(flax_to_state_dict(params, stats))
    for a, b in ((params, p2), (stats, s2)):
        assert jax.tree_util.tree_structure(a) == \
            jax.tree_util.tree_structure(b)
        jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)
