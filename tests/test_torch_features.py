"""The port's featurize_compact vs gcc_tpu's, on wire batches from the
port's own sampler pipeline (CPU: the kernels' plain versions; JAX with
its Pallas PE kernel in interpret mode)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from gcc_tpu.features.featurize import featurize_compact as jx_featurize  # noqa: E402
from gcc_tpu_torch.config import SamplerConfig  # noqa: E402
from gcc_tpu_torch.graph.corpus import synthetic_corpus  # noqa: E402
from gcc_tpu_torch.sampling.pipeline import (  # noqa: E402
    PipelineConfig,
    PretrainPipeline,
)
from gcc_tpu_torch.training.pretrain import featurize_stacked  # noqa: E402

torch.set_num_threads(1)

N_MAX, POS = 64, 8


@pytest.fixture(scope="module")
def wires(tmp_path_factory):
    """Two stacked (query, key) dispatch items of 2 steps x 8 graphs
    from RWR sampling on a small synthetic corpus."""
    store = synthetic_corpus(str(tmp_path_factory.mktemp("corpus")),
                             num_graphs=2, nodes_per_graph=3000,
                             avg_degree=8, seed=0)
    pcfg = PipelineConfig(batch_size=8, n_max=N_MAX, e_max=1024,
                          num_workers=0, emit="stacked", super_batch=2)
    with PretrainPipeline(store, SamplerConfig(rw_hops=64), pcfg,
                          seed=0) as pipe:
        return [next(pipe) for _ in range(2)]


def _exact_top(m_shift, n_b, k):
    """Exact descending eigenpairs of M (= m_shift - I) on the real
    nodes: values (k,), vectors (n_b, k)."""
    m = m_shift[:n_b, :n_b].astype(np.float64) - np.eye(n_b)
    w, v = np.linalg.eigh(m)
    return w[::-1][:k], v[:, ::-1][:, :k]


def test_featurize_compact_matches_jax(wires, monkeypatch):
    """adjacency, degrees, seed flag and node mask exact; identical k_b
    column masks; PE columns |cos| >= 0.999 against JAX wherever the
    column's eigenvalue is separated by >= 0.02 from its neighbours
    (within a cluster any rotation is an equally valid PE, and the two
    implementations' rounding picks different ones) on graphs of at
    least 2k nodes (below that the k-column block reaches the bottom of
    the shifted spectrum, which power iteration collapses, and the
    unguarded train-profile Rayleigh-Ritz mixes columns in either
    implementation)."""
    monkeypatch.setenv("GCC_TPU_PE_PALLAS", "interpret")
    checked = 0
    for wq, wk in wires:
        got = featurize_stacked(wq, wk, POS, n_max=N_MAX, device="cpu")
        k_steps, two_b = got.node_mask.shape[:2]
        edges = np.stack([wq.edges, wk.edges], axis=1).reshape(
            2 * k_steps, -1)
        meta = np.stack([wq.meta, wk.meta], axis=1).reshape(
            2 * k_steps, 3, -1)
        want = jx_featurize(jnp.asarray(edges), jnp.asarray(meta), N_MAX,
                            wq.id_bits, POS, pe_method="subspace",
                            e_cap=wq.e_max)
        for name in ("adj", "degrees", "seed_flag", "node_mask"):
            g = getattr(got, name).reshape(
                (k_steps * two_b,) + getattr(got, name).shape[2:]).numpy()
            np.testing.assert_array_equal(g, np.asarray(getattr(want, name)),
                                          err_msg=name)
        pos = got.pos.reshape(k_steps * two_b, N_MAX, POS).numpy()
        want_pos = np.asarray(want.pos)
        np.testing.assert_array_equal(np.abs(pos).sum(axis=1) > 0,
                                      np.abs(want_pos).sum(axis=1) > 0)
        adj = np.asarray(want.adj)
        n_nodes = meta[:, 0, :].reshape(-1)
        for g in range(pos.shape[0]):
            n_b = int(n_nodes[g])
            k_b = min(max(n_b - 2, 0), POS)
            if k_b == 0 or n_b < 2 * POS:
                continue
            deg = np.maximum(adj[g].sum(axis=1), 1.0)
            m = adj[g] / np.sqrt(deg)[:, None] / np.sqrt(deg)[None, :]
            lam, _ = _exact_top(m + np.eye(N_MAX), n_b, min(n_b, POS + 1))
            for j in range(k_b):
                gaps = [abs(lam[j] - lam[i]) for i in (j - 1, j + 1)
                        if 0 <= i < len(lam)]
                if min(gaps) < 0.02:
                    continue
                a, b = pos[g, :n_b, j], want_pos[g, :n_b, j]
                cos = abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
                assert cos >= 0.999, (g, j, cos)
                checked += 1
    assert checked >= 40, checked
