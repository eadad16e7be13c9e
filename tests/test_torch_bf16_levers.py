"""The reference's two bf16 storage levers in the port, against gcc_tpu
under ``GCC_TPU_ADJ_DTYPE=bf16`` and ``GCC_TPU_JACOBI_V_DTYPE=bf16``.

The reference reads its variables while it traces, so each test sets
them with monkeypatch and calls the JAX functions unjitted (or after
``jax.clear_caches()``); the port takes them as options
(``EncoderConfig.adj_dtype`` / ``jacobi_v_dtype``, ``adj_dtype`` /
``v_dtype`` arguments) and reads no variable. ``GCC_TPU_FUSED_FEATURIZE``
stays unset: Kernel 1 is held to the reference's default route, the one
the lever changes. CPU tensors run the kernels' plain versions.

Tolerances, each with its reason:

* Kernel 1: adj, m_shift and the degrees bit for bit (the same f32
  products, rounded to bf16 at the same places), on both routes, with an
  in-degree past 256 and a pair repeated past 256;
* ``aggregate_sum_dense``: the forward within 1e-5 relative (f32 sums of
  the same exact products in another order), the gradient of h within
  one bf16 ulp of its value (both round an f32 sum to bf16; a last-place
  difference of the sum can move the rounding by one ulp), measured 0;
* Jacobi with bf16 V: eigenvalues bit for bit those of the f32-V run;
  eigenvectors against JAX's bf16-V run by per-column |cos|, median
  >= 0.9999 and min >= 0.999 (measured 1.0 and >= 0.99999), tighter than
  the reference's own contract against f32 (median 0.995, min 0.9);
* the PE with a bf16 operator: the port's PE rules against the reference
  (|cos| >= 0.999 per gap-separated column, ``test_torch_generate.py``),
  and the reference's fidelity contract, median per-column |cos| >= 0.97
  against the f32 run;
* a MoCo step on bf16 features: loss, prob and grad_norm within 1e-5
  relative, gradients within 1e-5 abs, as ``test_torch_training.py``
  holds the f32 step (the bf16 rounding of h is the same rounding on
  both sides);
* an encode call: per graph cosine >= 0.999 and 2e-2 abs, as
  ``test_torch_generate.py`` holds the f32 eval profile.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from gcc_tpu import generate as jx_generate  # noqa: E402
from gcc_tpu.config import (  # noqa: E402
    ContrastConfig as JxContrast,
    EncoderConfig as JxEncoderConfig,
    TrainConfig as JxTrainConfig,
)
from gcc_tpu.contrastive import MoCoQueue as JxQueue  # noqa: E402
from gcc_tpu.features.featurize import (  # noqa: E402
    _MaskBatch,
    featurize_batch as jx_featurize_batch,
    featurize_compact as jx_featurize_compact,
)
from gcc_tpu.features.positional import (  # noqa: E402
    laplacian_positional_embedding as jx_pe,
    normalized_adjacency as jx_normalized_adjacency,
)
from gcc_tpu.models import GraphEncoder as JxEncoder  # noqa: E402
from gcc_tpu.models.gcn import UnsupervisedGCN as JxGCN  # noqa: E402
from gcc_tpu.ops import aggregate as jx_aggregate  # noqa: E402
from gcc_tpu.ops import jacobi as jx_jacobi  # noqa: E402
from gcc_tpu.training import pretrain as jx_pretrain  # noqa: E402
from gcc_tpu.training.optim import build_optimizer as jx_optimizer  # noqa: E402
from gcc_tpu.training.schedules import make_lr_schedule  # noqa: E402
from gcc_tpu_torch import cli, generate  # noqa: E402
from gcc_tpu_torch.compat import flax_to_state_dict, state_dict_to_flax  # noqa: E402
from gcc_tpu_torch.config import (  # noqa: E402
    ContrastConfig,
    EncoderConfig,
    TrainConfig,
    with_levers,
)
from gcc_tpu_torch.contrastive import MoCoQueue  # noqa: E402
from gcc_tpu_torch.features.featurize import (  # noqa: E402
    BatchFeatures,
    featurize_batch,
    featurize_compact,
)
from gcc_tpu_torch.graph.batch import batch_subgraphs  # noqa: E402
from gcc_tpu_torch.models import GraphEncoder  # noqa: E402
from gcc_tpu_torch.models.gcn import UnsupervisedGCN  # noqa: E402
from gcc_tpu_torch.ops import aggregate, jacobi  # noqa: E402
from gcc_tpu_torch.parallel import giant_features as gf  # noqa: E402
from gcc_tpu_torch.parallel import partitioned as part  # noqa: E402
from gcc_tpu_torch.training.optim import build_optimizer  # noqa: E402
from gcc_tpu_torch.training.pretrain import (  # noqa: E402
    PretrainState,
    featurize_e2e_split,
    featurize_stacked,
    train_step,
)
from featurize_wires import heavy_wire as _heavy_wire  # noqa: E402
from test_torch_generate import (  # noqa: E402
    E_MAX,
    N_MAX,
    POS,
    _jx,
    _pe_columns_agree,
    encoders,
    random_subgraphs,
)
from test_torch_models import SMALL, random_features  # noqa: E402
from test_torch_ops import _sym, random_wire  # noqa: E402
from test_torch_training import (  # noqa: E402
    _grad_recorder,
    _named_leaves,
    _port_grads,
)

torch.set_num_threads(1)

BF16 = "bfloat16"


@pytest.fixture
def adj_lever(monkeypatch):
    monkeypatch.delenv("GCC_TPU_FUSED_FEATURIZE", raising=False)
    monkeypatch.setenv("GCC_TPU_ADJ_DTYPE", "bf16")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def v_lever(monkeypatch):
    monkeypatch.setenv("GCC_TPU_JACOBI_V_DTYPE", "bf16")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _close_to_a_bf16_ulp(got, want):
    """Every leaf of two Flax-layout gradient trees within one bf16 ulp of
    the leaf's largest entry, 2^-8 · max|want|, or within the f32 step's
    1e-5 (test_torch_training.py) where that is larger: the encoders
    round the cotangent of h to bf16 on both sides, and where the two f32
    sums before it differ in the last place the rounding can land one
    bf16 ulp apart, a difference the backward carries into the weights'
    gradients at that scale (measured up to 2^-10.3 of the leaf's largest
    entry)."""
    got, want = _named_leaves(got), _named_leaves(want)
    assert got.keys() == want.keys()
    for name, w in want.items():
        bound = max(2.0 ** -8 * float(np.abs(w).max()), 1e-5)
        np.testing.assert_allclose(got[name], w, rtol=0, atol=bound,
                                   err_msg=name)


def _column_cosines(a, b):
    """(B, pos) per-column |cos| of two (B, N, pos) PEs over the node
    axis, and which columns are live in b."""
    na, nb = np.linalg.norm(a, axis=1), np.linalg.norm(b, axis=1)
    return np.abs(np.sum(a * b, axis=1)) / np.maximum(na * nb, 1e-30), \
        nb > 1e-6


def _np32(x):
    """A JAX or torch array of any float dtype as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_values(x: np.ndarray) -> bool:
    return np.array_equal(x, _np32(torch.tensor(x).to(torch.bfloat16)))


# ---- Kernel 1 and the adjacency chain -------------------------------------

def _reference_chain(edges, meta, n_max, id_bits):
    """The reference's default route under the lever: the compact builder,
    normalized_adjacency, _subspace_topk's shift (positional.py:206), and
    featurize_compact's degree feature (featurize.py:128)."""
    adj = jx_aggregate.build_dense_adjacency_compact(
        jnp.asarray(edges), jnp.asarray(meta[:, 1, :]), n_max, id_bits)
    n_nodes = meta[:, 0, :].reshape(-1)
    mask = (np.arange(n_max)[None, :] < n_nodes[:, None]).astype(np.float32)
    m = jx_normalized_adjacency(_MaskBatch(node_mask=jnp.asarray(mask),
                                           n_nodes=jnp.asarray(n_nodes)), adj)
    eye = jnp.eye(n_max, dtype=m.dtype)
    pad = 1.0 - jnp.asarray(mask)
    m_shift = (m + (pad[:, :, None] * eye) + eye).astype(m.dtype)
    deg = adj.sum(axis=2).astype(jnp.int32)
    return adj, m_shift, deg


def _wire(case):
    if case == "heavy":
        return _heavy_wire()
    n_max, s, b, e_tot, full = case
    return random_wire(np.random.default_rng(n_max), s, b, n_max, e_tot,
                       full=full) + (n_max,)


def _unpack(w):
    edges, meta, id_bits, n_max = w
    return edges, meta, n_max, id_bits


@pytest.mark.parametrize("case", [(16, 3, 4, 64, False),
                                  (64, 3, 4, 256, True),
                                  (300, 2, 2, 512, True), "heavy"])
def test_featurize_plain_bf16_matches_reference_chain(case, adj_lever):
    """Kernel 1's plain version in bf16 against the reference's default
    chain under GCC_TPU_ADJ_DTYPE=bf16: adj, m_shift and the train
    route's degree feature bit for bit."""
    w = _wire(case)
    edges, meta, n_max, id_bits = w if case == "heavy" else _unpack(w)
    want_adj, want_ms, want_deg = _reference_chain(edges, meta, n_max,
                                                   id_bits)
    assert want_adj.dtype == want_ms.dtype == jnp.bfloat16
    e = torch.as_tensor(edges.astype(np.int64) & 0xFFFFFFFF).to(torch.int32)
    adj, m_shift, deg = aggregate.fused_adjacency_featurize(
        e, torch.as_tensor(meta), n_max, id_bits, BF16)
    assert adj.dtype == m_shift.dtype == torch.bfloat16
    assert deg.dtype == torch.float32
    np.testing.assert_array_equal(_np32(adj), _np32(want_adj))
    np.testing.assert_array_equal(_np32(m_shift), _np32(want_ms))
    np.testing.assert_array_equal(deg.numpy().astype(np.int32),
                                  np.asarray(want_deg))
    if case == "heavy":
        assert _np32(adj)[0, 1, 2] == 256.0      # 300 repeats stop at 256
        np.testing.assert_array_equal(deg.numpy()[0, :4],
                                      [300.0, 256.0, 0.0, 260.0])


def test_featurize_compact_and_batch_degrees_follow_their_routes(adj_lever):
    """The train route (featurize_compact) takes the degree sum in bf16,
    the padded route (featurize_batch) in f32, in the port as in the
    reference: in-degree 301 reads 300 on the first and 301 on the
    second. The adjacency is equal on both sides of both routes."""
    edges, meta, n_max, id_bits = _heavy_wire()
    want = jx_featurize_compact(jnp.asarray(edges), jnp.asarray(meta), n_max,
                                id_bits, 8, pe_method="subspace",
                                e_cap=1024)
    got = featurize_compact(torch.as_tensor(edges), torch.as_tensor(meta),
                            n_max, id_bits, 8, adj_dtype=BF16)
    np.testing.assert_array_equal(got.degrees.numpy(), np.asarray(want.degrees))
    np.testing.assert_array_equal(_np32(got.adj), _np32(want.adj))
    assert int(got.degrees[0, 0]) == 300

    n_edges = int(meta[0, 1, 0])
    src = (edges[0, :n_edges] & 0xFFFF).astype(np.int32)
    dst = (edges[0, :n_edges] >> 16).astype(np.int32)
    from gcc_tpu.graph.batch import batch_subgraphs as jx_batch
    from gcc_tpu_torch.graph.batch import Subgraph

    keep = ~((src == 2) & (dst == 1))            # the padded builder casts
    subs = [Subgraph(src=src[keep], dst=dst[keep], num_nodes=400, seed=0)]
    want_b = jx_featurize_batch(jx_batch(_jx(subs), 512, 1024), 8,
                                pe_method="subspace", profile="eval")
    got_b = featurize_batch(batch_subgraphs(subs, 512, 1024), 8,
                            pe_method="subspace", profile="eval",
                            device="cpu", adj_dtype=BF16)
    assert want_b.adj.dtype == jnp.bfloat16
    assert got_b.adj.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np32(got_b.adj), _np32(want_b.adj))
    np.testing.assert_array_equal(got_b.degrees.numpy(),
                                  np.asarray(want_b.degrees))
    assert int(got_b.degrees[0, 0]) == 301


# ---- aggregation, its gradient and the models ----------------------------

def test_aggregate_sum_dense_bf16_forward_and_gradient(adj_lever):
    """aggregate_sum_dense with a bf16 adjacency against the reference's:
    f32 output within 1e-5 relative; the gradient of h rounded to bf16
    by both (JAX's VJP of the convert, autograd's of .to), within one
    bf16 ulp of its value."""
    rng = np.random.default_rng(3)
    adj = rng.integers(0, 4, (3, 24, 24)).astype(np.float32)
    h = rng.standard_normal((3, 24, 8)).astype(np.float32)
    r = rng.standard_normal((3, 24, 8)).astype(np.float32)
    adj_j = jnp.asarray(adj, jnp.bfloat16)
    want, want_g = jax.value_and_grad(
        lambda h: jnp.sum(jx_aggregate.aggregate_sum_dense(h, adj_j) * r))(
            jnp.asarray(h))
    out_j = jx_aggregate.aggregate_sum_dense(jnp.asarray(h), adj_j)
    ht = torch.as_tensor(h).requires_grad_(True)
    out = aggregate.aggregate_sum_dense(ht, torch.as_tensor(adj).to(
        torch.bfloat16))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-6)
    total = (out * torch.as_tensor(r)).sum()
    total.backward()
    g, g_j = ht.grad.numpy(), np.asarray(want_g)
    assert _bf16_values(g) and _bf16_values(g_j)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(g_j), 1e-30))) - 7)
    assert np.all(np.abs(g - g_j) <= ulp), np.abs(g - g_j).max()
    np.testing.assert_allclose(float(total.detach()), float(want),
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["gin", "mpnn", "gat"])
def test_encoders_on_a_bf16_adjacency_match_flax(kind, adj_lever):
    """The encoders reading a bf16 adjacency (GIN's and MPNN's sums round
    h to bf16, GAT's log-multiplicity rounds in bf16) against Flax on the
    same bf16 features: forward within 1e-5, the gradient of a scalar
    within one bf16 ulp of each leaf's scale (_close_to_a_bf16_ulp)."""
    rng = np.random.default_rng(4)
    f = random_features(rng)
    kw = {} if kind == "gin" else dict(model=kind)
    jenc = JxEncoder(JxEncoderConfig(**SMALL, **kw))
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    jf["adj"] = jf["adj"].astype(jnp.bfloat16)
    from gcc_tpu.features.featurize import BatchFeatures as JxFeatures

    jfeats = JxFeatures(**jf)
    v = jenc.init(jax.random.PRNGKey(0), jfeats, train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v.get("batch_stats", {}))
    r = rng.standard_normal((f["adj"].shape[0], SMALL["output_size"])
                            ).astype(np.float32)

    def loss(p):
        out = jenc.apply({"params": p, "batch_stats": stats}, jfeats,
                         train=False)
        return jnp.sum(out * r), out

    (_, want), g_want = jax.value_and_grad(loss, has_aux=True)(params)
    model = GraphEncoder(EncoderConfig(**SMALL, **kw, adj_dtype=BF16))
    model.load_state_dict(flax_to_state_dict(params, stats))
    model.eval()
    pf = {k: torch.as_tensor(v) for k, v in f.items()}
    pf["adj"] = pf["adj"].to(torch.bfloat16)
    got = model(BatchFeatures(**pf))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    (got * torch.as_tensor(r)).sum().backward()
    sd = dict(model.state_dict())
    sd.update({n: p.grad if p.grad is not None else torch.zeros_like(p)
               for n, p in model.named_parameters()})
    _close_to_a_bf16_ulp(state_dict_to_flax(sd)[0], g_want)


def test_gcn_on_a_bf16_adjacency_matches_flax(adj_lever):
    """GCN widens a bf16 adjacency (Â = A + I in f32, as the reference's
    promotion gives): forward and gradient within 1e-5 of Flax, and equal
    to the f32 adjacency's run."""
    rng = np.random.default_rng(5)
    f = random_features(rng)
    h = rng.standard_normal((5, 16, 8)).astype(np.float32) \
        * f["node_mask"][..., None]
    adj16 = jnp.asarray(f["adj"], jnp.bfloat16)
    args = (jnp.asarray(h), adj16, jnp.asarray(f["node_mask"]),
            jnp.asarray(f["seed_flag"]))
    flax_mod = JxGCN(16, 2, "avg", False)
    p = jax.tree_util.tree_map(np.asarray, flax_mod.init(
        jax.random.PRNGKey(0), *args)["params"])
    want = flax_mod.apply({"params": p}, *args)
    port = UnsupervisedGCN(8, 16, 2, "avg", False)
    port.load_state_dict({
        f"layers.{i}.{n}": torch.as_tensor(
            p[f"Linear_{i}"]["kernel"].T if n == "weight"
            else p[f"Linear_{i}"]["bias"]) for i in range(2)
        for n in ("weight", "bias")})
    targs = (torch.as_tensor(h), torch.as_tensor(f["adj"]).to(torch.bfloat16),
             torch.as_tensor(f["node_mask"]), torch.as_tensor(f["seed_flag"]))
    got = port(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    f32 = port(targs[0], targs[1].to(torch.float32), *targs[2:])
    np.testing.assert_array_equal(got.detach().numpy(), f32.detach().numpy())


# ---- Kernel 3 with bf16 V -------------------------------------------------

def _col_cos(v, w):
    return np.abs(np.einsum("bij,bij->bj", v, w)) / (
        np.linalg.norm(v, axis=1) * np.linalg.norm(w, axis=1))


@pytest.mark.parametrize("layout", ["lane", "bm"])
@pytest.mark.parametrize("n,sweeps", [(8, 5), (32, 3), (32, 5), (48, 5)])
def test_jacobi_bf16_v_matches_reference(layout, n, sweeps, v_lever):
    """jacobi_eigh_plain with v_dtype bf16 against jacobi_eigh under
    GCC_TPU_JACOBI_V_DTYPE=bf16: eigenvalues bit for bit those of the
    port's f32-V run, V rounded to bf16 (its entries are bf16 values),
    eigenvectors by per-column |cos| (module docstring)."""
    a = _sym(np.random.default_rng(n + sweeps), 6, n)
    w_j, v_j = jx_jacobi.jacobi_eigh(jnp.asarray(a), sweeps=sweeps,
                                     descending=True, layout=layout)
    w_lo, v_lo = jacobi.jacobi_eigh(torch.as_tensor(a), sweeps=sweeps,
                                    descending=True, v_dtype=BF16)
    w_hi, v_hi = jacobi.jacobi_eigh(torch.as_tensor(a), sweeps=sweeps,
                                    descending=True)
    assert v_lo.dtype == torch.float32
    np.testing.assert_array_equal(w_lo.numpy(), w_hi.numpy())
    np.testing.assert_allclose(w_lo.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-5)
    assert _bf16_values(v_lo.numpy())
    cos = _col_cos(v_lo.numpy(), np.asarray(v_j))
    assert np.median(cos) >= 0.9999 and cos.min() >= 0.999, (
        np.median(cos), cos.min())
    # The lever's own contract against f32 (the reference's test).
    cos_f = _col_cos(v_lo.numpy(), v_hi.numpy())
    assert np.median(cos_f) > 0.995 and cos_f.min() > 0.9


# ---- the PE with a bf16 operator ----------------------------------------

@pytest.mark.parametrize("profile", ["train", "eval"])
def test_subspace_pe_with_bf16_operator_matches_reference(profile,
                                                          monkeypatch,
                                                          adj_lever):
    """The subspace PE on a bf16 adjacency, train and eval profiles,
    against laplacian_positional_embedding under GCC_TPU_ADJ_DTYPE=bf16
    with its Pallas kernel in interpret mode: the port's PE rules (column
    masks equal, |cos| >= 0.999 per gap-separated column; measured
    >= 0.99999), and the reference's fidelity contract against the f32
    run (median per-column |cos| >= 0.97)."""
    monkeypatch.setenv("GCC_TPU_PE_PALLAS", "interpret")
    rng = np.random.default_rng(6 if profile == "train" else 7)
    subs = random_subgraphs(rng, 8, 20, N_MAX)
    want = np.asarray(jx_pe(jx_batch_of(subs), POS, method="subspace",
                            profile=profile))
    got = featurize_batch(batch_subgraphs(subs, N_MAX, E_MAX), POS,
                          pe_method="subspace", profile=profile,
                          device="cpu", adj_dtype=BF16)
    assert got.adj.dtype == torch.bfloat16
    pos = got.pos.numpy()
    _pe_columns_agree(pos, want, subs, POS)
    f32 = featurize_batch(batch_subgraphs(subs, N_MAX, E_MAX), POS,
                          pe_method="subspace", profile=profile,
                          device="cpu").pos.numpy()
    cos, live = _column_cosines(pos, f32)
    print(f"{profile}: adjacency lever, per-column |cos| vs f32 median "
          f"{np.median(cos[live]):.6f}, min {cos[live].min():.4f}")
    assert np.median(cos[live]) >= 0.97, np.median(cos[live])


@pytest.mark.parametrize("profile", ["train", "eval"])
def test_subspace_pe_with_both_levers_matches_reference(profile,
                                                        monkeypatch,
                                                        adj_lever):
    """The PE with both levers against the reference under both
    variables. A bf16 V rounds the Jacobi finishes' rotations to ~0.4%,
    and where the two implementations' f32 rotations differ in the last
    place a rounding can land one bf16 ulp apart; the eval profile's
    whitening amplifies that in ill-conditioned guard directions (the
    f32 finish amplifies its own last-place differences the same way,
    from 1e-7 to 2e-4), so single columns move (measured: median
    0.998, min 0.944 on the eval profile; 1.0 on the train profile). Held
    to the reference's fidelity contract for the lever: median
    per-column |cos| >= 0.97 against the reference, column masks
    equal."""
    monkeypatch.setenv("GCC_TPU_PE_PALLAS", "interpret")
    monkeypatch.setenv("GCC_TPU_JACOBI_V_DTYPE", "bf16")
    rng = np.random.default_rng(6 if profile == "train" else 7)
    subs = random_subgraphs(rng, 8, 20, N_MAX)
    want = np.asarray(jx_pe(jx_batch_of(subs), POS, method="subspace",
                            profile=profile))
    pos = featurize_batch(batch_subgraphs(subs, N_MAX, E_MAX), POS,
                          pe_method="subspace", profile=profile,
                          device="cpu", adj_dtype=BF16,
                          v_dtype=BF16).pos.numpy()
    np.testing.assert_array_equal(np.abs(pos).sum(axis=1) > 0,
                                  np.abs(want).sum(axis=1) > 0)
    cos, live = _column_cosines(pos, want)
    print(f"{profile}: per-column |cos| vs the reference median "
          f"{np.median(cos[live]):.6f}, min {cos[live].min():.4f}")
    assert np.median(cos[live]) >= 0.97, np.median(cos[live])


def jx_batch_of(subs):
    from gcc_tpu.graph.batch import batch_subgraphs as jx_batch

    return jax.device_put(jx_batch(_jx(subs), N_MAX, E_MAX))


# ---- the slice as a whole -------------------------------------------------

@pytest.fixture(scope="module")
def routed_wire(tmp_path_factory):
    """One routed dispatch item (2 steps x 8 graphs, bucket 64) from RWR
    sampling on a small synthetic corpus."""
    from gcc_tpu_torch.config import SamplerConfig
    from gcc_tpu_torch.graph.corpus import synthetic_corpus
    from gcc_tpu_torch.sampling.pipeline import (
        PipelineConfig,
        PretrainPipeline,
    )

    store = synthetic_corpus(str(tmp_path_factory.mktemp("corpus")),
                             num_graphs=2, nodes_per_graph=3000,
                             avg_degree=8, seed=0)
    pcfg = PipelineConfig(batch_size=8, n_max=64, e_max=1024,
                          num_workers=0, emit="routed", super_batch=2,
                          n_small=32)
    with PretrainPipeline(store, SamplerConfig(rw_hops=64), pcfg,
                          seed=0) as pipe:
        while True:
            wq, wk = next(pipe)
            if wq.n_max == 64:
                return wq, wk


def test_routed_moco_step_with_both_levers_matches_reference(
        routed_wire, monkeypatch, adj_lever):
    """A routed MoCo dispatch item with both levers on. Featurization:
    the port's featurize_stacked against the reference's featurize_compact
    under both variables — adjacency (bf16), degrees, masks bit for bit,
    PE columns |cos| >= 0.999 where separated. Then one MoCo step from
    the reference's bf16 features through both, weights bridged by
    compat.py: loss, prob, grad_norm within 1e-4 relative (measured
    1.6e-5: the bf16 roundings of h and of its cotangent can land one
    ulp apart, _close_to_a_bf16_ulp), gradients within one bf16 ulp of
    each leaf's scale."""
    monkeypatch.setenv("GCC_TPU_PE_PALLAS", "interpret")
    monkeypatch.setenv("GCC_TPU_JACOBI_V_DTYPE", "bf16")
    monkeypatch.setenv("GCC_TPU_MERGED_QK", "0")
    wq, wk = routed_wire
    n_max, pos = wq.n_max, 8
    got = featurize_stacked(wq, wk, pos, device="cpu", adj_dtype=BF16,
                            v_dtype=BF16)
    k_steps, two_b = got.node_mask.shape[:2]
    edges = np.stack([wq.edges, wk.edges], axis=1).reshape(2 * k_steps, -1)
    meta = np.stack([wq.meta, wk.meta], axis=1).reshape(2 * k_steps, 3, -1)
    want = jx_featurize_compact(jnp.asarray(edges), jnp.asarray(meta), n_max,
                                wq.id_bits, pos, pe_method="subspace",
                                e_cap=wq.e_max)
    assert want.adj.dtype == jnp.bfloat16 and got.adj.dtype == torch.bfloat16
    flat = lambda x: x.reshape((k_steps * two_b,) + x.shape[2:])  # noqa: E731
    np.testing.assert_array_equal(_np32(flat(got.adj)), _np32(want.adj))
    for name in ("degrees", "seed_flag", "node_mask"):
        np.testing.assert_array_equal(flat(getattr(got, name)).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    pos_got = flat(got.pos).numpy()
    want_pos = np.asarray(want.pos)
    np.testing.assert_array_equal(np.abs(pos_got).sum(axis=1) > 0,
                                  np.abs(want_pos).sum(axis=1) > 0)
    cos, live = _column_cosines(pos_got, want_pos)
    assert np.median(cos[live]) >= 0.97, np.median(cos[live])

    b, nce_k = two_b // 2, 24
    step0 = {k: np.asarray(v)[:two_b] for k, v in want._asdict().items()}
    fq = {k: v[:b] for k, v in step0.items()}
    fk = {k: v[b:] for k, v in step0.items()}
    enc_kw = dict(num_layers=3, hidden_size=16, output_size=16,
                  positional_embedding_size=pos, final_dropout=0.0)
    jcfg = JxTrainConfig(batch_size=b, encoder=JxEncoderConfig(**enc_kw),
                         contrast=JxContrast(moco=True, nce_k=nce_k))
    from gcc_tpu.features.featurize import BatchFeatures as JxFeatures

    to_jx = lambda f: JxFeatures(**{k: jnp.asarray(v) for k, v in f.items()})  # noqa: E731
    enc = JxEncoder(jcfg.encoder)
    v = enc.init(jax.random.PRNGKey(0), to_jx(fq), train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    queue0 = np.random.default_rng(0).uniform(
        -0.4, 0.4, (nce_k, 16)).astype(np.float32)
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
        jstate, to_jx(fq), to_jx(fk))

    cfg = TrainConfig(batch_size=b, encoder=EncoderConfig(
        **enc_kw, adj_dtype=BF16, jacobi_v_dtype=BF16),
        contrast=ContrastConfig(moco=True, nce_k=nce_k))
    model = GraphEncoder(cfg.encoder)
    model.load_state_dict(flax_to_state_dict(params, stats))
    import copy

    state = PretrainState(
        cfg=cfg, model=model,
        ema_model=copy.deepcopy(model).requires_grad_(False),
        optimizer=build_optimizer(model.parameters(), cfg.optim),
        queue=MoCoQueue(memory=torch.as_tensor(queue0.copy()),
                        index=torch.zeros((), dtype=torch.int64)),
        dropout_gen=torch.Generator().manual_seed(0), total_steps=10)

    def to_pt(f):
        out = {k: torch.as_tensor(np.asarray(v, np.float32)
                                  if k == "adj" else v) for k, v in f.items()}
        out["adj"] = out["adj"].to(torch.bfloat16)
        return BatchFeatures(**out)

    pm = train_step(state, to_pt(fq), to_pt(fk))
    for name in ("loss", "prob", "grad_norm"):
        np.testing.assert_allclose(float(pm[name]), float(jm[name]),
                                   rtol=1e-4, err_msg=name)
    clip = min(1.0, cfg.optim.clip_norm / float(jm["grad_norm"]))
    jg = jax.tree_util.tree_map(lambda x: np.asarray(x) * clip,
                                jstate.opt_state[0])
    _close_to_a_bf16_ulp(_port_grads(model), jg)


@pytest.mark.parametrize("levers,min_cos,atol", [
    (("adj",), 0.999, 2e-2), (("adj", "v"), 0.99, 5e-2)])
def test_generate_encode_with_the_levers_matches_reference(
        levers, min_cos, atol, monkeypatch):
    """One generate_embeddings encode call (eval profile, 12 graphs) with
    the adjacency lever, and with both, against the reference's under the
    same variables, weights bridged (made before the variables are set:
    the helper's exact PE refuses a bf16 operator in the reference). The
    adjacency lever alone keeps the f32 eval profile's bounds (per graph
    cosine >= 0.999, 2e-2 abs; test_torch_generate.py). With the V lever
    too, PE columns move between the implementations as
    test_subspace_pe_with_both_levers_matches_reference states, and the
    embeddings with them: per graph cosine >= 0.99, 5e-2 abs (measured
    0.9975 and 0.026)."""
    monkeypatch.setenv("GCC_TPU_PE_PALLAS", "interpret")
    rng = np.random.default_rng(8)
    subs = random_subgraphs(rng, 12, 20, N_MAX)
    jcfg, jstate, cfg, model = encoders("subspace", subs)
    cfg = with_levers(cfg, BF16, BF16 if "v" in levers else None)
    monkeypatch.setenv("GCC_TPU_ADJ_DTYPE", "bf16")
    if "v" in levers:
        monkeypatch.setenv("GCC_TPU_JACOBI_V_DTYPE", "bf16")
    jax.clear_caches()
    want = jx_generate.generate_embeddings(jcfg, jstate, _jx(subs),
                                           n_max=N_MAX, e_max=E_MAX,
                                           batch_size=12)
    got = generate.generate_embeddings(cfg, model, subs, n_max=N_MAX,
                                       e_max=E_MAX, batch_size=12,
                                       device="cpu")
    assert np.isfinite(got).all()
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() >= min_cos, cos.min()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_e2e_split_keeps_an_f32_adjacency(routed_wire, monkeypatch,
                                          adj_lever):
    """The E2E size split builds its adjacency in f32 under the adjacency
    lever (pretrain.py:424) in both packages, and its PE takes the V
    lever: adjacency and degrees equal to the reference's, f32."""
    monkeypatch.setenv("GCC_TPU_JACOBI_V_DTYPE", "bf16")
    wq, wk = routed_wire
    classes = ((32, 4), (64, 4))
    got, _ = featurize_e2e_split(wq, wk, 8, "subspace", classes,
                                 device="cpu", v_dtype=BF16)
    want, _ = jx_pretrain.featurize_e2e_split(
        wq, wk, 8, "subspace", classes, None)
    for g, w in zip(got, want):
        assert g.adj.dtype == torch.float32 and w.adj.dtype == jnp.float32
        np.testing.assert_array_equal(g.adj.numpy(), np.asarray(w.adj))
        np.testing.assert_array_equal(g.degrees.numpy(),
                                      np.asarray(w.degrees))


def test_giant_pe_takes_the_v_lever(monkeypatch):
    """giant_laplacian_pe's two Kernel 3 solves store V in bf16 with
    v_dtype bf16, as the reference's finish does under the variable
    (giant_features.py:183, 196). The lever moves the giant PE far: the
    guarded whitening rotates by the eigenvectors of a Gram that is the
    identity to ~1e-6 (tests/test_torch_giant_dist.py), so V's bf16
    rounding leaves the whitened basis ~1% off orthonormal and the
    Rayleigh-Ritz mixes its columns. On the separated graph of
    tests/test_torch_giant_pe.py the reference's own bf16 PE is 0.092
    from its f32 PE in mean row cosine error (columns down to |cos|
    0.04); the port's moves by 0.074. Held: rows unit and padding zero,
    and the port's move at most twice the reference's."""
    import test_torch_giant_pe as tg

    seen = []
    real = gf.jacobi_eigh

    def spy(a, **kw):
        seen.append(kw.get("v_dtype"))
        return real(a, **kw)

    monkeypatch.setattr(gf, "jacobi_eigh", spy)
    n, src, dst, w = tg._separated_graph(tg.SEP_POS)
    pg = part.place_partition(part.partition_dense(src, dst, n, 1, weight=w),
                              "cpu")
    q0 = torch.from_numpy(gf.giant_pe_basis(pg.num_nodes, n, tg.SEP_POS,
                                            guards=16))
    mask = (torch.arange(pg.num_nodes) < n).to(torch.float32)
    pe = {dt: gf.giant_laplacian_pe(pg, q0, mask, num_real_nodes=n,
                                    pos_size=tg.SEP_POS, v_dtype=dt).numpy()
          for dt in (BF16, "float32")}
    assert seen == [BF16, BF16, "float32", "float32"]
    assert np.abs(pe[BF16][n:]).max(initial=0.0) == 0.0
    np.testing.assert_allclose(np.linalg.norm(pe[BF16][:n], axis=1), 1.0,
                               atol=1e-5)
    ref = {}
    for dt, var in ((BF16, "bf16"), ("float32", None)):
        if var:
            monkeypatch.setenv("GCC_TPU_JACOBI_V_DTYPE", var)
        else:
            monkeypatch.delenv("GCC_TPU_JACOBI_V_DTYPE")
        jax.clear_caches()
        ref[dt] = tg._reference_pe.__wrapped__()
    moved, _ = tg._row_cosine_errors(pe[BF16][:n], pe["float32"][:n])
    ref_moved, _ = tg._row_cosine_errors(ref[BF16], ref["float32"])
    print(f"giant PE, bf16 V against f32: mean row cosine error {moved:.4g} "
          f"(the reference's {ref_moved:.4g})")
    assert 0 < ref_moved and 0 < moved <= 2 * ref_moved, (moved, ref_moved)


# ---- configuration and command line --------------------------------------

def test_config_round_trip_and_old_sidecar_loads_as_f32():
    """The levers survive the JSON sidecar; a sidecar written before them
    loads as float32; an unknown dtype is refused."""
    cfg = TrainConfig(encoder=EncoderConfig(adj_dtype=BF16,
                                            jacobi_v_dtype=BF16))
    back = TrainConfig.from_json(cfg.to_json())
    assert back == cfg
    old = json.loads(TrainConfig().to_json())
    for key in ("adj_dtype", "jacobi_v_dtype"):
        del old["encoder"][key]
    loaded = TrainConfig.from_json(json.dumps(old))
    assert loaded.encoder.adj_dtype == loaded.encoder.jacobi_v_dtype \
        == "float32"
    assert loaded == TrainConfig()
    with pytest.raises(ValueError, match="adj_dtype"):
        EncoderConfig(adj_dtype="float16")
    assert with_levers(cfg, None, "float32").encoder == dataclasses.replace(
        cfg.encoder, jacobi_v_dtype="float32")
    assert with_levers(cfg) is cfg


def test_cli_flags_set_and_override_the_levers(monkeypatch):
    """pretrain's flags set the new run's levers (float32 when omitted);
    generate's and finetune's override a checkpoint's only where given;
    the instruments' parser takes them on pretrain, finetune and embed."""
    from gcc_tpu_torch.instruments import __main__ as instr

    seen = {}

    def capture(name):
        return lambda args: seen.__setitem__(name, args)

    for name in ("cmd_pretrain", "cmd_generate", "cmd_finetune"):
        monkeypatch.setattr(cli, name, capture(name))
    cli.main(["pretrain", "--adj-dtype", BF16, "--jacobi-v-dtype", BF16])
    cfg = cli._cfg_from_args(seen["cmd_pretrain"])
    assert (cfg.encoder.adj_dtype, cfg.encoder.jacobi_v_dtype) == (BF16, BF16)
    cli.main(["pretrain"])
    assert cli._cfg_from_args(seen["cmd_pretrain"]).encoder == EncoderConfig()
    cli.main(["generate", "--ckpt", "x", "--dataset", "y",
              "--jacobi-v-dtype", BF16])
    args = seen["cmd_generate"]
    assert (args.adj_dtype, args.jacobi_v_dtype) == (None, BF16)
    ckpt_cfg = TrainConfig(encoder=EncoderConfig(adj_dtype=BF16))
    over = with_levers(ckpt_cfg, args.adj_dtype, args.jacobi_v_dtype)
    assert (over.encoder.adj_dtype, over.encoder.jacobi_v_dtype) == (BF16, BF16)
    cli.main(["finetune", "--adj-dtype", "float32"])
    assert seen["cmd_finetune"].adj_dtype == "float32"
    with pytest.raises(SystemExit):
        cli.main(["pretrain", "--adj-dtype", "bf16"])

    calls = {}

    def record(name):
        def fn(*args, **kw):
            calls[name] = kw
            raise SystemExit(0)
        return fn

    monkeypatch.setattr("gcc_tpu_torch.instruments.finetune."
                        "run_finetune_instrument", record("finetune"))
    monkeypatch.setattr(instr, "embed", record("embed"))
    for argv in (["finetune", "--ckpt", "c", "--adj-dtype", BF16],
                 ["embed", "--ckpt", "c", "--out", "o"]):
        with pytest.raises(SystemExit):
            instr.main(argv)
    assert (calls["finetune"]["adj_dtype"],
            calls["finetune"]["jacobi_v_dtype"]) == (BF16, None)
    assert (calls["embed"]["adj_dtype"],
            calls["embed"]["jacobi_v_dtype"]) == (None, None)
    monkeypatch.setattr("gcc_tpu_torch.instruments.pretrain.pretrain",
                        record("pretrain"))
    with pytest.raises(SystemExit):
        instr.main(["pretrain", "--out", "o"])
    assert (calls["pretrain"]["adj_dtype"],
            calls["pretrain"]["jacobi_v_dtype"]) == ("float32", "float32")
    from gcc_tpu_torch.instruments.pretrain import recipe

    rcfg, _ = recipe(1, 0, BF16, BF16)
    assert (rcfg.encoder.adj_dtype, rcfg.encoder.jacobi_v_dtype) == (BF16,
                                                                   BF16)


def test_the_port_reads_neither_variable():
    """The levers are options only: no module of the port reads
    GCC_TPU_ADJ_DTYPE or GCC_TPU_JACOBI_V_DTYPE from the environment."""
    import re

    import gcc_tpu_torch

    root = os.path.dirname(gcc_tpu_torch.__file__)
    reads = re.compile(r"(environ|getenv)[^\n]*(ADJ_DTYPE|JACOBI_V_DTYPE)")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    assert not reads.search(f.read()), name
