"""Kernel 1's launch plan and input checks, which need no card: the
pure-Python mirror ``featurize_launch_plan`` stays inside what one Hopper
block and cluster may use for every width the wrapper takes, takes the
band path (each edge counted once a graph) at the training widths, holds
the constants of ``csrc/featurize.cu``, and the wrapper raises, with the
numbers, on what no path takes. The plain version's degrees come from the
stored entries in f32 as in bf16, held to the reference's chain."""

import os
import re

import numpy as np
import pytest
import torch

from featurize_wires import heavy_wire, pair_wire_256
from gcc_tpu_torch.ops import aggregate
from gcc_tpu_torch.ops.aggregate import featurize_launch_plan

MAX_SMEM = 232_448      # bytes of shared memory a Hopper block may use
MAX_THREADS = 1024
MAX_CLUSTER = 8         # the portable cluster size
SOURCE = os.path.join(os.path.dirname(aggregate.__file__), os.pardir,
                      "csrc", "featurize.cu")
DTYPES = ("float32", "bfloat16")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e_tot", [6656, 26624, 65536])
@pytest.mark.parametrize("n", [16, 100, 128, 240, 256, 300, 512, 2048])
def test_plan_fits_a_block_and_cluster(n, e_tot, dtype):
    plan = featurize_launch_plan(n, e_tot, dtype)
    assert 0 < plan["smem_bytes"] <= MAX_SMEM
    assert 1 <= plan["cluster"] <= MAX_CLUSTER
    gx, gy = plan["block"]
    assert 32 <= plan["threads"] == gx * gy <= MAX_THREADS
    # One column group of 8 a thread, covering the padded row.
    assert gx * 8 >= n > (gx - 1) * 8
    assert plan["rows"] * plan["blocks_per_graph"] >= n
    if plan["path"] == "band":
        assert plan["blocks_per_graph"] == plan["cluster"]
        assert plan["launches"] == 1 and plan["count_bits"] == 16
        assert plan["scratch_bytes"] == 0
        # The counts of the band, two bytes each, fit beside inv[].
        assert plan["smem_bytes"] >= plan["rows"] * n * 2 + 4 * n
    else:
        assert plan["cluster"] == 1 and plan["launches"] == 2
        assert plan["count_bits"] == 32 and plan["scratch_bytes"] == 4 * n
        assert plan["smem_bytes"] <= 48 * 1024


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,cluster,rows", [(128, 1, 128), (240, 2, 120),
                                            (256, 2, 128), (100, 1, 100)])
def test_plan_takes_the_band_path_at_training_widths(n, cluster, rows,
                                                     dtype):
    """The routed buckets (e_tot 6656 and 26624 in the sampled wire) and
    the ragged widths: every edge counted once a graph, one launch, 16-
    byte stores where the row is 16-byte aligned."""
    for e_tot in (6656, 26624, 65535):
        plan = featurize_launch_plan(n, e_tot, dtype)
        assert (plan["path"], plan["cluster"], plan["rows"]) == \
            ("band", cluster, rows)
    size = 2 if dtype == "bfloat16" else 4
    want = 16 if n * size % 16 == 0 else 8
    assert featurize_launch_plan(n, 6656, dtype)["store_bytes"] == want


@pytest.mark.parametrize("n,f32,bf16", [(128, 16, 16), (100, 16, 8),
                                        (30, 8, 4), (17, 4, 2), (250, 8, 4)])
def test_plan_store_widths(n, f32, bf16):
    """The widest store every row's start allows: 16 bytes, else 8, 4,
    else one value."""
    assert featurize_launch_plan(n, 64, "float32")["store_bytes"] == f32
    assert featurize_launch_plan(n, 64, "bfloat16")["store_bytes"] == bf16


@pytest.mark.parametrize("n,e_tot", [(300, 1024), (512, 1024), (2048, 0),
                                     (128, 65536), (256, 1 << 20)])
def test_plan_takes_the_tile_path_beyond_the_band(n, e_tot):
    """Beyond N = 256, or where a count could pass 16 bits."""
    plan = featurize_launch_plan(n, e_tot)
    assert plan["path"] == "tile" and plan["launches"] == 2
    assert plan["rows"] == max(1, 8192 // (-(-n // 8) * 8))


@pytest.mark.parametrize("n,cluster,ok", [(256, 1, True), (256, 4, True),
                                          (128, 8, True), (4, 8, False),
                                          (256, 9, False), (512, 2, False)])
def test_plan_takes_forced_clusters(n, cluster, ok):
    if ok:
        plan = featurize_launch_plan(n, 1024, "bfloat16", cluster)
        assert plan["cluster"] == cluster
        assert plan["rows"] == -(-n // cluster)
    else:
        with pytest.raises(ValueError, match=f"cluster={cluster}|"
                           f"no cluster, got {cluster}"):
            featurize_launch_plan(n, 1024, "bfloat16", cluster)


def _source_constants():
    with open(SOURCE) as f:
        src = f.read()
    return {name: int(val.replace("'", "")) for name, val in re.findall(
        r"constexpr int (k\w+) = ([0-9']+);", src)}, src


def test_plan_mirrors_the_source():
    """The constants ``featurize_launch_plan`` reads are those of
    ``csrc/featurize.cu``'s make_plan, and the source says what the plan
    says: each edge once a graph, one rsqrt a node, no division per
    entry, 16-byte stores."""
    consts, src = _source_constants()
    assert consts["kMaxN"] == aggregate.FEATURIZE_MAX_N
    assert consts["kBandMaxN"] == aggregate.BAND_MAX_N
    assert consts["kBandRows"] == aggregate.BAND_ROWS
    assert consts["kCount16Limit"] == aggregate.COUNT16_LIMIT
    assert consts["kTileEntries"] == aggregate.TILE_ENTRIES
    assert consts["kThreads"] == aggregate.FEATURIZE_THREADS
    assert consts["kVec"] == aggregate.FEATURIZE_VEC
    assert consts["kMaxCluster"] == aggregate.FEATURIZE_MAX_CLUSTER
    assert consts["kMaxSmem"] == aggregate.MAX_SMEM
    assert consts["kBf16CountLimit"] == aggregate.BF16_COUNT_LIMIT
    # The layouts the plan's smem_bytes counts, and the store widths.
    assert "rows * round_up(n, kVec) * bytes + 4 * round_up(rows, 4)" in src
    assert "block_smem(n, p->rows, 2)" in src          # 16-bit band counts
    assert "block_smem(n, p->rows, 4)" in src          # 32-bit tile counts
    assert "(n + kBandRows - 1) / kBandRows" in src
    assert "*reinterpret_cast<uint4*>(p) =" in src            # 8 bf16
    assert "*reinterpret_cast<float4*>(p) = make_float4" in src  # 4 f32
    assert "n * value_bytes % 16 == 0 ? 16" in src
    # One rsqrt per node (two call sites: the band's owners, the tile's
    # degree launch), none in the per-row loop, and no division there.
    body = src[src.index("__device__ __forceinline__ void write_rows"):
               src.index("// ---- the band path")]
    loop = body[body.index("for (int r = threadIdx.y"):]
    assert "rsqrtf" not in loop and " / " not in loop and " % " not in loop
    assert src.count("rsqrtf(") == 2
    assert "each edge is read and counted once per graph" in src.lower()


def test_wrapper_raises_with_the_numbers():
    e = torch.zeros((2, 64), dtype=torch.int32)
    m = torch.zeros((2, 3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"n_max <= 2048.*n_max=4096"):
        featurize_launch_plan(4096, 64)
    with pytest.raises(ValueError, match=r"e_tot=-1"):
        featurize_launch_plan(128, -1)
    with pytest.raises(ValueError, match=r"\(2, 64\), \(3, 3, 4\)"):
        aggregate.fused_adjacency_featurize(e, torch.zeros((3, 3, 4),
                                            dtype=torch.int32), 16, 8)
    with pytest.raises(ValueError, match=r"\(2, 3, 64\), \(2, 3, 4\)"):
        aggregate.fused_adjacency_featurize(
            torch.zeros((2, 3, 64), dtype=torch.int32), m, 16, 8)
    with pytest.raises(ValueError, match=r"\(2, 64\), \(2, 2, 4\)"):
        aggregate.fused_adjacency_featurize(e, m[:, :2], 16, 8)
    with pytest.raises(ValueError, match="id_bits <= 16, got 17"):
        aggregate.fused_adjacency_featurize(e, m, 16, 17)
    with pytest.raises(ValueError, match="unsupported device meta"):
        aggregate._launch(e.to("meta"), m.to("meta"), 16, 8, "float32")


@pytest.mark.parametrize("wire", [heavy_wire, pair_wire_256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_degrees_are_sums_of_stored_entries(wire, dtype):
    """On both F1 wires: the plain version's degrees are the row sums of
    its stored adjacency (a bf16 entry stops at 256), rounded to bf16 in
    bf16, and m_shift is built from them."""
    edges, meta, n_max, id_bits = wire()
    adj, m_shift, deg = aggregate.fused_adjacency_featurize(
        torch.as_tensor(edges), torch.as_tensor(meta), n_max, id_bits, dtype)
    sums = adj.float().sum(dim=2)
    want = sums.to(adj.dtype).float()
    assert torch.equal(deg, want)
    if dtype == "bfloat16":
        assert adj.float().max().item() == 256.0
    else:
        assert adj.max().item() == 300.0
    inv = torch.rsqrt(torch.clamp_min(sums, 1.0))
    m = adj.float() * inv[:, :, None] * inv[:, None, :]
    off = ~torch.eye(n_max, dtype=torch.bool)
    assert torch.equal(m_shift.float()[:, off],
                       m.to(adj.dtype).float()[:, off])


def test_plain_f32_matches_reference_chain_on_heavy_wire(monkeypatch):
    """Kernel 1's plain version in f32 on the heavy wire against the
    reference's default f32 chain: adjacency and degrees exact (integer
    counts in f32, in-degrees 301, 300 and 259), m_shift within 1e-6, the
    limit ``test_torch_ops.py`` holds the f32 chain to (the same f32
    products; JAX's rsqrt and torch's differ by an ulp on 261 of the
    524,288 entries here, by at most 3.7e-9)."""
    # The reference's chain and the helper file import JAX, Flax and Optax
    # (absent beside the card, where this file's plan tests also run).
    for name in ("jax", "flax", "optax"):
        pytest.importorskip(name)
    import jax
    from test_torch_bf16_levers import _reference_chain

    monkeypatch.delenv("GCC_TPU_ADJ_DTYPE", raising=False)
    monkeypatch.delenv("GCC_TPU_FUSED_FEATURIZE", raising=False)
    jax.clear_caches()
    edges, meta, n_max, id_bits = heavy_wire()
    want_adj, want_ms, want_deg = _reference_chain(edges, meta, n_max,
                                                   id_bits)
    assert str(want_adj.dtype) == "float32"
    adj, m_shift, deg = aggregate.fused_adjacency_featurize(
        torch.as_tensor(edges), torch.as_tensor(meta), n_max, id_bits)
    np.testing.assert_array_equal(adj.numpy(), np.asarray(want_adj))
    np.testing.assert_allclose(m_shift.numpy(), np.asarray(want_ms),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(deg.numpy().astype(np.int32),
                                  np.asarray(want_deg))
    np.testing.assert_array_equal(deg.numpy()[0, :4], [301, 300, 0, 259])
    assert adj.numpy()[0, 1, 2] == 300.0
