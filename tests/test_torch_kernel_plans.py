"""Launch plans and input checks of the port's Kernel 2 (PE subspace
iteration) and Kernel 3 (Jacobi), which need no card: the pure-Python
mirrors of the plans in ``csrc/pe.cu`` and ``csrc/jacobi.cu`` stay
inside what one Hopper block may use for every shape the wrappers take,
and the wrappers raise, with the numbers, on what they do not take."""

import pytest
import torch

from gcc_tpu_torch.ops import jacobi, pe

MAX_SMEM = 232_448      # bytes of shared memory a block may use on Hopper
MAX_THREADS = 1024


@pytest.mark.parametrize("k", [8, 16, 32, 48])
@pytest.mark.parametrize("n", [32, 64, 96, 128, 192, 256])
def test_pe_plan_fits_a_block(n, k):
    plan = pe.pe_launch_plan(n, k)
    assert 0 < plan["smem_bytes"] <= MAX_SMEM
    assert plan["threads"] == 2 * n <= MAX_THREADS
    assert plan["threads"] == 32 * plan["warps"]
    assert plan["kp"] in (16, 32, 48) and 0 <= plan["kp"] - k < 16
    assert plan["variant"].startswith("mma.sync m16n8k16")
    assert plan["plan"] == "shared" and plan["scratch_bytes"] == 0
    assert plan["cluster"] == 1 and plan["block_slabs"] == [n // 16]
    # The tensor-core Gram splits its depth into whole steps of 16
    # columns; 1, 2 or 4 lanes share a tile of the f32 Gram.
    assert plan["warps"] % plan["gram_split"] == 0
    assert plan["gram_f32_split"] in (1, 2, 4)
    # The bf16 copy of M (rows padded by 8) fits inside the plan.
    assert plan["smem_bytes"] >= n * (n + 8) * 2


@pytest.mark.parametrize("k", [8, 16, 32, 48])
@pytest.mark.parametrize("n", [288, 320, 352, 512, 800, 832])
def test_pe_streamed_plan_fits_a_block(n, k):
    """Above N = 256 M's bf16 copy no longer fits shared memory: the
    streamed plan keeps it in a device scratch and splits a graph's
    columns of Qᵀ, in slabs of 16, over a cluster of blocks."""
    plan = pe.pe_launch_plan(n, k)
    assert plan["plan"] == "streamed" and plan["n_pad"] == n
    assert plan["threads"] == 32 * plan["warps"] <= MAX_THREADS
    assert 0 < plan["smem_bytes"] <= MAX_SMEM
    assert plan["kp"] in (16, 32, 48) and 0 <= plan["kp"] - k < 16
    # 2 blocks per graph up to N = 512 (64 graphs are 128 blocks on 132
    # SMs), 4 above.
    assert plan["cluster"] == (2 if n <= 512 else 4)
    # The split may be ragged: ceil(slabs / cluster) a block, the last
    # takes what is left; one warp a slab, so at most 16 a block; no slab
    # beyond the cluster.
    slabs = plan["block_slabs"]
    assert len(slabs) == plan["cluster"] and sum(slabs) == n // 16
    assert max(slabs) == plan["slabs_per_block"] <= plan["warps"]
    assert all(s == plan["slabs_per_block"] for s in slabs[:-1])
    assert 0 < slabs[-1] <= plan["slabs_per_block"]
    # Shared memory holds both bf16 copies of Q^T (rows padded by 8) and
    # a ring of four 512-byte tiles of M per warp; the scratch is the
    # bf16 copy of M and nothing else (Q^T never leaves the chip).
    assert plan["smem_bytes"] >= 2 * plan["kp"] * (n + 8) * 2 + 16 * 4 * 512
    assert plan["scratch_bytes"] == n * n * 2


@pytest.mark.parametrize("k", [49, 64, 65, 80])
@pytest.mark.parametrize("n", [32, 128, 160, 256, 288, 512, 832])
def test_pe_wide_plan_fits_a_block(n, k):
    """48 < k <= 80 (PE 64 on the train and eval profiles) takes the wide
    plan at every N: one block per graph up to N = 256 and a cluster of
    two above, G in shared memory, four f32 copies of Q (n, kp) in a
    device scratch."""
    plan = pe.pe_launch_plan(n, k)
    assert plan["plan"] == "wide" and plan["n_pad"] == n
    assert plan["kp"] in (64, 80) and 0 <= plan["kp"] - k < 16
    assert plan["threads"] == (256 if n <= 256 else 512)
    assert plan["threads"] == 32 * plan["warps"] <= MAX_THREADS
    assert plan["kp"] ** 2 * 4 < plan["smem_bytes"] <= 48 * 1024
    assert plan["cluster"] == (1 if n <= 256 else 2)
    assert len(plan["block_slabs"]) == plan["cluster"]
    assert plan["scratch_bytes"] == 4 * n * plan["kp"] * 4


@pytest.mark.parametrize("n,k,plan", [(128, 48, "shared"),
                                      (128, 64, "wide"), (256, 80, "wide"),
                                      (512, 48, "streamed"),
                                      (512, 80, "wide")])
def test_pe_plan_by_width(n, k, plan):
    """The train (k = 64) and eval (k = 80) widths of PE 64 beside k =
    48's plans: the shared plan would need 232,720 B at (256, 64) and the
    streamed plan 268,800 B for its copies of Q^T alone at (832, 80)."""
    assert pe.pe_launch_plan(n, k)["plan"] == plan


@pytest.mark.parametrize("n,slabs", [(544, [9, 9, 9, 7]),
                                     (800, [13, 13, 13, 11]),
                                     (832, [13, 13, 13, 13]),
                                     (352, [11, 11]), (288, [9, 9])])
def test_pe_streamed_plan_ragged_split(n, slabs):
    assert pe.pe_launch_plan(n, 48)["block_slabs"] == slabs


def test_pe_plan_ends_where_the_reference_kernel_does():
    """832 is the largest multiple of 32 with N*N*6 <= 4 MiB; 864 raises
    with the numbers."""
    assert 832 * 832 * 6 <= (4 << 20) < 864 * 864 * 6
    assert pe.pe_launch_plan(801, 48)["n_pad"] == 832
    with pytest.raises(ValueError, match="N=864, k=48"):
        pe.pe_launch_plan(864, 48)


@pytest.mark.parametrize("n,n_pad", [(1, 32), (31, 32), (100, 128),
                                     (129, 160), (250, 256)])
def test_pe_plan_pads_the_node_axis(n, n_pad):
    plan = pe.pe_launch_plan(n, 32)
    assert plan["n_pad"] == n_pad and plan["threads"] == 2 * n_pad


@pytest.mark.parametrize("n,k", [(833, 32), (864, 48), (128, 81),
                                 (832, 96), (128, 0)])
def test_pe_plan_refuses_with_the_numbers(n, k):
    with pytest.raises(ValueError, match=f"N={n}, k={k}"):
        pe.pe_launch_plan(n, k)


@pytest.mark.parametrize("n", list(range(4, 50, 2)) + [56, 64, 80, 118])
def test_jacobi_plan_fits_a_block(n):
    plan = jacobi.jacobi_launch_plan(n, batch=4097)
    assert 0 < plan["smem_bytes"] <= MAX_SMEM
    assert 0 < plan["threads"] <= MAX_THREADS and plan["threads"] % 32 == 0
    if n == 32:
        assert plan["variant"].startswith("warp-per-matrix")
        assert plan["blocks"] * (plan["threads"] // 32) >= 4097
        assert plan["smem_bytes"] <= 48 * 1024     # static shared memory
    elif n == 48:
        assert plan["variant"].startswith("thread-per-2x2-block")
        assert plan["blocks"] == 4097
        assert plan["smem_bytes"] <= 48 * 1024     # static shared memory
    else:
        assert plan["variant"].startswith("block-per-matrix")
        assert plan["blocks"] == 4097


@pytest.mark.parametrize("batch", [1, 3, 64, 128, 2777, 4096])
def test_jacobi_pair_plan(batch):
    """n = 48: one block per matrix, one thread per 2x2 block of A (24 x 24
    of them), whatever the batch."""
    plan = jacobi.jacobi_launch_plan(48, batch)
    assert plan["variant"].startswith("thread-per-2x2-block")
    assert plan["threads"] == 576 and plan["blocks"] == batch
    # A and V^T double-buffered, rows padded to 56 floats.
    assert plan["smem_bytes"] >= 4 * 48 * 56 * 4


@pytest.mark.parametrize("n", [3, 5, 33, 120, 65, 2, 0])
def test_jacobi_plan_refuses_with_the_number(n):
    with pytest.raises(ValueError, match=str(n)):
        jacobi.jacobi_launch_plan(n)


# The wrappers run these checks on every CUDA tensor before they launch
# (a CPU tensor goes to the plain version, which takes any shape).

def _pe_args(b=2, n=64, k=16, dtype=torch.float32):
    return torch.zeros(b, n, n, dtype=dtype), torch.zeros(b, n, k, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16,
                                   torch.bfloat16])
def test_pe_wrapper_refuses_dtype(dtype):
    m, q0 = _pe_args(dtype=dtype)
    with pytest.raises(TypeError, match=str(dtype)):
        pe._check_inputs(m, q0, 4, 4, 2, 8)
    with pytest.raises(TypeError, match="float32"):
        pe._check_inputs(m.float(), q0, 4, 4, 2, 8)


@pytest.mark.parametrize("m_shape,q_shape", [
    ((2, 64, 64), (3, 64, 16)),     # batch
    ((2, 64, 32), (2, 64, 16)),     # M not square
    ((2, 32, 32), (2, 64, 16)),     # node axes differ
    ((64, 64), (64, 16)),           # no batch axis
])
def test_pe_wrapper_refuses_shapes(m_shape, q_shape):
    with pytest.raises(ValueError, match=str(m_shape[-1])):
        pe._check_inputs(torch.zeros(m_shape), torch.zeros(q_shape),
                         4, 4, 2, 8)


@pytest.mark.parametrize("n,k", [(864, 32), (64, 81)])
def test_pe_wrapper_refuses_sizes(n, k):
    with pytest.raises(ValueError, match=f"N={n}, k={k}"):
        pe._check_inputs(*_pe_args(n=n, k=k), 4, 4, 2, 8)


@pytest.mark.parametrize("sched", [(0, 4, 2, 8), (4, -1, 2, 8),
                                   (4, 4, -1, 8), (4, 4, 2, -1)])
def test_pe_wrapper_refuses_schedules(sched):
    with pytest.raises(ValueError, match="orth_every"):
        pe._check_inputs(*_pe_args(), *sched)


def test_pe_wrapper_accepts_what_the_plan_takes():
    plan = pe._check_inputs(*_pe_args(n=100, k=20), 4, 4, 2, 8)
    assert plan == pe.pe_launch_plan(100, 20)


@pytest.mark.parametrize("shape,exc", [
    ((2, 7, 7), ValueError),        # odd n
    ((2, 120, 120), ValueError),    # n > 118
    ((2, 2, 2), ValueError),        # n < 4
    ((2, 32, 16), ValueError),      # not square
    ((32, 32), ValueError),         # no batch axis
])
def test_jacobi_wrapper_refuses_shapes(shape, exc):
    with pytest.raises(exc, match=str(shape[-2])):
        jacobi._check_input(torch.zeros(shape))


def test_jacobi_wrapper_refuses_dtype():
    with pytest.raises(TypeError, match="float64"):
        jacobi._check_input(torch.zeros(2, 32, 32, dtype=torch.float64))
    jacobi._check_input(torch.zeros(2, 32, 32))
    jacobi._check_input(torch.zeros(2, 48, 48))
