"""Port-only tests of gcc_tpu_torch (no JAX): wire decode, the weight
bridge's round trip, device selection, and a CPU run of the K-step
MoCo dispatch on a tiny synthetic corpus."""

import math

import numpy as np
import pytest
import torch

from gcc_tpu_torch import ops, resolve_device
from gcc_tpu_torch.compat import flax_to_state_dict, state_dict_to_flax
from gcc_tpu_torch.config import (
    ContrastConfig,
    EncoderConfig,
    SamplerConfig,
    TrainConfig,
)
from gcc_tpu_torch.graph.batch import CompactWireBatch, pack_edge_ids
from gcc_tpu_torch.graph.corpus import synthetic_corpus
from gcc_tpu_torch.models import GraphEncoder
from gcc_tpu_torch.sampling.pipeline import PipelineConfig, PretrainPipeline
from gcc_tpu_torch.training import create_pretrain_state, train_dispatch
from gcc_tpu_torch.wire import wire_to_device

torch.set_num_threads(1)

SMALL = EncoderConfig(num_layers=3, hidden_size=16, output_size=16,
                      positional_embedding_size=8)


@pytest.mark.parametrize("n_max", [256, 300])
def test_wire_decode(n_max):
    """uint16 (id_bits 8) and int32 (id_bits 16) packed edges decode to
    the wire's own src/dst; meta keeps its (K, 3, B) shape and values."""
    rng = np.random.default_rng(n_max)
    src = rng.integers(0, n_max, (3, 40))
    dst = rng.integers(0, n_max, (3, 40))
    packed, id_bits = pack_edge_ids(src, dst, n_max)
    meta = rng.integers(0, 50, (3, 3, 5)).astype(np.int32)
    wire = CompactWireBatch(edges=packed, meta=meta, id_bits=id_bits)
    edges, m = wire_to_device(wire, device="cpu")
    assert edges.dtype == torch.int32 and edges.shape == (3, 40)
    mask = (1 << id_bits) - 1
    s, d = edges & mask, (edges >> id_bits) & mask
    np.testing.assert_array_equal(s.numpy(), wire.src)
    np.testing.assert_array_equal(d.numpy(), wire.dst)
    np.testing.assert_array_equal(s.numpy(), src)
    np.testing.assert_array_equal(d.numpy(), dst)
    np.testing.assert_array_equal(m.numpy(), meta)


def test_bridge_round_trip_from_torch():
    """state_dict → Flax variables → state_dict is exact."""
    model = GraphEncoder(SMALL)
    model.reset_parameters(torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.uniform_(0.5, 1.5)
    sd = model.state_dict()
    back = flax_to_state_dict(*state_dict_to_flax(sd))
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_cuda_request_without_card_raises():
    """Entry points default to the card and never fall back silently."""
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_pretrain_state(TrainConfig(), total_steps=10)


def test_cpu_dispatch_trains(tmp_path):
    """Routed K-step dispatches on the CPU (the kernels' plain versions):
    finite losses, the queue pointer advances by K·B per dispatch, and
    no kernel launch is counted."""
    store = synthetic_corpus(str(tmp_path), num_graphs=2,
                             nodes_per_graph=2000, avg_degree=6, seed=0)
    cfg = TrainConfig(batch_size=4, sampler=SamplerConfig(rw_hops=16),
                      encoder=SMALL,
                      contrast=ContrastConfig(moco=True, nce_k=64))
    pcfg = PipelineConfig(batch_size=4, n_max=64, e_max=512, num_workers=0,
                          emit="routed", super_batch=2, n_small=32)
    ops.reset_launch_counts()
    state = create_pretrain_state(cfg, total_steps=100, device="cpu")
    with PretrainPipeline(store, cfg.sampler, pcfg, seed=0) as pipe:
        for i in range(2):
            wq, wk = next(pipe)
            assert wq.n_max in (32, 64) and wq.meta.shape == (2, 3, 4)
            metrics = train_dispatch(state, wq, wk)
            assert all(math.isfinite(x) for x in metrics["loss"].tolist())
            assert int(state.queue.index) == (i + 1) * 2 * 4
    assert state.step == 4
    assert ops.launch_counts() == {"featurize": 0, "pe": 0, "jacobi": 0}


def test_threaded_pipeline_matches_sync(tmp_path):
    """A background sampler thread yields the same stream as the
    synchronous pipeline with the thread's seed."""
    store = synthetic_corpus(str(tmp_path), num_graphs=2,
                             nodes_per_graph=1500, avg_degree=6, seed=1)
    base = dict(batch_size=4, n_max=64, e_max=512, emit="stacked",
                super_batch=2, e_tot=1024)
    cfg = SamplerConfig(rw_hops=16)
    with PretrainPipeline(store, cfg, PipelineConfig(num_workers=1, **base),
                          seed=0) as threaded:
        got = [next(threaded) for _ in range(2)]
    with PretrainPipeline(store, cfg, PipelineConfig(num_workers=0, **base),
                          seed=7919) as sync:
        want = [next(sync) for _ in range(2)]
    for (gq, gk), (wq, wk) in zip(got, want):
        for g, w in ((gq, wq), (gk, wk)):
            np.testing.assert_array_equal(g.meta, w.meta)
            np.testing.assert_array_equal(g.edges, w.edges)
