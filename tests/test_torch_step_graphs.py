"""The train step's CUDA graphs (``models/step_graphs.py``) and the clip's
foreach form (``training/optim.py``).

On the CPU: the clip bit for bit against the per-leaf form it replaced;
the graph path's selection (it stays eager off the card, under a
data-parallel context, in generation and in finetune, and the counters
say so); a deep copy's empty cache; the cache emptied when a parameter
moves or is replaced; ``run_pretrain``'s epoch log.

Marked ``cuda`` (skipped without a card): K = 8 graphed steps against 8
eager steps from one deep-copied state — routed MoCo at buckets 128 and
256, the padded pairs wire, E2E with and without the size split, GAT and
MPNN — bit for bit in losses, parameters, gradients, BatchNorm buffers,
Adam's moments, the queue and the dropout generator; the hooks the
benchmark's check relies on fire alike; a deep copy of a graphed state
trains on alike. On a machine with an H100:

    python -m pytest tests/test_torch_step_graphs.py -q --noconftest
"""

import copy

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gcc_tpu_torch.config import (
    ContrastConfig,
    EncoderConfig,
    OptimConfig,
    SamplerConfig,
    TrainConfig,
)
from gcc_tpu_torch.features.featurize import BatchFeatures
from gcc_tpu_torch.generate import generate_embeddings
from gcc_tpu_torch.graph.batch import Subgraph, WireBatch, batch_subgraphs
from gcc_tpu_torch.graph.corpus import synthetic_corpus
from gcc_tpu_torch.models import step_graphs
from gcc_tpu_torch.parallel import data_parallel
from gcc_tpu_torch.sampling.pipeline import PipelineConfig
from gcc_tpu_torch.training import finetune
from gcc_tpu_torch.training.loop import run_pretrain
from gcc_tpu_torch.training.optim import clip_gradients_
from gcc_tpu_torch.training.pretrain import (
    create_pretrain_state,
    e2e_split_step,
    featurize_pair,
    train_step,
)

torch.set_num_threads(1)


def tiny_cfg(moco=True, model="gin", batch=8, hidden=16, pos=8):
    return TrainConfig(
        batch_size=batch, epochs=1, num_samples=64, num_workers=0,
        sampler=SamplerConfig(rw_hops=16),
        encoder=EncoderConfig(model=model, hidden_size=hidden,
                              output_size=hidden,
                              positional_embedding_size=pos,
                              degree_embedding_size=4, pe_method="eigh"),
        contrast=ContrastConfig(moco=moco, nce_k=64),
        optim=OptimConfig(learning_rate=0.01),
    )


def random_feats(gen, b, n, pos, device="cpu"):
    """B random symmetric graphs of n/4 to n real nodes at bucket n: the
    encoder's inputs, whatever made them."""
    n_nodes = torch.randint(max(2, n // 4), n + 1, (b,), generator=gen)
    iota = torch.arange(n)
    mask = (iota[None] < n_nodes[:, None]).to(torch.float32)
    a = (torch.rand(b, n, n, generator=gen) < 8.0 / n).to(torch.float32)
    a = a.triu(1)
    adj = (a + a.transpose(1, 2)) * mask[:, :, None] * mask[:, None, :]
    seed = torch.randint(0, 1 << 20, (b,), generator=gen) % n_nodes
    feats = BatchFeatures(
        pos=torch.randn(b, n, pos, generator=gen) * mask[..., None],
        degrees=adj.sum(2).to(torch.int32),
        seed_flag=(iota[None] == seed[:, None]).to(torch.float32),
        node_mask=mask, adj=adj)
    return feats.map(lambda x: x.to(device))


def count_delta(before):
    now = step_graphs.counts.snapshot()
    return {k: now[k] - before[k] for k in now}


# ---- the clip --------------------------------------------------------------


@pytest.mark.parametrize("scale,clip,below", [
    (1e-3, 1.0, True), (5e-3, 1.0, True), (0.05, 1.0, False),
    (1e3, 1.0, False), (1e-3, 0.25, True), (0.05, 0.25, False)])
def test_clip_matches_the_per_leaf_form(scale, clip, below):
    """Two foreach ops give the per-leaf where(keep, g, g / norm * clip)
    bit for bit, below and above clip_norm."""
    gen = torch.Generator().manual_seed(int(scale * 1000) + int(clip * 8))
    params = [torch.nn.Parameter(torch.zeros(s))
              for s in [(16, 49), (16,), (513, 16), (64, 64), (1,)]]
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen) * scale
    grads = [p.grad.clone() for p in params]
    norm = clip_gradients_(params, OptimConfig(clip_norm=clip))
    want_norm = torch.linalg.vector_norm(
        torch.cat([g.reshape(-1) for g in grads]))
    assert torch.equal(norm, want_norm)
    assert bool(norm < clip) == below
    keep = norm < clip
    for p, g in zip(params, grads):
        assert torch.equal(p.grad, torch.where(keep, g, g / norm * clip))


# ---- selection on the CPU --------------------------------------------------


@pytest.fixture
def on_card(monkeypatch):
    """Every tensor reads as on the card: the selection's other rules
    decide alone (a capture would fail here, so none may start)."""
    monkeypatch.setattr(step_graphs, "_on_card", lambda t: True)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def moco_step(state, gen, n=16):
    b = state.cfg.batch_size
    pos = state.cfg.encoder.positional_embedding_size
    return train_step(state, random_feats(gen, b, n, pos),
                      random_feats(gen, b, n, pos))


def test_step_on_the_cpu_is_eager():
    """Off the card a step is eager: two calls counted, no key kept."""
    state = create_pretrain_state(tiny_cfg(), 10, device="cpu")
    before = step_graphs.counts.snapshot()
    moco_step(state, torch.Generator().manual_seed(0))
    assert count_delta(before) == {"replays": 0, "captures": 0, "eager": 2}
    assert state.model.step_graphs.entries == {}
    assert state.ema_model.step_graphs.entries == {}


def test_step_selects_the_graphs_on_the_card(on_card):
    """Where the tensors are on the card, a step's first call of each key
    runs eagerly and marks the key for capture: one key per encoder, the
    key encoder's without a gradient."""
    state = create_pretrain_state(tiny_cfg(), 10, device="cpu")
    before = step_graphs.counts.snapshot()
    moco_step(state, torch.Generator().manual_seed(0))
    assert count_delta(before) == {"replays": 0, "captures": 0, "eager": 2}
    (q_key,) = state.model.step_graphs.entries
    (k_key,) = state.ema_model.step_graphs.entries
    assert q_key[0] == k_key[0] == 0 and q_key[1] and k_key[1]
    assert all(q_key[2]) and len(q_key[2]) == 51 and k_key[2] == ()


def test_e2e_calls_take_one_key_each(on_card):
    """E2E's split step: 2·n_cls calls of one module, each its own key
    (position 0-3), so no two calls of a step share a graph."""
    cfg = tiny_cfg(moco=False)
    state = create_pretrain_state(cfg, 10, device="cpu")
    gen = torch.Generator().manual_seed(1)
    e2e_split_step(state, (random_feats(gen, 12, 8, 8),
                           random_feats(gen, 4, 16, 8)))
    keys = sorted(state.model.step_graphs.entries)
    assert [k[0] for k in keys] == [0, 1, 2, 3]
    assert [k[3][4][0] for k in keys] == [(6, 8, 8), (2, 16, 16),
                                          (6, 8, 8), (2, 16, 16)]


def test_data_parallel_step_is_eager(on_card, world_of_one):
    """Inside a data-parallel step (collectives in BatchNorm and dropout)
    the calls stay eager and keep no key."""
    state = create_pretrain_state(tiny_cfg(), 10, device="cpu")
    before = step_graphs.counts.snapshot()
    with data_parallel.data_parallel():
        moco_step(state, torch.Generator().manual_seed(2))
    assert count_delta(before) == {"replays": 0, "captures": 0, "eager": 2}
    assert state.model.step_graphs.entries == {}


def ring_subgraphs(rng, count, n_max):
    subs = []
    for _ in range(count):
        n = int(rng.integers(4, n_max + 1))
        src = np.arange(n, dtype=np.int32)
        dst = np.roll(src, 1)
        subs.append(Subgraph(src=np.r_[src, dst], dst=np.r_[dst, src],
                             num_nodes=n, seed=int(rng.integers(0, n))))
    return subs


def test_generation_is_eager(on_card):
    """Generation calls the encoder outside any train step: eager."""
    cfg = tiny_cfg()
    state = create_pretrain_state(cfg, 10, device="cpu")
    subs = ring_subgraphs(np.random.default_rng(3), 6, 12)
    before = step_graphs.counts.snapshot()
    emb = generate_embeddings(cfg, state.model, subs, n_max=16, e_max=64,
                              batch_size=4, device="cpu")
    assert emb.shape == (6, 16)
    delta = count_delta(before)
    assert delta["replays"] == delta["captures"] == 0 and delta["eager"] > 0


def test_finetune_step_is_eager(on_card):
    """Finetune's step (value clip) never enters the step context."""
    cfg = tiny_cfg()
    state = finetune.create_finetune_state(cfg, 3, 10, device="cpu")
    batch = batch_subgraphs(ring_subgraphs(np.random.default_rng(4), 8, 12),
                            n_max=16, e_max=64)
    before = step_graphs.counts.snapshot()
    for _ in range(2):
        finetune.finetune_step(state, batch, torch.zeros(8, dtype=torch.long),
                               torch.ones(8))
    assert count_delta(before) == {"replays": 0, "captures": 0, "eager": 2}
    assert state.model.step_graphs.entries == {}


# ---- the cache -------------------------------------------------------------


def test_deepcopy_starts_an_empty_cache(on_card):
    """A deep copy of a state whose encoders hold keys gets empty caches
    of its own; the original keeps its keys."""
    state = create_pretrain_state(tiny_cfg(), 10, device="cpu")
    moco_step(state, torch.Generator().manual_seed(5))
    clone = copy.deepcopy(state)
    for orig, new in ((state.model, clone.model),
                      (state.ema_model, clone.ema_model)):
        assert len(orig.step_graphs.entries) == 1
        assert new.step_graphs is not orig.step_graphs
        assert new.step_graphs.entries == {} and new.step_graphs.tensors == []


def test_moved_or_replaced_parameters_empty_the_cache(on_card):
    """A parameter whose storage moved (``.to()``), or one replaced by a
    new Parameter, empties the module's cache at its next call."""
    state = create_pretrain_state(tiny_cfg(), 10, device="cpu")
    model, graphs = state.model, state.model.step_graphs
    gen = torch.Generator().manual_seed(6)
    moco_step(state, gen)
    graphs._validate(model)
    assert len(graphs.entries) == 1
    model.to(torch.float64).to(torch.float32)
    graphs._validate(model)
    assert graphs.entries == {}
    with step_graphs.stepping():
        model(random_feats(gen, 8, 16, 8), gen=state.dropout_gen)
    assert len(graphs.entries) == 1
    old = model.gnn.readouts[0].weight
    model.gnn.readouts[0].weight = torch.nn.Parameter(old.detach().clone())
    graphs._validate(model)
    assert graphs.entries == {}
    assert any(t is model.gnn.readouts[0].weight for t in graphs.tensors)


def test_epoch_log_counts_the_step_graphs(tmp_path):
    """run_pretrain's epoch log carries the counters: on the CPU every
    encoder call eager, none replayed."""
    corpus = str(tmp_path / "corpus")
    synthetic_corpus(corpus, num_graphs=2, nodes_per_graph=300, avg_degree=6)
    lines = []
    run_pretrain(tiny_cfg(), corpus, str(tmp_path / "out"),
                 PipelineConfig(batch_size=8, n_max=32, e_max=512,
                                num_samples=64, num_workers=0),
                 log_fn=lines.append, steps_per_call=4, device="cpu")
    (epoch,) = [x for x in lines if x.startswith("epoch 1 done")]
    assert ("step graphs 0 replays (0.0% of encoder calls), 0 captures, "
            "16 eager" in epoch)


# ---- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def padded_wire(rng, b, n_max, e_max):
    """A padded WireBatch of random symmetric graphs of 8 to n_max nodes."""
    src = np.zeros((b, e_max), np.int16)
    dst = np.zeros((b, e_max), np.int16)
    n_nodes = rng.integers(8, n_max + 1, b).astype(np.int32)
    n_edges = np.zeros(b, np.int32)
    for i, n in enumerate(n_nodes):
        m = min(e_max // 2, 3 * int(n))
        s, d = rng.integers(0, n, m), rng.integers(0, n, m)
        src[i, :2 * m] = np.r_[s, d]
        dst[i, :2 * m] = np.r_[d, s]
        n_edges[i] = 2 * m
    return WireBatch(src=src, dst=dst, n_nodes=n_nodes, n_edges=n_edges,
                     seed_pos=(rng.integers(0, 1 << 20, b) % n_nodes)
                     .astype(np.int32))


def card_case(name, device):
    """(config, K = 8 step inputs, step function) of one case."""
    gen = torch.Generator().manual_seed(11)
    moco_cfg = tiny_cfg(batch=32, hidden=64, pos=32)
    if name in ("moco-routed", "gat", "mpnn"):
        buckets = ([128, 128, 256, 128, 256, 256, 128, 256]
                   if name == "moco-routed" else [128] * 8)
        cfg = (moco_cfg if name == "moco-routed" else tiny_cfg(
            model=name, batch=32, hidden=64, pos=32))
        steps = [(random_feats(gen, 32, n, 32, device),
                  random_feats(gen, 32, n, 32, device)) for n in buckets]
        return cfg, steps, train_step
    if name == "padded-pair":
        rng = np.random.default_rng(12)
        steps = []
        for _ in range(8):
            fq, fk = featurize_pair(padded_wire(rng, 32, 128, 1024),
                                    padded_wire(rng, 32, 128, 1024), 32,
                                    n_max=128, device="cpu",
                                    pe_method="eigh")
            steps.append((fq.map(lambda x: x.to(device)),
                          fk.map(lambda x: x.to(device))))
        return moco_cfg, steps, train_step
    e2e_cfg = tiny_cfg(moco=False, batch=32, hidden=64, pos=32)
    if name == "e2e":
        return e2e_cfg, [(random_feats(gen, 32, 128, 32, device),
                          random_feats(gen, 32, 128, 32, device))
                         for _ in range(8)], train_step
    # The size split: 24 pairs at bucket 128, 8 at 256; each class's
    # features hold its query views, then its key views.
    return e2e_cfg, [((random_feats(gen, 48, 128, 32, device),
                       random_feats(gen, 16, 256, 32, device)),)
                     for _ in range(8)], e2e_split_step


def snapshot(state):
    """Everything a step changes, as tensors (and the generator's state)."""
    out = {"queue": state.queue.memory, "index": state.queue.index,
           "nce_z": state.nce_z, "gen": state.dropout_gen.get_state()}
    names = {}
    for tag, m in (("q", state.model), ("k", state.ema_model)):
        for n, t in m.state_dict().items():
            out[f"{tag}.{n}"] = t
        for n, p in m.named_parameters():
            names[id(p)] = f"{tag}.{n}"
            if p.grad is not None:
                out[f"{tag}.{n}.grad"] = p.grad
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            out[f"adam.{names[id(p)]}.{k}"] = v
    return {k: v.detach().clone() for k, v in out.items()}


def assert_same(a, b):
    assert a.keys() == b.keys()
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    assert not bad, bad


class Watch:
    """The benchmark check's hooks: forward pre-hooks on both encoders
    (the features object each call gets) and optimizer step hooks."""

    def __init__(self, state):
        self.calls, self.steps = [], [0, 0]
        self.hooks = [
            state.model.register_forward_pre_hook(
                lambda m, a: self.calls.append(("q", a[0]))),
            state.ema_model.register_forward_pre_hook(
                lambda m, a: self.calls.append(("k", a[0]))),
            state.optimizer.register_step_pre_hook(self._pre),
            state.optimizer.register_step_post_hook(self._post)]

    def _pre(self, opt, args, kwargs):
        self.steps[0] += 1

    def _post(self, opt, args, kwargs):
        self.steps[1] += 1

    def remove(self):
        for h in self.hooks:
            h.remove()


def run_steps(state, steps, step_fn):
    watch = Watch(state)
    metrics = [step_fn(state, *s) for s in steps]
    watch.remove()
    torch.cuda.synchronize()
    return ({k: torch.stack([m[k] for m in metrics]) for k in metrics[0]},
            watch)


def expected_calls(state, steps):
    """The (tag, features object, adjacency address) of every encoder
    call, in order; the split step slices its classes into new objects,
    so only their addresses are known."""
    want = []
    for s in steps:
        if not isinstance(s[0], BatchFeatures):
            for view in (0, 1):
                for f in s[0]:
                    c = f.adj.shape[0] // 2
                    want.append(("q", None, f.adj[view * c].data_ptr()))
        elif state.cfg.contrast.moco:
            want += [("k", s[1], s[1].adj.data_ptr()),
                     ("q", s[0], s[0].adj.data_ptr())]
        else:
            want += [("q", f, f.adj.data_ptr()) for f in s]
    return want


def hooks_saw(watch, want):
    return len(watch.calls) == len(want) and all(
        tag == t and (obj is None or f is obj) and f.adj.data_ptr() == ptr
        for (tag, f), (t, obj, ptr) in zip(watch.calls, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["moco-routed", "padded-pair", "e2e",
                                  "e2e-split", "gat", "mpnn"])
def test_graphed_steps_match_eager_steps(name, cuda_device, monkeypatch):
    """K = 8 steps replayed from graphs against 8 eager steps from one
    deep-copied state: equal bit for bit; the hooks see the same calls
    with the step's own features objects; a deep copy of the graphed
    state, with its empty cache, trains on bit for bit too."""
    cfg, steps, step_fn = card_case(name, cuda_device)
    state = create_pretrain_state(cfg, 1000, seed=3, device=cuda_device)
    eager_state = copy.deepcopy(state)

    before = step_graphs.counts.snapshot()
    got, watch = run_steps(state, steps, step_fn)
    delta = count_delta(before)
    with monkeypatch.context() as m:
        m.setattr(step_graphs, "_on_card", lambda t: False)
        want, eager_watch = run_steps(eager_state, steps, step_fn)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert_same(snapshot(state), snapshot(eager_state))

    calls = expected_calls(state, steps)
    for w in (watch, eager_watch):
        assert w.steps == [8, 8] and hooks_saw(w, calls)
    keys = (len(state.model.step_graphs.entries)
            + len(state.ema_model.step_graphs.entries))
    assert delta == {"replays": len(calls) - keys, "captures": keys,
                     "eager": keys}

    graphed_copy = copy.deepcopy(state)
    assert graphed_copy.model.step_graphs.entries == {}
    eager_copy = copy.deepcopy(eager_state)
    more = steps[:4]
    got_a, _ = run_steps(state, more, step_fn)
    got_c, _ = run_steps(graphed_copy, more, step_fn)
    with monkeypatch.context() as m:
        m.setattr(step_graphs, "_on_card", lambda t: False)
        want, _ = run_steps(eager_copy, more, step_fn)
    for k in want:
        assert torch.equal(got_a[k], want[k]), k
        assert torch.equal(got_c[k], want[k]), k
    assert_same(snapshot(state), snapshot(eager_copy))
    assert_same(snapshot(graphed_copy), snapshot(eager_copy))


@pytest.mark.cuda
def test_replays_draw_fresh_dropout_masks(cuda_device):
    """Two replays of one key on the same inputs give different
    embeddings (new dropout masks), and the generator advances."""
    cfg = tiny_cfg(batch=32, hidden=64, pos=32)
    state = create_pretrain_state(cfg, 1000, seed=4, device=cuda_device)
    feats = random_feats(torch.Generator().manual_seed(13), 32, 128, 32,
                         cuda_device)
    outs = []
    state.ema_model.train()
    with torch.no_grad():
        for _ in range(4):
            with step_graphs.stepping():
                g0 = state.dropout_gen.get_state()
                outs.append(state.ema_model(feats, gen=state.dropout_gen)
                            .clone())
                assert not torch.equal(g0, state.dropout_gen.get_state())
    assert len(state.ema_model.step_graphs.entries) == 1
    assert not torch.equal(outs[2], outs[3])
    assert not torch.equal(outs[1], outs[2])
