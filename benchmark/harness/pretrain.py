"""Driver of the pre-training traffic: the program's sampler pipeline
feeding ``train_dispatch`` in a closed loop.

Set-up builds one training state, loads the benchmark's weights into it,
and drives it through its first dispatch with hooks that keep what the
reference needs: each encoder call's features, the optimizer's first
moment after step 1, the weights and the enqueued keys after the checked
steps. The same state then warms the cell's other shapes (routed MoCo's
other bucket on a copy of the state) and goes on into the window. The
window submits dispatches until ``--seconds`` have passed and ends with a
synchronization. A traced run also runs one dispatch with the program's
spans on before the window and keeps their table, and after the window
profiles a stretch of the next dispatch, keeping every encoder call's
graph sizes in it. Every run keeps the window's pipeline and step-graph
counters. Last, with the program's state freed, the reference checks the
first dispatch.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import sys
import time

import numpy as np

from benchmark.counts import step as step_counts
from benchmark.harness import check, probes
from benchmark.harness.common import derived_seeds, sync
from benchmark.harness.corpus import ensure_corpus
from benchmark.harness.trace import Stretch
from benchmark.harness.weights import make_encoder_tensors, make_queue, split
from benchmark.reference.encoder import model_name


# Encoder settings that a configuration may leave out, keeping
# EncoderConfig's defaults.
OPTIONAL_ENCODER_KEYS = ("num_heads", "set2set_iter", "set2set_lstm_layer",
                         "use_selayer")


def train_config(config: dict):
    from gcc_tpu_torch.config import (ContrastConfig, EncoderConfig,
                                      OptimConfig, SamplerConfig, TrainConfig)

    enc = EncoderConfig(
        model=config["model"], num_layers=config["num_layers"],
        hidden_size=config["hidden_size"], output_size=config["output_size"],
        positional_embedding_size=config["positional_embedding_size"],
        pe_method=config["pe_method"],
        degree_embedding_size=config["degree_embedding_size"],
        max_degree=config["max_degree"], final_dropout=config["final_dropout"],
        adj_dtype=config["adj_dtype"], jacobi_v_dtype=config["jacobi_v_dtype"],
        pe_guards=config["pe_guards"],
        **{k: config[k] for k in OPTIONAL_ENCODER_KEYS if k in config})
    return TrainConfig(
        batch_size=config["batch_size"],
        sampler=SamplerConfig(rw_hops=config["rw_hops"],
                              restart_prob=config["restart_prob"]),
        encoder=enc,
        contrast=ContrastConfig(moco=config["moco"], nce_k=config["nce_k"],
                                nce_t=config["nce_t"], alpha=config["alpha"],
                                e2e_split=config["e2e_split"]),
        optim=OptimConfig(optimizer=config["optimizer"],
                          learning_rate=config["learning_rate"],
                          beta1=config["beta1"], beta2=config["beta2"],
                          weight_decay=config["weight_decay"],
                          clip_norm=config["clip_norm"],
                          warmup=config["warmup"]))


def pipeline_config(config: dict, traffic: dict):
    """The program's pipeline settings of a cell: its configuration's
    buckets and emission, its traffic's workers and prefetch."""
    from gcc_tpu_torch.sampling.pipeline import PipelineConfig

    return PipelineConfig(
        batch_size=config["batch_size"], n_max=config["n_max"],
        e_max=config["e_max"], num_samples=traffic["num_samples"],
        num_workers=traffic["workers"], prefetch=traffic["prefetch"],
        threads_per_worker=traffic["threads_per_worker"],
        mode=traffic["mode"], emit=config["emission"],
        super_batch=config["steps_per_dispatch"], n_small=config["n_small"])


class Capture:
    """Hooks on the state's encoders and optimizer during the first
    dispatch (public PyTorch hooks; the program is not changed)."""

    def __init__(self, state, check_steps: int):
        self.state = state
        self.check_steps = check_steps
        self.steps = 0
        self.forwards = []      # (tag, step, feats)
        self.grad0 = None
        self.params = None
        self.keys = None
        names = {id(p): n for n, p in state.model.named_parameters()}
        self.names = names
        hooks = [state.model.register_forward_pre_hook(self._fwd("query"))]
        if state.cfg.contrast.moco:
            hooks.append(state.ema_model.register_forward_pre_hook(
                self._fwd("key")))
        hooks.append(state.optimizer.register_step_pre_hook(self._pre))
        hooks.append(state.optimizer.register_step_post_hook(self._post))
        self.hooks = hooks

    def _fwd(self, tag):
        def hook(module, args):
            self.forwards.append((tag, self.steps, args[0]))
        return hook

    def _pre(self, opt, args, kwargs):
        if self.steps == self.check_steps and self.params is None:
            self.params = {n: p.detach().clone() for n, p in
                           self.state.model.named_parameters()}
            if self.state.cfg.contrast.moco:
                b = self.state.cfg.batch_size
                self.keys = self.state.queue.memory[
                    :self.check_steps * b].clone()

    def _post(self, opt, args, kwargs):
        self.steps += 1
        if self.steps == 1:
            b1 = opt.param_groups[0]["betas"][0]
            self.grad0 = {self.names[id(p)]: opt.state[p]["exp_avg"].clone()
                          / (1.0 - b1)
                          for g in opt.param_groups for p in g["params"]}

    def remove(self):
        for h in self.hooks:
            h.remove()


def _sizes(wire):
    meta = np.asarray(wire.meta)
    return meta[..., 0, :], meta[..., 1, :]


def featurize_works(sq, sk, config: dict, guards: int) -> list:
    """Counted work of one dispatch's featurize kernels."""
    nq, eq = _sizes(sq)
    nk, ek = _sizes(sk)
    return list(step_counts.featurize(
        np.concatenate([nq.ravel(), nk.ravel()]),
        np.concatenate([eq.ravel(), ek.ravel()]),
        config["positional_embedding_size"], guards,
        compact=not config["e2e_split"]).values())


def dispatch_ops(sq, sk, config: dict, guards: int) -> float:
    """Counted operations of one dispatch: its featurize kernels and its
    steps."""
    nq, eq = _sizes(sq)
    nk, ek = _sizes(sk)
    moco = config["moco"]
    cand = 1 + config["nce_k"] if moco else nq.shape[-1]
    ops = sum(step_counts.train_ops((nq[t], eq[t]), (nk[t], ek[t]), config,
                                    cand, trained_keys=not moco)
              for t in range(nq.shape[0]))
    return ops + step_counts.operations(featurize_works(sq, sk, config,
                                                        guards))


def encoder_calls(sq, sk, config: dict, steps: int) -> list[dict]:
    """Every encoder call of a dispatch's first ``steps`` steps (the
    program's layout, ``check.layout_forwards``): its bucket, and the real
    nodes and edges of each graph it encodes."""
    first = (sq, sk)
    out = []
    for graphs, bucket in check.forward_graphs(
            first, {"forwards": check.layout_forwards(first, config, steps)},
            config):
        out.append({"bucket": bucket,
                    "n_nodes": np.array([g[2] for g in graphs], np.int64),
                    "n_edges": np.array([len(g[0]) for g in graphs],
                                        np.int64)})
    return out


def _fake_item(item, n_max: int, e_tot: int):
    """Edge-free graphs at bucket n_max: valid content at the real shapes,
    which warms a bucket the first dispatches did not reach."""
    meta = np.asarray(item.meta).copy()
    meta[..., 1, :] = 0
    return dataclasses.replace(
        item, n_max=n_max, meta=meta,
        edges=np.zeros((item.edges.shape[0], e_tot), np.uint16))


def run(args, config: dict, traffic: dict, device, t_start: float,
        limits: dict) -> tuple[dict, list]:
    import torch

    from gcc_tpu_torch.graph.corpus import CorpusStore
    from gcc_tpu_torch.sampling.pipeline import PretrainPipeline
    from gcc_tpu_torch.training.pretrain import (create_pretrain_state,
                                                 train_dispatch)

    s_weights, s_pipe, s_drop = derived_seeds(args.seed)[:3]
    cfg = train_config(config)
    guards = 0 if config["pe_guards"] is None else config["pe_guards"]
    n_max = config["n_max"]
    store = CorpusStore.open(ensure_corpus(config["corpus"]))
    pcfg = pipeline_config(config, traffic)
    check_steps = traffic["check_steps"]
    rec = {"kind": "pretrain", "device": device.type}
    with PretrainPipeline(store, cfg.sampler, pcfg, seed=s_pipe) as pipe:
        state = create_pretrain_state(cfg, total_steps=config["total_steps"],
                                      seed=0, device=device)
        gen = torch.Generator(device=device).manual_seed(s_weights)
        shapes = {n: tuple(t.shape) for n, t in
                  state.model.state_dict().items()}
        tensors = make_encoder_tensors(shapes, gen, device,
                                       model_name(config))
        state.model.load_state_dict(tensors)
        state.ema_model.load_state_dict(tensors)
        queue0 = make_queue(config["nce_k"], config["output_size"], gen,
                            device)
        state.queue.memory.copy_(queue0)
        state.dropout_gen.manual_seed(s_drop)
        params0, buffers0 = split({n: t.detach().cpu() for n, t in
                                   tensors.items()}, state.model)
        queue0 = queue0.cpu()

        # The first dispatch, watched.
        cap = Capture(state, check_steps)
        sq, sk = next(pipe)
        first = (copy.deepcopy(sq), copy.deepcopy(sk))
        metrics = train_dispatch(state, sq, sk, n_max=n_max)
        losses = metrics["loss"][:check_steps].double().cpu().tolist()
        cap.remove()
        captured = check.keep_on_host(cap, check_steps)
        del cap

        # The other shapes of the cell.
        seen = {sq.n_max or n_max}
        if config["emission"] == "routed":
            for bucket in (config["n_small"], n_max):
                if bucket in seen:
                    continue
                e_tot = (pipe.pcfg.e_tot_small if bucket == config["n_small"]
                         else pipe.pcfg.e_tot_large)
                fake = _fake_item(sq, bucket, e_tot)
                scratch = copy.deepcopy(state)
                train_dispatch(scratch, fake, fake, n_max=n_max)
                sync(device)
                del scratch
        for _ in range(traffic["warm_dispatches"]):
            metrics = train_dispatch(state, *next(pipe), n_max=n_max)
        metrics["loss"][-1].item()
        if args.trace:
            # The host's phases of one dispatch, spans on. Here, and not
            # next to the profiled stretch, which reads otherwise after a
            # dispatch than after the window's bookkeeping.
            rec["spans"] = probes.span_table(
                lambda: train_dispatch(state, *next(pipe), n_max=n_max),
                device)

        # The window.
        items, losses_all, marks = [], [], []
        wait = 0.0
        stats0 = probes.pipeline_stats(pipe)
        graphs0 = probes.step_graph_counts()
        rec["setup_s"] = time.time() - t_start
        t0 = time.perf_counter()
        while True:
            tw = time.perf_counter()
            marks.append(tw)
            sq, sk = next(pipe)
            wait += time.perf_counter() - tw
            metrics = train_dispatch(state, sq, sk, n_max=n_max)
            losses_all.append(metrics["loss"])
            items.append((sq, sk))
            if time.perf_counter() - t0 >= args.seconds:
                break
        sync(device)
        rec["window_s"] = time.perf_counter() - t0
        rec["pipeline"] = probes.delta(stats0, probes.pipeline_stats(pipe))
        rec["step_graphs"] = probes.delta(graphs0, probes.step_graph_counts())
        marks.append(t0 + rec["window_s"])
        print("dispatch seconds " + " ".join(
            f"{b - a:.3f}" for a, b in zip(marks, marks[1:])),
            file=sys.stderr)
        steps = config["steps_per_dispatch"]
        rec["dispatches"] = len(items)
        rec["steps"] = len(items) * steps
        rec["pairs"] = len(items) * steps * config["batch_size"]
        rec["sampler_wait_s"] = wait
        rec["work_ops"] = sum(dispatch_ops(a, b, config, guards)
                              for a, b in items)
        finite = torch.stack([torch.isfinite(x).all()
                              for x in losses_all]).cpu()
        rec["attempted"] = len(items)
        rec["failed"] = int((~finite).sum())

        if args.trace:
            trace_steps = min(traffic["trace_steps"], steps)
            stretch = Stretch(device)
            counter = {"n": 0}

            def stop_after(opt, a, k):
                counter["n"] += 1
                if counter["n"] == trace_steps:
                    stretch.stop()

            hook = state.optimizer.register_step_post_hook(stop_after)
            stretch.start()
            sq, sk = next(pipe)
            train_dispatch(state, sq, sk, n_max=n_max)
            stretch.stop()
            hook.remove()
            sync(device)
            tr = stretch.read()
            tr["steps"] = trace_steps
            tr["featurize_work"] = featurize_works(sq, sk, config, guards)
            tr["encoder_calls"] = encoder_calls(sq, sk, config, trace_steps)
            rec["trace"] = tr
        state_device = state.device
        del state, metrics, losses_all, items
    gc.collect()
    if state_device.type == "cuda":
        rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(0))
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check.pretrain(first, captured, losses, params0, buffers0,
                            queue0, s_drop, config, device, limits)
    print(f"check seconds {time.perf_counter() - t_check:.3f}",
          file=sys.stderr)
    return rec, checks
