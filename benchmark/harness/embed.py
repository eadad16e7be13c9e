"""Driver of the generation traffic: one caller in a closed loop of
``generate_embeddings`` calls over a pool of sampled node views.

Set-up samples two RWR views of every node of the dataset graph with the
program's ``node_subgraphs`` (seeded from the run's seed), builds the
encoder with the benchmark's weights and warms the call. The window then
calls ``generate_embeddings`` on consecutive slices of the pool, cycling,
each call timed from submit to the numpy result. A pre-forward hook keeps
the PE and degree feature of the calls that the seed picks for the check:
every ``check_every``-th call from a seeded offset, up to ``check_calls``,
so that each picked call encodes another slice of the pool.
A traced run also runs one call with the program's spans on before the
window and keeps their table, and after the window profiles a stretch of
further calls with the spans on, keeping each view's bucket and graph
sizes (one encoder call a view, or several of one bucket where the
program's adjacency memory guard splits it). Last, with the program's
encoder freed, the reference checks the picked calls.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from benchmark.counts import encoder as enc_counts
from benchmark.counts import step as step_counts
from benchmark.harness import check, probes
from benchmark.harness.common import derived_seeds, quantile
from benchmark.harness.corpus import dataset_graph
from benchmark.harness.pretrain import train_config
from benchmark.harness.trace import Stretch
from benchmark.harness.weights import make_encoder_tensors, split
from benchmark.reference.encoder import model_name


def call_ops(sizes_q, sizes_k, config: dict, guards: int) -> float:
    """Counted operations of one call: both views' eval encode and their
    featurize kernels."""
    ops = 0.0
    for n, e in (sizes_q, sizes_k):
        ops += enc_counts.forward(n, e, config)
        ops += step_counts.operations(step_counts.featurize(
            n, e, config["positional_embedding_size"], guards,
            compact=False).values())
    return ops


def _sizes(subs, n_max: int):
    return (np.array([min(s.num_nodes, n_max) for s in subs]),
            np.array([len(s.src) for s in subs]))


def _report_not_finite(i: int, pool_slice: int, emb, sizes,
                       again=False) -> None:
    """Which rows of call ``i`` are not finite, with the (nodes, edges) of
    their two views."""
    rows = np.where(~np.isfinite(emb).all(axis=1))[0][:8]
    (nq, eq), (nk, ek) = sizes
    views = [(int(nq[r]), int(eq[r]), int(nk[r]), int(ek[r])) for r in rows]
    print(f"{'again: ' if again else ''}call {i} (pool slice {pool_slice}): "
          f"{int((~np.isfinite(emb).all(axis=1)).sum())} rows not finite, "
          f"{int(np.isnan(emb).sum())} NaN, {int(np.isinf(emb).sum())} inf; "
          f"rows {rows.tolist()}, views (q nodes, edges, k nodes, edges) "
          f"{views}", file=sys.stderr, flush=True)


def run(args, config: dict, traffic: dict, device, t_start: float,
        limits: dict) -> tuple[dict, list]:
    import torch

    from gcc_tpu_torch.generate import generate_embeddings, node_subgraphs
    from gcc_tpu_torch.graph.csr import CSRGraph
    from gcc_tpu_torch.models import GraphEncoder

    s_weights, _, _, s_sample = derived_seeds(args.seed)[:4]
    cfg = train_config(config)
    n_max, e_max, batch = traffic["n_max"], traffic["e_max"], traffic["batch"]
    guards = 16 if config["pe_guards"] is None else config["pe_guards"]
    indptr, indices = dataset_graph(traffic["dataset_nodes"],
                                    traffic["dataset_avg_degree"],
                                    traffic["dataset_seed"])
    graph = CSRGraph(indptr=indptr, indices=indices)
    subs_q, subs_k = node_subgraphs(graph, cfg, n_max, e_max,
                                    rng_seed=s_sample, two_views=True)
    per_pool = len(subs_q) // batch
    sizes = [(_sizes(subs_q[j * batch:(j + 1) * batch], n_max),
              _sizes(subs_k[j * batch:(j + 1) * batch], n_max))
             for j in range(per_pool)]

    model = GraphEncoder(cfg.encoder).to(device)
    gen = torch.Generator(device=device).manual_seed(s_weights)
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    tensors = make_encoder_tensors(shapes, gen, device, model_name(config))
    model.load_state_dict(tensors)
    params, buffers = split({n: t.detach().cpu() for n, t in tensors.items()},
                            model)

    def call(i):
        j = (i % per_pool) * batch
        return generate_embeddings(
            cfg, model, subs_q[j:j + batch], n_max=n_max, e_max=e_max,
            batch_size=batch, subgraphs_k=subs_k[j:j + batch], device=device)

    kept = []
    hook_on = {"on": False}

    def keep(module, args_):
        if hook_on["on"]:
            kept.append((args_[0].pos, args_[0].degrees))

    handle = model.register_forward_pre_hook(keep)
    for i in range(traffic["warm_calls"]):
        call(per_pool - 1 - i)
    rec = {"kind": "embed", "device": device.type}
    if args.trace:
        # The host's phases of one call, spans on, on a warmed slice.
        rec["spans"] = probes.span_table(lambda: call(per_pool - 1), device)

    stride = traffic["check_every"]
    offset = s_sample % stride
    sampled = []
    call_s, failed, not_finite = [], 0, []
    rec["setup_s"] = time.time() - t_start
    t0 = time.perf_counter()
    i = 0
    while True:
        pick = (i % stride == offset
                and len(sampled) < traffic["check_calls"])
        hook_on["on"] = pick
        c0 = time.perf_counter()
        emb = call(i)
        call_s.append(time.perf_counter() - c0)
        hook_on["on"] = False
        if not np.isfinite(emb).all():
            failed += 1
            not_finite.append(i)
            _report_not_finite(i, i % per_pool, emb, sizes[i % per_pool])
        if pick:
            (pq, dq), (pk, dk) = kept[-2:]
            kept.clear()
            j = (i % per_pool) * batch
            sampled.append({"q": subs_q[j:j + batch],
                            "k": subs_k[j:j + batch], "emb": emb,
                            "pos": (pq, pk), "degrees": (dq, dk)})
        i += 1
        if time.perf_counter() - t0 >= args.seconds:
            break
    rec["window_s"] = time.perf_counter() - t0
    handle.remove()
    rec["calls"] = i
    rec["embeddings"] = i * batch
    rec["call_s"] = call_s
    rec["call_ms_p95"] = 1000.0 * quantile(call_s, 95)
    median_s = quantile(call_s, 50)
    slow = [s for s in call_s if s > 2.0 * median_s]
    print("call ms p10 %.1f p50 %.1f p90 %.1f max %.1f; over 2x median: "
          "%d calls, %.3f s in all" % (
              1000.0 * quantile(call_s, 10), 1000.0 * median_s,
              1000.0 * quantile(call_s, 90), 1000.0 * max(call_s),
              len(slow), sum(slow)), file=sys.stderr)
    rec["attempted"] = i
    rec["failed"] = failed
    # A call that gave a row not finite is run again on the same inputs,
    # after the window: whether it repeats tells the inputs from a race.
    for c in not_finite[:4]:
        _report_not_finite(c, c % per_pool, call(c), sizes[c % per_pool],
                           again=True)
    rec["work_ops"] = sum(call_ops(*sizes[c % per_pool], config, guards)
                          for c in range(i))
    for s in sampled:
        s["pos"] = tuple(x.detach().cpu() for x in s["pos"])
        s["degrees"] = tuple(x.detach().cpu() for x in s["degrees"])

    if args.trace:
        calls = traffic["trace_calls"]
        stretch = Stretch(device)
        # Spans on in the stretch too: the trace's idle time under each.
        with probes.spans_on():
            stretch.start()
            for c in range(i, i + calls):
                call(c)
            stretch.stop()
        tr = stretch.read()
        tr["calls"] = calls
        works, views = [], []
        for c in range(i, i + calls):
            for n, e in sizes[c % per_pool]:
                works += list(step_counts.featurize(
                    n, e, config["positional_embedding_size"], guards,
                    compact=False).values())
                views.append({"bucket": n_max, "n_nodes": n, "n_edges": e})
        tr["featurize_work"] = works
        tr["encoder_calls"] = views
        rec["trace"] = tr
    del model
    gc.collect()
    if device.type == "cuda":
        rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(0))
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check.embed(sampled, params, buffers, config,
                         config["positional_embedding_size"], n_max, device,
                         limits)
    print(f"check seconds {time.perf_counter() - t_check:.3f}",
          file=sys.stderr)
    return rec, checks
