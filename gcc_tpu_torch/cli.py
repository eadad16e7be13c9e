"""Command-line interface of the PyTorch/CUDA port.

Subcommands mirror ``gcc_tpu.cli`` (the reference's train.py /
generate.py / gcc/tasks/*.py entry points plus the ingest tool), with the
same flags and defaults, plus ``--device`` (default ``cuda``) on the
commands that run the encoder:

  python -m gcc_tpu_torch.cli synth-corpus --out data/corpus
  python -m gcc_tpu_torch.cli ingest --out data/corpus graph1.edgelist ...
  python -m gcc_tpu_torch.cli pretrain --corpus data/corpus --out saved [--moco ...]
  python -m gcc_tpu_torch.cli finetune --ckpt saved/<run>/current --dataset imdb-binary [--cv]
  python -m gcc_tpu_torch.cli generate --ckpt saved/<run>/current --dataset usa_airport
  python -m gcc_tpu_torch.cli eval-node --dataset usa_airport --emb <npy>
  python -m gcc_tpu_torch.cli eval-graph --dataset imdb-binary --emb <npy>
  python -m gcc_tpu_torch.cli eval-sim --dataset kdd_icdm --emb1 <npy> --emb2 <npy>
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np


def _add_train_flags(p):
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--num-samples", type=int, default=2000)
    p.add_argument("--num-workers", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--moco", action="store_true")
    p.add_argument("--nce-k", type=int, default=16384)
    p.add_argument("--nce-t", type=float, default=0.07)
    p.add_argument("--alpha", type=float, default=0.999)
    p.add_argument("--learning-rate", type=float, default=0.005)
    p.add_argument("--weight-decay", type=float, default=1e-5)
    p.add_argument("--model", default="gin", choices=["gin", "gat", "mpnn"])
    p.add_argument("--num-layer", type=int, default=5)
    p.add_argument("--hidden-size", type=int, default=64)
    p.add_argument("--rw-hops", type=int, default=256)
    p.add_argument("--restart-prob", type=float, default=0.8)
    p.add_argument("--positional-embedding-size", type=int, default=32)
    p.add_argument("--degree-embedding-size", type=int, default=16)
    p.add_argument("--max-degree", type=int, default=512)
    p.add_argument("--pe-method", default="subspace", choices=["subspace", "eigh"])
    p.add_argument("--optimizer", default="adam",
                   choices=["adam", "sgd", "adagrad"])
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.999)
    p.add_argument("--momentum", type=float, default=0.9, help="sgd only")
    p.add_argument("--clip-norm", type=float, default=1.0)
    p.add_argument("--no-norm", action="store_true",
                   help="skip final L2-normalization of embeddings")
    p.add_argument("--set2set-iter", type=int, default=6)
    p.add_argument("--set2set-lstm-layer", type=int, default=3)
    p.add_argument("--num-copies", type=int, default=1)
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--save-freq", type=int, default=1)
    p.add_argument("--aug", default="rwr", choices=["rwr", "ns"])
    p.add_argument("--n-max", type=int, default=512)
    p.add_argument("--e-max", type=int, default=8192)
    p.add_argument("--emit", default="auto",
                   choices=["auto", "pairs", "stacked", "routed"],
                   help="input pipeline emission mode (pipeline.py): auto "
                        "upgrades to stacked when the fast path supports "
                        "it; routed adds size-bucket batch routing "
                        "(~99%% of dispatches at 4x less N^2 device work; "
                        "size-homogeneous batch composition)")
    p.add_argument("--n-small", type=int, default=128,
                   help="small node bucket for --emit routed")
    p.add_argument("--dp-devices", type=int, default=1,
                   help="data-parallel device count: one process per "
                        "device under torchrun (--nproc-per-node N; "
                        "NCCL on the card, gloo with --device cpu), the "
                        "stacked/routed wire with a device axis; 1 = one "
                        "device")
    p.add_argument("--exp", default="")
    p.add_argument("--dataset", default="corpus")
    add_lever_flags(p)
    add_pe_flags(p)


def add_lever_flags(p):
    """The reference's two bf16 storage levers (GCC_TPU_ADJ_DTYPE,
    GCC_TPU_JACOBI_V_DTYPE) as options; omitted, a checkpoint's own
    setting holds (float32 for a new run)."""
    from gcc_tpu_torch.config import STORAGE_DTYPES

    p.add_argument("--adj-dtype", default=None, choices=STORAGE_DTYPES,
                   help="storage of the adjacency and PE operator "
                        "(default float32)")
    p.add_argument("--jacobi-v-dtype", default=None, choices=STORAGE_DTYPES,
                   help="storage of the Jacobi finishes' eigenvectors "
                        "(default float32)")


def add_pe_flags(p):
    """The reference's GCC_TPU_PE_GUARDS as an option; omitted, a
    checkpoint's own setting holds (each profile's guards for a new
    run)."""
    p.add_argument("--pe-guards", type=int, default=None,
                   help="guard columns of the subspace PE on every profile "
                        "(default: train 0, eval 16)")


def _with_flags(cfg, args):
    """``cfg`` with the storage levers and PE guards the command line
    gives."""
    from gcc_tpu_torch.config import with_levers

    return with_levers(cfg, args.adj_dtype, args.jacobi_v_dtype,
                       args.pe_guards)


def _add_device_flag(p):
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")


def _cfg_from_args(args):
    from gcc_tpu_torch.config import (
        ContrastConfig, EncoderConfig, OptimConfig, SamplerConfig, TrainConfig,
    )

    return TrainConfig(
        exp=args.exp,
        dataset=args.dataset,
        batch_size=args.batch_size,
        epochs=args.epochs,
        num_samples=args.num_samples,
        num_workers=args.num_workers,
        seed=args.seed,
        sampler=SamplerConfig(
            rw_hops=args.rw_hops, restart_prob=args.restart_prob,
            aug=args.aug,
        ),
        print_freq=args.print_freq,
        save_freq=args.save_freq,
        encoder=EncoderConfig(
            model=args.model, num_layers=args.num_layer,
            hidden_size=args.hidden_size, output_size=args.hidden_size,
            positional_embedding_size=args.positional_embedding_size,
            degree_embedding_size=args.degree_embedding_size,
            max_degree=args.max_degree, pe_method=args.pe_method,
            norm=not args.no_norm, set2set_iter=args.set2set_iter,
            set2set_lstm_layer=args.set2set_lstm_layer,
            adj_dtype=args.adj_dtype or "float32",
            jacobi_v_dtype=args.jacobi_v_dtype or "float32",
            pe_guards=args.pe_guards,
        ),
        contrast=ContrastConfig(
            moco=args.moco, nce_k=args.nce_k, nce_t=args.nce_t,
            alpha=args.alpha,
        ),
        optim=OptimConfig(
            learning_rate=args.learning_rate, weight_decay=args.weight_decay,
            optimizer=args.optimizer, beta1=args.beta1, beta2=args.beta2,
            momentum=args.momentum, clip_norm=args.clip_norm,
        ),
    )


def cmd_synth_corpus(args):
    from gcc_tpu_torch.graph.corpus import synthetic_corpus

    store = synthetic_corpus(
        args.out, num_graphs=args.num_graphs,
        nodes_per_graph=args.nodes_per_graph, avg_degree=args.avg_degree,
        seed=args.seed,
    )
    print(f"wrote {store.num_graphs} graphs, sizes {store.graph_sizes}")


def cmd_ingest(args):
    from gcc_tpu_torch.data.ingest import ingest_edgelists

    store = ingest_edgelists(args.files, args.out)
    print(f"wrote {store.num_graphs} graphs, sizes {store.graph_sizes}")


def cmd_pretrain(args):
    from gcc_tpu_torch.parallel.multihost import multihost_session

    # Under torchrun: join the process group (env://) before anything
    # touches the device, and leave it on the way out; a no-op for a
    # single process.
    with multihost_session(args.device):
        _pretrain(args)


def _pretrain(args):
    from gcc_tpu_torch.sampling.pipeline import PipelineConfig
    from gcc_tpu_torch.training.loop import run_pretrain

    cfg = _cfg_from_args(args)
    if cfg.dataset != "corpus":
        # Pretrain on a single evaluation dataset's graph(s) (the
        # reference's non-"dgl" branch, train.py:558-573): materialize a
        # one-off corpus from the dataset and train on it.
        import tempfile

        from gcc_tpu_torch.data.formats import GRAPH_CLASSIFICATION_DSETS
        from gcc_tpu_torch.graph.corpus import CorpusStore

        tmp = tempfile.mkdtemp(prefix="gcc_tpu_torch_dscorpus_")
        if cfg.dataset in GRAPH_CLASSIFICATION_DSETS:
            from gcc_tpu_torch.data.tu import load_tu_dataset

            graphs, _ = load_tu_dataset(cfg.dataset, args.data_root)
        else:
            from gcc_tpu_torch.data.formats import (
                create_node_classification_dataset,
            )

            graphs = [create_node_classification_dataset(
                cfg.dataset, args.data_root).graph]
        CorpusStore.create(tmp, graphs)
        args.corpus = tmp
    pcfg = PipelineConfig(
        batch_size=cfg.batch_size, n_max=args.n_max, e_max=args.e_max,
        num_samples=cfg.num_samples, num_workers=cfg.num_workers,
        num_copies=args.num_copies, n_small=args.n_small,
        **({} if args.emit == "auto" else {"emit": args.emit}),
    )
    summary = run_pretrain(cfg, args.corpus, args.out, pcfg,
                           resume=args.resume or None,
                           tensorboard=args.tensorboard,
                           profile_dir=args.profile_dir or None,
                           dp_devices=args.dp_devices, device=args.device)
    print(summary)


def cmd_finetune(args):
    from gcc_tpu_torch.data.formats import GRAPH_CLASSIFICATION_DSETS
    from gcc_tpu_torch.training.checkpoint import load_checkpoint, load_config
    from gcc_tpu_torch.training.finetune import (
        GraphLabeledData,
        NodeLabeledData,
        run_finetune_cv,
    )

    pretrained = None
    if args.ckpt:
        cfg = load_config(os.path.dirname(args.ckpt))
        pretrained = load_checkpoint(args.ckpt)["model"]
    else:
        cfg = _cfg_from_args(args)
    cfg = dataclasses.replace(cfg, epochs=args.epochs, seed=args.seed,
                              batch_size=args.batch_size)
    cfg = _with_flags(cfg, args)

    if args.dataset in GRAPH_CLASSIFICATION_DSETS:
        from gcc_tpu_torch.data.tu import load_tu_dataset

        graphs, labels = load_tu_dataset(args.dataset, args.data_root)
        data = GraphLabeledData(graphs, labels, n_max=args.n_max,
                                e_max=args.e_max)
    else:
        from gcc_tpu_torch.data.formats import (
            create_node_classification_dataset,
        )

        nd = create_node_classification_dataset(args.dataset, args.data_root)
        data = NodeLabeledData(nd.graph, nd.y, cfg, n_max=args.n_max,
                               e_max=args.e_max)
    folds = range(10) if args.cv else [args.fold_idx]
    print(run_finetune_cv(cfg, data, pretrained, folds=folds,
                          device=args.device))


def cmd_generate(args):
    from gcc_tpu_torch.parallel.multihost import multihost_session

    # Under torchrun: join the process group, whose ranks then share each
    # giant graph (the reference's "part" axis over every device); every
    # rank computes the same embeddings and rank 0 writes them. Each rank
    # leaves the group before it exits.
    with multihost_session(args.device) as group:
        _generate(args, group)


def _generate(args, group):
    import torch.distributed as dist

    from gcc_tpu_torch.data.formats import GRAPH_CLASSIFICATION_DSETS
    from gcc_tpu_torch.generate import generate_embeddings, node_subgraphs
    from gcc_tpu_torch.training.checkpoint import load_config, load_encoder

    run_dir = os.path.dirname(args.ckpt)
    cfg = _with_flags(load_config(run_dir), args)
    enc = load_encoder(args.ckpt, cfg, device=args.device)

    if args.dataset in GRAPH_CLASSIFICATION_DSETS:
        from gcc_tpu_torch.data.tu import load_tu_dataset
        from gcc_tpu_torch.generate import generate_graph_embeddings

        graphs, _ = load_tu_dataset(args.dataset, args.data_root)
        emb = generate_graph_embeddings(cfg, enc, graphs,
                                        n_max=args.n_max, e_max=args.e_max,
                                        readout=args.graph_readout,
                                        group=group, device=args.device)
    else:
        from gcc_tpu_torch.data.formats import (
            create_node_classification_dataset,
        )

        data = create_node_classification_dataset(args.dataset, args.data_root)
        subs, subs_k = node_subgraphs(data.graph, cfg, args.n_max,
                                      args.e_max, two_views=True)
        emb = generate_embeddings(cfg, enc, subs, n_max=args.n_max,
                                  e_max=args.e_max, subgraphs_k=subs_k,
                                  device=args.device)
    if group is not None and dist.get_rank() != 0:
        return
    out = args.out or os.path.join(run_dir, f"{args.dataset}.npy")
    np.save(out, emb)
    print(f"saved {emb.shape} -> {out}")


def cmd_eval_node(args):
    from gcc_tpu_torch.tasks import NodeClassification

    kwargs = {"emb_path": args.emb} if args.model == "from_numpy" else {}
    task = NodeClassification(args.dataset, args.hidden_size, args.seed,
                              model=args.model, data_root=args.data_root,
                              **kwargs)
    print(task.train())


def cmd_eval_graph(args):
    from gcc_tpu_torch.tasks import GraphClassification

    task = GraphClassification(args.dataset, args.hidden_size, args.seed,
                               model="from_numpy_graph", emb_path=args.emb,
                               data_root=args.data_root)
    print(task.train())


def cmd_eval_sim(args):
    from gcc_tpu_torch.tasks import SimilaritySearch

    d1, d2 = args.dataset.split("_")
    kwargs = {}
    if args.model == "from_numpy_align":
        if not (args.emb1 and args.emb2):
            raise SystemExit("--emb1/--emb2 required with model "
                             "from_numpy_align")
        kwargs = {"emb_path_1": args.emb1, "emb_path_2": args.emb2}
    elif args.emb1 or args.emb2:
        raise SystemExit(
            f"--emb1/--emb2 only apply to model from_numpy_align; model "
            f"{args.model!r} trains from the graphs and would silently "
            f"ignore them"
        )
    task = SimilaritySearch(d1, d2, args.hidden_size, model=args.model,
                            data_root=args.data_root, **kwargs)
    print(task.train())


def main(argv=None):
    parser = argparse.ArgumentParser("gcc_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("synth-corpus")
    p.add_argument("--out", required=True)
    p.add_argument("--num-graphs", type=int, default=6)
    p.add_argument("--nodes-per-graph", type=int, default=20000)
    p.add_argument("--avg-degree", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_synth_corpus)

    p = sub.add_parser("ingest")
    p.add_argument("files", nargs="+")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_ingest)

    p = sub.add_parser("pretrain")
    p.add_argument("--corpus", default="",
                   help="corpus dir (not needed with --dataset <eval-set>)")
    p.add_argument("--out", default="saved")
    p.add_argument("--data-root", default="data")
    p.add_argument("--resume", default="", help="checkpoint path to resume")
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of the second "
                        "dispatch (host ops, kernels and the gcc.* spans) "
                        "here as trace.json, its spans as spans.json")
    _add_train_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_pretrain)

    p = sub.add_parser("finetune")
    p.add_argument("--ckpt", default="",
                   help="pretrained checkpoint (omit to train from scratch)")
    p.add_argument("--cv", action="store_true", help="run all 10 folds")
    p.add_argument("--fold-idx", type=int, default=0)
    p.add_argument("--data-root", default="data")
    _add_train_flags(p)  # includes --n-max/--e-max bucket flags
    _add_device_flag(p)
    p.set_defaults(fn=cmd_finetune)

    p = sub.add_parser("generate")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--data-root", default="data")
    p.add_argument("--n-max", type=int, default=512)
    p.add_argument("--e-max", type=int, default=8192)
    p.add_argument("--graph-readout", default="score",
                   choices=["score", "composite"],
                   help="graph-classification datasets only: 'score' = "
                        "the reference's 64-d summed-head embedding; "
                        "'composite' = mean-pooled input + per-layer "
                        "L2'd conv sums (generate.composite_graph_readout)")
    add_lever_flags(p)
    add_pe_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_generate)

    for name, fn in [("eval-node", cmd_eval_node), ("eval-graph", cmd_eval_graph)]:
        p = sub.add_parser(name)
        p.add_argument("--dataset", required=True)
        p.add_argument("--emb", default="")
        p.add_argument("--model", default="from_numpy",
                       help="embedding source: from_numpy/prone/graphwave/zero")
        p.add_argument("--hidden-size", type=int, default=64)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--data-root", default="data")
        p.set_defaults(fn=fn)

    p = sub.add_parser("eval-sim")
    p.add_argument("--dataset", required=True)  # e.g. kdd_icdm
    p.add_argument("--emb1", default="")
    p.add_argument("--emb2", default="")
    p.add_argument("--model", default="from_numpy_align",
                   help="from_numpy_align (GCC embeddings) or a classical "
                        "baseline: prone/graphwave/zero")
    p.add_argument("--hidden-size", type=int, default=64)
    p.add_argument("--data-root", default="data")
    p.set_defaults(fn=cmd_eval_sim)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
