"""The canonical pre-training recipe the instruments read
(``scripts/pe_ab.py:48-106``, its child run).

MoCo at the reference's canonical configuration — batch 32, queue 16384,
GIN 5 x 64, PE 32 by subspace iteration, rw_hops 256, 2,000 samples an
epoch — on the 6-graph synthetic corpus (100k nodes a graph, mean
degree 12, seed 0), or on the family-diverse corpus for the reference's
``-div`` arm; routed buckets n_small 128 / n_max 256, e_max 2048, 62
steps a dispatch (one dispatch an epoch).
"""

from __future__ import annotations

import os

CORPUS_NODES, CORPUS_DEGREE = 100_000, 12
STEPS_PER_CALL = 62


def recipe(epochs: int = 100, seed: int = 0):
    """(TrainConfig, PipelineConfig) of the recipe (``pe_ab.py:66-81``)."""
    from gcc_tpu_torch.config import (
        ContrastConfig,
        EncoderConfig,
        SamplerConfig,
        TrainConfig,
    )
    from gcc_tpu_torch.sampling.pipeline import PipelineConfig

    cfg = TrainConfig(
        batch_size=32,
        epochs=epochs,
        seed=seed,
        num_samples=2000,
        num_workers=1,
        sampler=SamplerConfig(rw_hops=256),
        contrast=ContrastConfig(moco=True, nce_k=16384),
        encoder=EncoderConfig(pe_method="subspace"),
    )
    pcfg = PipelineConfig(
        batch_size=32, n_max=256, e_max=2048, num_samples=2000,
        num_workers=1, mode="thread", emit="routed", super_batch=62,
        n_small=128,
    )
    return cfg, pcfg


def make_corpus(path: str, diverse: bool = False):
    """The recipe's corpus at ``path``, made unless it is there."""
    from gcc_tpu_torch.graph.corpus import (
        CorpusStore,
        synthetic_corpus,
        synthetic_corpus_diverse,
    )

    if os.path.exists(os.path.join(path, "manifest.json")):
        return CorpusStore.open(path)
    if diverse:
        return synthetic_corpus_diverse(path, nodes_per_graph=CORPUS_NODES,
                                        avg_degree=CORPUS_DEGREE, seed=0)
    return synthetic_corpus(path, num_graphs=6, nodes_per_graph=CORPUS_NODES,
                            avg_degree=CORPUS_DEGREE, seed=0)


def pretrain(out_dir: str, epochs: int = 100, seed: int = 0,
             corpus: str | None = None, diverse: bool = False,
             log_fn=print, device="cuda") -> dict:
    """Run the recipe for ``epochs``; returns run_pretrain's summary
    (its ``run_dir`` holds ``current`` and ``metrics.jsonl``). The corpus
    defaults to ``out_dir/corpus`` (``corpus_diverse`` with ``diverse``)."""
    from gcc_tpu_torch.device import resolve_device
    from gcc_tpu_torch.training.loop import run_pretrain

    device = resolve_device(device)   # before the corpus is made
    corpus = corpus or os.path.join(
        out_dir, "corpus_diverse" if diverse else "corpus")
    make_corpus(corpus, diverse)
    cfg, pcfg = recipe(epochs, seed)
    return run_pretrain(cfg, corpus, out_dir, pcfg=pcfg, log_fn=log_fn,
                        steps_per_call=STEPS_PER_CALL, device=device)
