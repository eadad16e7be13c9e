"""Typed configuration (replaces the reference's ~45 argparse flags).

The reference persists its config as a pickled argparse Namespace inside
checkpoints and derives a run folder name from 19 hparams (reference
``train.py:40-166``). Here configs are frozen dataclasses serialized to a
JSON sidecar next to every checkpoint, with the same derived-run-name
convention so runs remain identifiable.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

# EncoderConfig.adj_dtype and jacobi_v_dtype take these names.
STORAGE_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Random-walk-with-restart sampling knobs (reference train.py:93-97)."""

    rw_hops: int = 256
    restart_prob: float = 0.8
    # Probability over the number of plain random-walk hops taken to pick
    # the key seed (reference graph_dataset.py:104-110). Default = always
    # 0 hops, i.e. the key walk restarts from the same seed.
    step_dist: tuple[float, ...] = (1.0, 0.0, 0.0)
    aug: str = "rwr"  # "rwr" | "ns" (k-hop neighbor sampling)
    num_neighbors: int = 5  # expand factor for aug="ns"
    # Degree exponent for seed sampling over the pretrain corpus
    # (reference graph_dataset.py:86-92 uses deg ** 0.75).
    degree_power: float = 0.75


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """GraphEncoder hyperparameters (reference train.py:77-104, 601-620)."""

    model: str = "gin"  # "gin" | "gat" | "mpnn" | "gcn"
    num_layers: int = 5
    hidden_size: int = 64
    output_size: int = 64
    positional_embedding_size: int = 32
    # "subspace" (fast TPU path) or "eigh" (exact); see features/positional.py.
    pe_method: str = "subspace"
    degree_embedding_size: int = 16
    max_degree: int = 512
    degree_input: bool = True
    norm: bool = True  # L2-normalize output embeddings
    final_dropout: float = 0.5
    use_selayer: bool = False  # squeeze-excitation instead of BatchNorm
    num_heads: int = 4  # gat
    set2set_iter: int = 6
    set2set_lstm_layer: int = 3
    # Storage of the dense adjacency chain (adjacency, PE operator) and of
    # the Jacobi finishes' eigenvector accumulator: "float32" or
    # "bfloat16" — the reference's GCC_TPU_ADJ_DTYPE=bf16 and
    # GCC_TPU_JACOBI_V_DTYPE=bf16 (gcc_tpu/ops/aggregate.py:30-45,
    # ops/jacobi.py:151-168), where they are read from the environment. A
    # sidecar written before these fields loads as float32.
    adj_dtype: str = "float32"
    jacobi_v_dtype: str = "float32"
    # The subspace PE's guard columns on every profile, which the
    # reference reads from GCC_TPU_PE_GUARDS
    # (gcc_tpu/features/positional.py:373-388). None keeps each profile's
    # own: train 0, eval 16 (the giant path's eval 16 too). A sidecar
    # written before this field loads with None.
    pe_guards: int | None = None

    def __post_init__(self):
        for name in ("adj_dtype", "jacobi_v_dtype"):
            if getattr(self, name) not in STORAGE_DTYPES:
                raise ValueError(f"EncoderConfig.{name} is one of "
                                 f"{STORAGE_DTYPES}, got "
                                 f"{getattr(self, name)!r}")
        if self.pe_guards is not None and not (
                isinstance(self.pe_guards, int) and self.pe_guards >= 0):
            raise ValueError("EncoderConfig.pe_guards is None or an int >= "
                             f"0, got {self.pe_guards!r}")

    @property
    def node_input_dim(self) -> int:
        d = self.positional_embedding_size + 1
        if self.degree_input:
            d += self.degree_embedding_size
        return d


@dataclasses.dataclass(frozen=True)
class ContrastConfig:
    """InfoNCE / MoCo settings (reference train.py:88-90, 107-112)."""

    moco: bool = False
    nce_k: int = 16384  # queue size (MoCo) — E2E uses in-batch negatives
    nce_t: float = 0.07
    alpha: float = 0.999  # EMA momentum for the key encoder
    # Legacy non-softmax NCE normalization (reference
    # memory_moco.py:45-52; dead code there — use_softmax is hardcoded
    # True at its only call site, train.py:628). False selects it as a
    # real MoCo training branch here: exp(l/T)/Z probabilities fed to the
    # same CE criterion, Z estimated from the first batch and frozen in
    # PretrainState.nce_z (contrastive/losses.py legacy_nce_probs).
    use_softmax: bool = True
    # Device-side size-routed sub-forwards for the E2E objective
    # (training/pretrain.py featurize_e2e_split): a "n0:cap0,n1:cap1"
    # spec of sub-bucket classes below the wire's n_max — per step, the
    # first cap0 slot-ranked pairs whose BOTH subgraphs fit n0 nodes run
    # a (·, n0, n0) sub-program, the next cap1 a (·, n1, n1) one, and
    # the remaining batch_size − Σcap pairs the full n_max bucket; the
    # (B, B) in-batch NCE runs on the concatenated EMBEDDINGS, so the
    # objective is composition-identical (negatives are the same B-1
    # embeddings; pair order is loss-invariant). Capacities are sized
    # from the measured pair distribution at the canonical batch 256
    # (p(max-side ≤ 128) = 98.9%, per-step count(>128) max ~3 —
    # docs/PERF.md E2E split): small pairs spill upward freely, the
    # reverse overflow is counted in metrics. A finer 3-class split
    # ("80:224,128:20") measured SLOWER (8.38 vs 7.61 ms/step): sub-128
    # buckets lane-pad to 128 on the minor axis, so HBM tiles don't
    # shrink with n², while the extra sub-forwards and the third
    # PE/Jacobi chain add serial work. Documented deviation:
    # each sub-forward computes its own masked-BN batch stats
    # (size-grouped normalization batches; the unsplit path normalizes q
    # and k batches separately too). "" disables; also auto-disabled
    # when the WIRE batch width <= Σcap (capacities are parsed against
    # the wire item, not TrainConfig.batch_size), under DP-sharded
    # wires, for non-compact batch layouts, and for unstacked
    # single-step dispatches (meta without a step axis).
    e2e_split: str = "128:240"


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Optimizer settings (reference train.py:55-66, 659-681)."""

    optimizer: str = "adam"
    learning_rate: float = 0.005
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 1e-5
    momentum: float = 0.9  # sgd only
    clip_norm: float = 1.0
    warmup: float = 0.1  # triangular schedule peak position (train.py:412-414)
    # Step decay past given epochs (reference adjust_learning_rate,
    # misc.py:13-20; inert with the reference defaults since
    # epochs=100 < 120).
    lr_decay_epochs: tuple[int, ...] = (120, 160, 200)
    lr_decay_rate: float = 0.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    exp: str = ""
    dataset: str = "corpus"
    batch_size: int = 32
    epochs: int = 100
    num_samples: int = 2000  # per sampler worker per epoch
    num_workers: int = 1
    seed: int = 0
    fold_idx: int = 0
    print_freq: int = 10
    save_freq: int = 1
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    contrast: ContrastConfig = dataclasses.field(default_factory=ContrastConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)

    def run_name(self) -> str:
        """Derived run identity (mirrors reference option_update, train.py:133-166)."""
        return (
            f"{self.exp}_moco_{self.contrast.moco}_{self.dataset}_"
            f"{self.encoder.model}_layer_{self.encoder.num_layers}_"
            f"lr_{self.optim.learning_rate}_decay_{self.optim.weight_decay}_"
            f"bsz_{self.batch_size}_hid_{self.encoder.hidden_size}_"
            f"samples_{self.num_samples}_nce_t_{self.contrast.nce_t}_"
            f"nce_k_{self.contrast.nce_k}_rw_hops_{self.sampler.rw_hops}_"
            f"restart_prob_{self.sampler.restart_prob}_aug_{self.sampler.aug}_"
            f"deg_{self.encoder.degree_embedding_size}_"
            f"pos_{self.encoder.positional_embedding_size}_"
            f"momentum_{self.contrast.alpha}"
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "TrainConfig":
        return _from_dict(TrainConfig, json.loads(s))


def with_levers(cfg: TrainConfig, adj_dtype: str | None = None,
                jacobi_v_dtype: str | None = None,
                pe_guards: int | None = None) -> TrainConfig:
    """``cfg`` with the encoder's storage levers and PE guards replaced
    where given (None keeps the configuration's, e.g. a checkpoint's)."""
    changes = {k: v for k, v in (("adj_dtype", adj_dtype),
                                 ("jacobi_v_dtype", jacobi_v_dtype),
                                 ("pe_guards", pe_guards))
               if v is not None}
    if not changes:
        return cfg
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, **changes))


def without_switches(cfg: TrainConfig) -> TrainConfig:
    """``cfg`` with the storage levers and PE guards at their defaults:
    what the reference computes in a process where none of its variables
    is set (an A/B's evaluation of a checkpoint trained with them)."""
    defaults = EncoderConfig()
    return dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, **{k: getattr(defaults, k) for k in (
            "adj_dtype", "jacobi_v_dtype", "pe_guards")}))


def _from_dict(cls: Any, d: dict) -> Any:
    kwargs = {f.name: d[f.name] for f in dataclasses.fields(cls) if f.name in d}
    # Nested dataclasses.
    nested = {
        "sampler": SamplerConfig,
        "encoder": EncoderConfig,
        "contrast": ContrastConfig,
        "optim": OptimConfig,
    }
    for name, sub in nested.items():
        if name in kwargs and isinstance(kwargs[name], dict):
            # Drop keys the current dataclass no longer has: a sidecar
            # written before a field rename/removal must keep loading
            # (the unknown field's value is definitionally unused by
            # current code). Unknown top-level keys are already dropped
            # by the comprehension above.
            known = {f.name for f in dataclasses.fields(sub)}
            kwargs[name] = sub(**{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in kwargs[name].items() if k in known
            })
    return cls(**kwargs)
