"""Checkpoint save/restore with ``torch.save``.

Counterpart of ``gcc_tpu/training/checkpoint.py``. The full
:class:`~gcc_tpu_torch.training.pretrain.PretrainState` round-trips —
both encoders' ``state_dict`` (parameters and BatchNorm buffers), queue
memory and index, Adam's state, the step, ``nce_z``, the dropout
generator's state — as one file of plain tensors
(``path/ckpt_<step>`` or ``path/current``), read back with
``torch.load(weights_only=True)``. The TrainConfig is stored beside it
as the same JSON sidecar the reference writes (``config.json``, with a
``ckpt_format_version``).

Under ``torch.distributed`` every rank calls :func:`save_checkpoint`
with its replica of the state and rank 0 alone writes
(``gcc_tpu/training/checkpoint.py:43``, where Orbax writes from the
primary process); the ranks then meet at a barrier, so the file is
there for every rank to restore. A row-sharded queue is gathered whole
first, and a restore keeps the rank's rows.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch
import torch.distributed as dist

from gcc_tpu_torch.config import TrainConfig
from gcc_tpu_torch.device import resolve_device
from gcc_tpu_torch.models import GraphEncoder
from gcc_tpu_torch.parallel import data_parallel

CONFIG_FILE = "config.json"

# Bumped whenever the layout of the saved dictionary changes; recorded in
# the config sidecar so a mismatch can be told from a damaged file.
CKPT_FORMAT_VERSION = 1


def save_checkpoint(path: str, state, cfg: TrainConfig,
                    step: int | None = None) -> str:
    """Write ``state`` to ``path/ckpt_<step>`` (or ``path/current``) and
    the config sidecar; returns the checkpoint's path. The file is
    written under a temporary name and renamed, so a reader never sees a
    partial checkpoint. Under ``torch.distributed`` only rank 0 writes,
    and every rank returns after the write."""
    name = f"ckpt_{step}" if step is not None else "current"
    target = os.path.abspath(os.path.join(path, name))
    memory = state.queue.memory
    if state.queue.shards > 1:
        memory = data_parallel.all_gather(memory)
    if dist.is_initialized() and dist.get_rank() != 0:
        dist.barrier()
        return target
    os.makedirs(path, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save({
        "model": state.model.state_dict(),
        "ema_model": state.ema_model.state_dict(),
        "queue": {"memory": memory, "index": state.queue.index},
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "nce_z": state.nce_z,
        "dropout_gen": state.dropout_gen.get_state(),
    }, tmp)
    os.replace(tmp, target)
    sidecar = json.loads(cfg.to_json())
    sidecar["ckpt_format_version"] = CKPT_FORMAT_VERSION
    with open(os.path.join(path, CONFIG_FILE), "w") as f:
        f.write(json.dumps(sidecar, indent=2))
    if dist.is_initialized():
        dist.barrier()
    return target


def _mismatch(target: str, err: Exception) -> ValueError:
    return ValueError(
        f"checkpoint at {target} does not match the current state "
        f"structure (current format version {CKPT_FORMAT_VERSION}; a "
        "checkpoint written for another encoder configuration or by "
        "another format version cannot be restored — check "
        "ckpt_format_version and the encoder settings in the config.json "
        f"sidecar, or re-run pretraining). Underlying error: {err}")


def load_checkpoint(target: str, state=None) -> Any:
    """Read a checkpoint. With ``state`` (a PretrainState of the same
    configuration) everything is restored into it, in place and on its
    device — encoders, queue, optimizer moments, step, ``nce_z``, dropout
    generator — and it is returned; a structure mismatch raises a
    ``ValueError`` that says so. Without ``state`` the saved dictionary
    is returned, tensors on the CPU."""
    saved = torch.load(os.path.abspath(target), map_location="cpu",
                       weights_only=True)
    if state is None:
        return saved
    try:
        state.model.load_state_dict(saved["model"])
        state.ema_model.load_state_dict(saved["ema_model"])
        memory, index = saved["queue"]["memory"], saved["queue"]["index"]
        if state.queue.shards > 1:
            rows = state.queue.memory.shape[0]
            rank = dist.get_rank()
            memory = memory[rank * rows:(rank + 1) * rows]
        if memory.shape != state.queue.memory.shape:
            raise ValueError(f"queue memory {tuple(memory.shape)} vs "
                             f"{tuple(state.queue.memory.shape)}")
        state.queue.memory.copy_(memory)
        state.queue.index.copy_(index)
        state.optimizer.load_state_dict(saved["optimizer"])
        state.nce_z.copy_(saved["nce_z"])
        state.dropout_gen.set_state(saved["dropout_gen"])
        state.step = int(saved["step"])
    except (RuntimeError, KeyError, ValueError, TypeError) as e:
        raise _mismatch(target, e) from e
    return state


def load_encoder(target: str, cfg: TrainConfig, device="cuda") -> GraphEncoder:
    """The trained (query) encoder of a checkpoint, on ``device``: what
    embedding generation needs."""
    device = resolve_device(device)
    enc = GraphEncoder(cfg.encoder)
    try:
        enc.load_state_dict(load_checkpoint(target)["model"])
    except (RuntimeError, KeyError) as e:
        raise _mismatch(target, e) from e
    return enc.to(device)


def load_config(path: str) -> TrainConfig:
    with open(os.path.join(path, CONFIG_FILE)) as f:
        return TrainConfig.from_json(f.read())
