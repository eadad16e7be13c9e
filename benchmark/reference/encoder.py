"""The plain encoder of a configuration, found by its model's name.

``encode`` runs ``encode`` of ``reference/models/<cfg["model"]>.py``; a
configuration that names no model means ``gin``, the one model of the
first configurations. A new encoder is a new file there, with the same
``encode`` signature and, where one of its parameters is drawn by a rule
``harness/weights.py`` does not know, an ``init_bound(name, shape,
shapes)`` giving that parameter's uniform bound (``None`` for the others).
"""

from __future__ import annotations

import importlib

DEFAULT_MODEL = "gin"


def model_name(cfg: dict) -> str:
    return cfg.get("model", DEFAULT_MODEL)


def model_module(name: str):
    """``benchmark.reference.models.<name>``."""
    return importlib.import_module(f"benchmark.reference.models.{name}")


def encode(p: dict, buffers: dict, pos, degrees, seed_flag, node_mask, adj,
           cfg: dict, training: bool, gen=None, prec: str = "f32"):
    """(B, output_size) embeddings by the configuration's model (see
    ``models/<model>.py``)."""
    return model_module(model_name(cfg)).encode(
        p, buffers, pos, degrees, seed_flag, node_mask, adj, cfg,
        training=training, gen=gen, prec=prec)
