"""Embedding-source adapters for the task evaluators (reference
gcc/models/emb/from_numpy.py:7-54). All operate on a CSRGraph + node
count instead of a networkx graph; node ids are already dense."""

from __future__ import annotations

import numpy as np


class Zero:
    """All-zeros baseline."""

    def __init__(self, hidden_size: int, **kwargs):
        self.hidden_size = hidden_size

    def train(self, graph) -> np.ndarray:
        return np.zeros((graph.num_nodes, self.hidden_size))


class FromNumpy:
    """Load a saved .npy embedding matrix (node-indexed)."""

    def __init__(self, hidden_size: int, emb_path: str = "", **kwargs):
        self.hidden_size = hidden_size
        self.emb = np.load(emb_path)

    def train(self, graph) -> np.ndarray:
        assert graph.num_nodes == self.emb.shape[0]
        return self.emb


class FromNumpyGraph(FromNumpy):
    """Graph-level embeddings (no node graph involved)."""

    def train(self, graph=None) -> np.ndarray:
        assert graph is None
        return self.emb


class FromNumpyAlign:
    """Two .npy matrices matched to two graphs by node count (the
    similarity-search protocol, reference from_numpy.py:34-54)."""

    def __init__(self, hidden_size: int, emb_path_1: str = "",
                 emb_path_2: str = "", **kwargs):
        self.hidden_size = hidden_size
        self.emb_1 = np.load(emb_path_1)
        self.emb_2 = np.load(emb_path_2)
        self._used_1 = False
        self._used_2 = False

    def train(self, graph) -> np.ndarray:
        if graph.num_nodes == self.emb_1.shape[0] and not self._used_1:
            self._used_1 = True
            return self.emb_1
        if graph.num_nodes == self.emb_2.shape[0] and not self._used_2:
            self._used_2 = True
            return self.emb_2
        raise ValueError("embedding/graph size mismatch")
