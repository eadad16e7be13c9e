"""Raw evaluation-dataset loaders.

Same file formats and reindexing conventions as the reference
(gcc/datasets/data_util.py:61-215): `.edgelist`/`.nodelabel` pairs for
node classification (with the h-index median binarization), panther
`.graph`/`.dict` weighted multigraphs for similarity search, and the
name→path registry. Outputs are CSRGraph + numpy labels instead of
torch tensors.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from gcc_tpu_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class NodeDataset:
    graph: CSRGraph
    y: np.ndarray               # (num_nodes, num_classes) multi-hot
    node2id: dict[int, int]
    # Similarity-search graphs carry a name→node-id map instead of class
    # labels (reference keeps both in `y`; a separate field keeps the
    # types honest — y stays an array, names stays a dict).
    names: dict[str, int] | None = None


class Edgelist:
    """`.edgelist` + `.nodelabel`: first-seen reindexing, both edge
    directions inserted, one-hot labels; names containing "hindex" use
    raw labels binarized at the median (data_util.py:61-108)."""

    def __init__(self, root: str, name: str):
        edge_path = os.path.join(root, name + ".edgelist")
        label_path = os.path.join(root, name + ".nodelabel")
        node2id: dict[int, int] = {}
        src, dst = [], []
        with open(edge_path) as f:
            for line in f:
                x, y = map(int, line.split())
                for v in (x, y):
                    if v not in node2id:
                        node2id[v] = len(node2id)
                src.append(node2id[x])
                dst.append(node2id[y])
        num_nodes = len(node2id)

        nodes, labels = [], []
        label2id: dict[int, int] = {}
        hindex = "hindex" in name
        with open(label_path) as f:
            for line in f:
                x, lab = map(int, line.split())
                if lab not in label2id:
                    label2id[lab] = len(label2id)
                nodes.append(node2id[x])
                labels.append(lab if hindex else label2id[lab])
        if hindex:
            median = np.median(labels)
            labels = [int(l > median) for l in labels]
            num_classes = 2
        else:
            num_classes = len(label2id)
        assert num_nodes == len(set(nodes))
        y = np.zeros((num_nodes, num_classes), dtype=np.float32)
        y[nodes, labels] = 1

        graph = CSRGraph.from_edges(np.array(src), np.array(dst),
                                    num_nodes=num_nodes, symmetrize=True)
        self.data = NodeDataset(graph=graph, y=y, node2id=node2id)


class SSSingleDataset:
    """panther `.graph`: header line, then `u v t` rows — the edge is
    repeated t times in BOTH directions (multiplicity preserved,
    data_util.py:128-139)."""

    def __init__(self, root: str, name: str):
        graph, node2id = _read_panther_graph(
            os.path.join(root, name + ".graph")
        )
        self.data = NodeDataset(graph=graph, y=None, node2id=node2id)


class SSDataset:
    """Two panther graphs + `.dict` name→raw-id maps for similarity
    search (data_util.py:146-187)."""

    def __init__(self, root: str, name1: str, name2: str):
        self.data = []
        for name in (name1, name2):
            graph, node2id = _read_panther_graph(
                os.path.join(root, name + ".graph")
            )
            name_dict = {}
            with open(os.path.join(root, name + ".dict")) as f:
                for line in f:
                    author, str_x = line.rsplit("\t", 1)
                    x = int(str_x)
                    if x not in node2id:
                        node2id[x] = len(node2id)
                    name_dict[author] = node2id[x]
            self.data.append(
                NodeDataset(graph=graph, y=np.zeros((0, 0), np.float32),
                            node2id=node2id, names=name_dict)
            )


def _read_panther_graph(path: str) -> tuple[CSRGraph, dict[int, int]]:
    node2id: dict[int, int] = {}
    src, dst = [], []
    with open(path) as f:
        f.readline()  # header
        for line in f:
            x, y, t = map(int, line.split())
            for v in (x, y):
                if v not in node2id:
                    node2id[v] = len(node2id)
            src.extend([node2id[x]] * t)
            dst.extend([node2id[y]] * t)
    graph = CSRGraph.from_edges(np.array(src), np.array(dst),
                                num_nodes=len(node2id), symmetrize=True)
    return graph, node2id


# Name→path registry (reference data_util.py:193-215).
_AIRPORT = {
    "usa_airport": "usa-airports",
    "brazil_airport": "brazil-airports",
    "europe_airport": "europe-airports",
}
_HINDEX = {
    "h-index-rand-1": "aminer_hindex_rand1_5000",
    "h-index-top-1": "aminer_hindex_top1_5000",
    "h-index": "aminer_hindex_rand20intop200_5000",
}
PANTHER = ["kdd", "icdm", "sigir", "cikm", "sigmod", "icde"]

GRAPH_CLASSIFICATION_DSETS = [
    "imdb-binary", "imdb-multi", "rdt-b", "rdt-5k", "collab",
]


def create_node_classification_dataset(
    name: str, data_root: str = "data"
) -> NodeDataset:
    if "airport" in name:
        return Edgelist(os.path.join(data_root, "struc2vec"),
                        _AIRPORT[name]).data
    if "h-index" in name:
        return Edgelist(os.path.join(data_root, "hindex"),
                        _HINDEX[name]).data
    if name in PANTHER:
        return SSSingleDataset(os.path.join(data_root, "panther"), name).data
    raise NotImplementedError(name)
