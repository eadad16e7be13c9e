"""Frozen-embedding node classification (reference
gcc/tasks/node_classification.py:26-101).

Protocol: 10-fold stratified CV, one-vs-rest LogisticRegression(C=1000),
predicting the top-k labels per node where k = that node's true label
count, scored with micro-F1. scikit-learn runs on the host and is
imported inside the functions that need it, so importing the package
(and generating embeddings) does not need it installed.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def predict_topk(clf, x, top_k_list):
    """Each sample's top-k labels by probability from a fitted
    one-vs-rest classifier (reference TopKRanker,
    node_classification.py:90-101)."""
    assert x.shape[0] == len(top_k_list)
    probs = np.asarray(clf.predict_proba(x))
    preds = np.zeros_like(probs)
    for i, k in enumerate(top_k_list):
        labels = clf.classes_[probs[i].argsort()[-k:]]
        preds[i, labels] = 1
    return preds


def evaluate_node_embeddings(
    embeddings: np.ndarray, label_matrix: np.ndarray, seed: int = 0
) -> dict:
    """10-fold CV micro-F1 (reference _evaluate, node_classification.py:53-88)."""
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import f1_score
    from sklearn.model_selection import StratifiedKFold
    from sklearn.multiclass import OneVsRestClassifier

    skf = StratifiedKFold(n_splits=10, shuffle=True, random_state=seed)
    labels = label_matrix.argmax(axis=1)
    results = defaultdict(list)
    for train_idx, test_idx in skf.split(np.zeros(len(labels)), labels):
        clf = OneVsRestClassifier(LogisticRegression(C=1000))
        clf.fit(embeddings[train_idx], label_matrix[train_idx])
        top_k_list = label_matrix[test_idx].sum(axis=1).astype(int).tolist()
        preds = predict_topk(clf, embeddings[test_idx], top_k_list)
        results[""].append(
            f1_score(label_matrix[test_idx], preds, average="micro")
        )
    return {
        f"Micro-F1{k}": float(np.mean(v)) for k, v in sorted(results.items())
    }


class NodeClassification:
    """Dataset + embedding-source wrapper mirroring the reference task CLI
    (node_classification.py:26-51): the embedding source is a registered
    model ("from_numpy", "prone", "graphwave", "zero", ...)."""

    def __init__(self, dataset: str, hidden_size: int, seed: int = 0,
                 model: str = "from_numpy", data_root: str = "data",
                 **model_args):
        from gcc_tpu_torch.data.formats import create_node_classification_dataset
        from gcc_tpu_torch.models.emb import build_model

        self.data = create_node_classification_dataset(dataset, data_root)
        self.model = build_model(model, hidden_size, **model_args)
        self.seed = seed

    def train(self) -> dict:
        emb = self.model.train(self.data.graph)
        assert emb.shape[0] == self.data.graph.num_nodes
        return evaluate_node_embeddings(emb, self.data.y, self.seed)
