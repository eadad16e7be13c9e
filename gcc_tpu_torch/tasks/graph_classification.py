"""Frozen-embedding graph classification (reference
gcc/tasks/graph_classification.py:28-64): 10-fold stratified CV with
SVC(C=100000), accuracy reported under the "Micro-F1" key for parity
with the reference's output format."""

from __future__ import annotations

import numpy as np


def evaluate_graph_embeddings(
    embeddings: np.ndarray, labels: np.ndarray, seed: int = 0,
    standardize: bool = False,
) -> dict:
    """standardize=True z-scores features with a StandardScaler fit on
    each fold's TRAIN split only (no test leakage) — the RBF SVC is
    scale-sensitive, and raw pooled-sum readouts span orders of
    magnitude across feature columns; the reference protocol feeds
    L2-normalized scores so it never needed this."""
    from sklearn.metrics import accuracy_score
    from sklearn.model_selection import StratifiedKFold
    from sklearn.svm import SVC

    kf = StratifiedKFold(n_splits=10, shuffle=True, random_state=seed)
    accuracies = []
    for train_idx, test_idx in kf.split(embeddings, labels):
        tr, te = embeddings[train_idx], embeddings[test_idx]
        if standardize:
            from sklearn.preprocessing import StandardScaler

            scaler = StandardScaler().fit(tr)
            tr, te = scaler.transform(tr), scaler.transform(te)
        clf = SVC(C=100000)
        clf.fit(tr, labels[train_idx])
        accuracies.append(accuracy_score(labels[test_idx], clf.predict(te)))
    return {"Micro-F1": float(np.mean(accuracies))}


class GraphClassification:
    def __init__(self, dataset: str, hidden_size: int, seed: int = 0,
                 model: str = "from_numpy_graph", data_root: str = "data",
                 **model_args):
        from gcc_tpu_torch.data.tu import load_tu_dataset
        from gcc_tpu_torch.models.emb import build_model

        self.graphs, self.labels = load_tu_dataset(dataset, data_root)
        self.model = build_model(model, hidden_size, **model_args)
        self.seed = seed

    def train(self) -> dict:
        emb = self.model.train(None)
        return evaluate_graph_embeddings(emb, self.labels, self.seed)
