"""Cross-graph author similarity search (reference
gcc/tasks/similarity_search.py:19-69): L2-normalize both embedding sets,
rank by dot product, report Recall@{20,40} over authors present in both
conference graphs."""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def evaluate_similarity(
    emb_1: np.ndarray, emb_2: np.ndarray, dict_1: dict, dict_2: dict,
    k_list=(20, 40),
) -> dict:
    shared = [
        key for key in set(dict_1) & set(dict_2)
        if dict_1[key] < emb_1.shape[0] and dict_2[key] < emb_2.shape[0]
    ]
    emb_1 = emb_1 / np.linalg.norm(emb_1, axis=1, keepdims=True)
    emb_2 = emb_2 / np.linalg.norm(emb_2, axis=1, keepdims=True)
    reindex = [dict_2[key] for key in shared]
    reindex_dict = {x: i for i, x in enumerate(reindex)}
    emb_2 = emb_2[reindex]

    results = defaultdict(list)
    for key in shared:
        scores = emb_2 @ emb_1[dict_1[key]]
        idxs = scores.argsort()[::-1]
        for k in k_list:
            results[k].append(int(reindex_dict[dict_2[key]] in idxs[:k]))
    return {f"Recall @ {k}": float(np.mean(results[k])) for k in k_list}


class SimilaritySearch:
    def __init__(self, dataset_1: str, dataset_2: str, hidden_size: int,
                 model: str = "from_numpy_align", data_root: str = "data",
                 **model_args):
        from gcc_tpu_torch.data.formats import SSDataset
        from gcc_tpu_torch.models.emb import build_model

        self.data = SSDataset(f"{data_root}/panther", dataset_1, dataset_2).data
        self.model = build_model(model, hidden_size, **model_args)

    def train(self) -> dict:
        emb_1 = self.model.train(self.data[0].graph)
        emb_2 = self.model.train(self.data[1].graph)
        return evaluate_similarity(
            emb_1, emb_2, self.data[0].names, self.data[1].names
        )
