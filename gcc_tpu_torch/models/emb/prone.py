"""ProNE baseline embedder (reference gcc/models/emb/prone.py:10-108;
method from Zhang et al., IJCAI 2019).

Two stages: (1) sparse NetMF-style matrix factorization via randomized
truncated SVD of log-transformed transition-minus-negative matrix;
(2) spectral propagation with a Chebyshev-Gaussian filter. Host-side
scipy/sklearn — baselines are CPU eval scaffolding, not the device path
(SURVEY.md §2b N14).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.special import iv

from gcc_tpu_torch.graph.csr import CSRGraph


def _csr_to_scipy(g: CSRGraph) -> sp.csr_matrix:
    return sp.csr_matrix(
        (np.ones(g.num_edges, dtype=np.float64),
         g.indices.astype(np.int64), g.indptr),
        shape=(g.num_nodes, g.num_nodes),
    )


class ProNE:
    def __init__(self, dimension: int, step: int = 5, mu: float = 0.2,
                 theta: float = 0.5, **kwargs):
        self.dimension = dimension
        self.step = step
        self.mu = mu
        self.theta = theta

    def train(self, graph: CSRGraph) -> np.ndarray:
        adj = _csr_to_scipy(graph)
        features = self._factorize(adj)
        return self._chebyshev_propagate(adj, features)

    # -- stage 1: sparse matrix factorization --------------------------------

    def _factorize(self, adj: sp.csr_matrix) -> np.ndarray:
        from sklearn.utils.extmath import randomized_svd

        n = adj.shape[0]
        deg = np.maximum(np.asarray(adj.sum(axis=1)).ravel(), 1e-12)
        # Row-normalized transition matrix, log-transformed, minus a
        # degree^0.75 negative-sampling log-prior.
        trans = sp.diags(1.0 / deg) @ adj
        neg = np.asarray(adj.sum(axis=0)).ravel() ** 0.75
        neg = neg / neg.sum()
        neg_mat = adj @ sp.diags(neg)

        trans = trans.tocsr()
        neg_mat = neg_mat.tocsr()
        trans.data = np.log(np.maximum(trans.data, 1e-12) /
                            np.maximum(neg_mat.data, 1e-12))
        u, s, _ = randomized_svd(trans, n_components=self.dimension,
                                 n_iter=5, random_state=0)
        emb = u * np.sqrt(s)
        return _l2_rows(emb)

    # -- stage 2: Chebyshev-Gaussian spectral propagation --------------------

    def _chebyshev_propagate(self, adj: sp.csr_matrix,
                             a: np.ndarray) -> np.ndarray:
        if self.step == 1:
            return a
        n = adj.shape[0]
        a_hat = sp.eye(n) + adj
        deg = np.maximum(np.asarray(a_hat.sum(axis=1)).ravel(), 1e-12)
        lap = sp.eye(n) - sp.diags(1.0 / deg) @ a_hat
        m = lap - self.mu * sp.eye(n)

        lx0 = a
        lx1 = m @ a
        lx1 = 0.5 * (m @ lx1) - a

        conv = iv(0, self.theta) * lx0 - 2 * iv(1, self.theta) * lx1
        for i in range(2, self.step):
            lx2 = m @ lx1
            lx2 = (m @ lx2 - 2 * lx1) - lx0
            sign = 1 if i % 2 == 0 else -1
            conv += sign * 2 * iv(i, self.theta) * lx2
            lx0, lx1 = lx1, lx2
        emb = a_hat @ (a - conv)
        # Dense SVD for the final orthogonalized embedding.
        u, s, _ = np.linalg.svd(emb, full_matrices=False)
        u = u[:, : self.dimension] * np.sqrt(s[: self.dimension])
        return _l2_rows(u)


def _l2_rows(x: np.ndarray) -> np.ndarray:
    norm = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.where(norm == 0, 1, norm)
