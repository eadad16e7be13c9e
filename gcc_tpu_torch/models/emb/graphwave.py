"""GraphWave baseline embedder (reference gcc/models/emb/graphwave.py +
gcc/models/emb/_graphwave/*; method from Donnat et al., KDD 2018).

Structural embeddings from spectral heat-kernel wavelets: the wavelet of
node i is column i of exp(-s L); each node is embedded by sampling the
empirical characteristic function φ_i(t) = mean_j exp(i·s·Ψ_ij) at a
grid of t values. The heat kernel is applied with a Chebyshev polynomial
approximation of the matrix exponential (no eigendecomposition of the
full graph). Host-side numpy/scipy baseline.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from gcc_tpu_torch.graph.csr import CSRGraph


class GraphWave:
    def __init__(self, dimension: int, scales=(5.0, 10.0), order: int = 30,
                 **kwargs):
        self.dimension = dimension
        self.scales = scales
        self.order = order

    def train(self, graph: CSRGraph) -> np.ndarray:
        n = graph.num_nodes
        adj = sp.csr_matrix(
            (np.ones(graph.num_edges, dtype=np.float64),
             graph.indices.astype(np.int64), graph.indptr),
            shape=(n, n),
        )
        deg = np.asarray(adj.sum(axis=1)).ravel()
        lap = sp.diags(deg) - adj  # unnormalized Laplacian (reference
        # _graphwave/utils/graph_tools.py:12-17)
        lmax = _lanczos_lmax(lap)

        # Sample points per scale so the total embedding width is
        # `dimension` (2 features per sample point: Re, Im).
        pts_per_scale = max(1, self.dimension // (2 * len(self.scales)))
        t_grid = np.linspace(0, 100, pts_per_scale)

        chunks = []
        for s in self.scales:
            psi = _chebyshev_heat(lap, s, lmax, self.order)  # (n, n)
            # Characteristic function over each node's wavelet.
            # φ_i(t) = mean_j exp(1j * t * psi[j, i])
            feats = np.empty((n, 2 * pts_per_scale))
            for k, t in enumerate(t_grid):
                z = np.exp(1j * t * psi)
                mean = z.mean(axis=0)
                feats[:, 2 * k] = mean.real
                feats[:, 2 * k + 1] = mean.imag
            chunks.append(feats)
        emb = np.concatenate(chunks, axis=1)
        if emb.shape[1] < self.dimension:
            emb = np.pad(emb, ((0, 0), (0, self.dimension - emb.shape[1])))
        return emb[:, : self.dimension]


def _lanczos_lmax(lap: sp.spmatrix) -> float:
    from scipy.sparse.linalg import eigsh

    try:
        return float(eigsh(lap, k=1, which="LA",
                           return_eigenvectors=False)[0]) * 1.01
    except Exception:
        # Gershgorin upper bound fallback.
        return float(2 * lap.diagonal().max() + 1e-9)


def _chebyshev_heat(lap: sp.spmatrix, s: float, lmax: float,
                    order: int) -> np.ndarray:
    """exp(-s·L) via Chebyshev expansion on [0, lmax] applied to I."""
    from scipy.special import ive

    n = lap.shape[0]
    a = lmax / 2.0
    # Rescaled operator: L' = (L - a I)/a with spectrum in [-1, 1].
    identity = sp.eye(n, format="csr")
    lp = (lap - a * identity) * (1.0 / a)

    # Chebyshev coefficients of exp(-s·a·(x+1)) on x ∈ [-1, 1]:
    # c_k = 2 e^{-s a} i_k(-s a)... use scaled Bessel for stability.
    k = np.arange(order + 1)
    coeffs = 2.0 * ive(k, -s * a) * np.exp(-s * a + abs(-s * a))
    coeffs[0] /= 2.0

    # Dense recurrence memory: ~4 live (n, n) f64 arrays — 8.5 GB at the
    # 16384 cap, sized to the measured host (125 GB; baseline eval runs
    # once per graph). Beyond it, sub-sample or use the GCC giant path.
    t_prev = np.eye(n)
    t_cur = lp.toarray() if n <= 16384 else None
    if t_cur is None:
        raise ValueError("GraphWave dense path limited to n <= 16384")
    out = coeffs[0] * t_prev + coeffs[1] * t_cur
    for i in range(2, order + 1):
        t_next = 2 * (lp @ t_cur) - t_prev
        out += coeffs[i] * t_next
        t_prev, t_cur = t_cur, t_next
    return out
