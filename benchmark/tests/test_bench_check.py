"""The training check's change number reads the median leaf: the rounding
of one element of one small leaf, which Adam's sign-like first steps can
blow up to a fifth of that element's move, leaves it alone, while a change
of every leaf shows in full."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import check


def _leaves():
    gen = torch.Generator().manual_seed(0)
    return {f"leaf{i}": torch.randn(64 * (i + 1), generator=gen) * 1e-6
            for i in range(9)}


def test_one_element_off_moves_the_worst_leaf_not_the_median():
    ref = _leaves()
    prog = {n: t.clone() for n, t in ref.items()}
    top = int(ref["leaf0"].abs().argmax())
    prog["leaf0"][top] *= 1.2
    gaps = check._leaf_gaps(prog, ref, list(ref))
    assert max(gaps) > 1e-3
    assert float(np.median(gaps)) == 0.0


def test_every_leaf_off_shows_in_the_median():
    ref = _leaves()
    prog = {n: 0.9 * t for n, t in ref.items()}
    gaps = check._leaf_gaps(prog, ref, list(ref))
    assert float(np.median(gaps)) == pytest.approx(0.1, rel=1e-5)
    unchanged = {n: torch.zeros_like(t) for n, t in ref.items()}
    assert float(np.median(check._leaf_gaps(unchanged, ref,
                                            list(ref)))) == 1.0
