"""Pair scoring and matrix post-processing.

Mirrors compute_score (CompAIRR src/overlap.cc:144-166) and the
Morisita-Horn / Jaccard transforms (overlap.cc:540-577). Matrix cells
are float64 like the reference's m_val_t (overlap.cc:44); sums of
integer products/mins/maxes/means are exact in f64, so accumulation
order does not affect those outputs.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    SCORE_JACCARD,
    SCORE_MAX,
    SCORE_MEAN,
    SCORE_MH,
    SCORE_MIN,
    SCORE_PRODUCT,
    SCORE_RATIO,
)


def pair_scores(
    c1: np.ndarray, c2: np.ndarray, score_int: int, ignore_counts: bool
) -> np.ndarray:
    if ignore_counts:
        return np.ones(len(c1), dtype=np.float64)
    a = c1.astype(np.float64)
    b = c2.astype(np.float64)
    if score_int in (SCORE_MH, SCORE_PRODUCT):
        return a * b
    if score_int == SCORE_RATIO:
        return a / b
    if score_int in (SCORE_JACCARD, SCORE_MIN):
        return np.minimum(c1, c2).astype(np.float64)
    if score_int == SCORE_MAX:
        return np.maximum(c1, c2).astype(np.float64)
    if score_int == SCORE_MEAN:
        return (a + b) / 2
    raise AssertionError("Internal error")


def matrix_cell_value(
    raw: float,
    score_int: int,
    s: int,
    t: int,
    set1_count: np.ndarray,
    set1_sq_count: np.ndarray,
    set2_count: np.ndarray,
    set2_sq_count: np.ndarray,
) -> float:
    """Post-process one matrix cell (overlap.cc:540-577)."""
    if score_int == SCORE_MH:
        sp = raw
        lx = set1_sq_count[s] / set1_count[s] / set1_count[s]
        ly = set2_sq_count[t] / set2_count[t] / set2_count[t]
        xy = 1.0 * set1_count[s] * set2_count[t]
        return (2.0 * sp) / ((lx + ly) * xy)
    if score_int == SCORE_JACCARD:
        sm = raw
        sa = float(set1_count[s])
        sb = float(set2_count[t])
        return sm / (sa + sb - sm)
    return raw


def fmt(value: float) -> str:
    """%.10lg formatting (overlap.cc:559,569,574)."""
    return f"{value:.10g}"


def matrix_values(
    matrix: np.ndarray,
    score_int: int,
    rows_are_reps: bool,
    set1_count: np.ndarray,
    set1_sq_count: np.ndarray,
    set2_count: np.ndarray,
    set2_sq_count: np.ndarray,
) -> np.ndarray:
    """Vectorised matrix_cell_value over the whole matrix (the
    existence layout has sequence rows, so MH/Jaccard — matrix-mode
    only — never apply there; rows_are_reps marks matrix mode)."""
    if score_int == SCORE_MH and rows_are_reps:
        lx = set1_sq_count / set1_count / set1_count
        ly = set2_sq_count / set2_count / set2_count
        xy = np.outer(set1_count.astype(np.float64), set2_count)
        return (2.0 * matrix) / ((lx[:, None] + ly[None, :]) * xy)
    if score_int == SCORE_JACCARD and rows_are_reps:
        sa = set1_count.astype(np.float64)[:, None]
        sb = set2_count.astype(np.float64)[None, :]
        return matrix / (sa + sb - matrix)
    return matrix
