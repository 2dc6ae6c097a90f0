"""Canonical variant ordering of matched pairs.

The reference enumerates variants of each seed in a fixed order —
identity, substitutions (pos, residue), deletions (pos), insertions
(pos, residue), double substitutions (pos1, res1, pos2, res2); see
CompAIRR src/variants.cc:260-428 — and its pair and cluster
outputs inherit that order. Our engine finds matches on a dense grid,
so to reproduce the reference's single-threaded output order we
reconstruct, for every matched pair (seed s, hit t), the key of the
unique variant of s that equals t, and sort by it.

Deletions/insertions are canonicalised to the leftmost position of a
run of equal residues (variants.cc:299-353); given the pair, that
position is len(short) - common_suffix_length.
"""

from __future__ import annotations

import numpy as np

KIND_IDENTICAL = 0
KIND_SUBSTITUTION = 1
KIND_DELETION = 2
KIND_INSERTION = 3
KIND_SUB_SUB = 4


def _common_prefix_suffix(
    s: np.ndarray, ls: np.ndarray, t: np.ndarray, lt: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per pair: common prefix length (front-aligned) and common suffix
    length (end-aligned) of two padded sequence matrices."""
    k, lmax = s.shape
    minlen = np.minimum(ls, lt)
    pos = np.arange(lmax)[None, :]
    eq_f = (s == t) & (pos < minlen[:, None])
    prefix = np.where(eq_f.all(axis=1), minlen, np.argmin(eq_f, axis=1))

    # end-aligned: reverse each row within its own length
    def _rev(x, lx):
        idx = lx[:, None] - 1 - pos
        idx_c = np.clip(idx, 0, lmax - 1)
        return np.take_along_axis(x, idx_c, axis=1)

    rs = _rev(s, ls)
    rt = _rev(t, lt)
    eq_b = (rs == rt) & (pos < minlen[:, None])
    suffix = np.where(eq_b.all(axis=1), minlen, np.argmin(eq_b, axis=1))
    return prefix.astype(np.int64), suffix.astype(np.int64)


def variant_sort_keys(
    seqs1: np.ndarray,
    len1: np.ndarray,
    seqs2: np.ndarray,
    len2: np.ndarray,
    idx1: np.ndarray,
    idx2: np.ndarray,
) -> np.ndarray:
    """Compute a lexicographic sort key per matched pair reproducing the
    reference's per-seed hit order.

    Args are the full padded arrays for both sets (same padded width)
    and the matched index arrays. Returns an int64 [K, 5] key array
    (kind, pos1, res1, pos2, res2).
    """
    s = seqs1[idx1].astype(np.int16)
    t = seqs2[idx2].astype(np.int16)
    ls = len1[idx1].astype(np.int64)
    lt = len2[idx2].astype(np.int64)
    k, lmax = s.shape
    pos = np.arange(lmax)[None, :]

    keys = np.zeros((k, 5), dtype=np.int64)

    equal_len = ls == lt
    if equal_len.any():
        e = np.nonzero(equal_len)[0]
        se, te, le = s[e], t[e], ls[e]
        diff = (se != te) & (pos < le[:, None])
        nd = diff.sum(axis=1)
        first = np.argmax(diff, axis=1)
        last = lmax - 1 - np.argmax(diff[:, ::-1], axis=1)
        r_first = np.take_along_axis(te, first[:, None], axis=1)[:, 0]
        r_last = np.take_along_axis(te, last[:, None], axis=1)[:, 0]

        kk = np.zeros((len(e), 5), dtype=np.int64)
        is_sub = nd == 1
        kk[is_sub, 0] = KIND_SUBSTITUTION
        kk[is_sub, 1] = first[is_sub]
        kk[is_sub, 2] = r_first[is_sub]
        is_ss = nd == 2
        kk[is_ss, 0] = KIND_SUB_SUB
        kk[is_ss, 1] = first[is_ss]
        kk[is_ss, 2] = r_first[is_ss]
        kk[is_ss, 3] = last[is_ss]
        kk[is_ss, 4] = r_last[is_ss]
        keys[e] = kk

    deletion = lt == ls - 1
    if deletion.any():
        d = np.nonzero(deletion)[0]
        _, suf = _common_prefix_suffix(s[d], ls[d], t[d], lt[d])
        del_pos = lt[d] - np.minimum(suf, lt[d])
        kk = np.zeros((len(d), 5), dtype=np.int64)
        kk[:, 0] = KIND_DELETION
        kk[:, 1] = del_pos
        keys[d] = kk

    insertion = lt == ls + 1
    if insertion.any():
        i = np.nonzero(insertion)[0]
        _, suf = _common_prefix_suffix(s[i], ls[i], t[i], lt[i])
        ins_pos = ls[i] - np.minimum(suf, ls[i])
        res = np.take_along_axis(
            t[i], np.minimum(ins_pos, lmax - 1)[:, None], axis=1
        )[:, 0]
        kk = np.zeros((len(i), 5), dtype=np.int64)
        kk[:, 0] = KIND_INSERTION
        kk[:, 1] = ins_pos
        kk[:, 2] = res
        keys[i] = kk

    return keys


def sort_pairs_reference_order(
    seqs1: np.ndarray,
    len1: np.ndarray,
    seqs2: np.ndarray,
    len2: np.ndarray,
    idx1: np.ndarray,
    idx2: np.ndarray,
) -> np.ndarray:
    """Return a permutation sorting pairs by (seed, variant key, hit),
    the single-threaded reference emission order
    (CompAIRR src/overlap.cc:376-507)."""
    keys = variant_sort_keys(seqs1, len1, seqs2, len2, idx1, idx2)
    return np.lexsort(
        (idx2, keys[:, 4], keys[:, 3], keys[:, 2], keys[:, 1], keys[:, 0], idx1)
    )
