"""Exact-match grouping on host.

The reference resolves exact matches through Zobrist hashes + an
open-addressing hash table (CompAIRR src/hashtable.cc,
zobrist.cc). Those are latency-optimised CPU structures; here the same
semantics — group sequences that are identical under the active match
criterion — are a vectorised numpy sort/unique over fixed-width key
rows, which is both simpler and far faster per element for bulk data,
and keeps the device free for the approximate-matching grids.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils import trace
from .db import SeqDB


def group_ids(
    db: SeqDB,
    *,
    include_genes: bool,
    include_rep: bool,
    progress=None,
) -> tuple[np.ndarray, int]:
    """Assign a group id to every sequence.

    Two entries share a group iff their sequences are identical and
    (when include_genes) their V and J genes match and (when
    include_rep) they belong to the same repertoire — the exact
    duplicate criterion of hash_insert (CompAIRR src/overlap.cc:63-128)
    and dedup's process() (CompAIRR src/dedup.cc:60-132).

    Returns (inverse, n_groups) where inverse[i] is the group id of
    sequence i, numbered by first occurrence order.
    """
    n = db.n
    if n == 0:
        return np.zeros(0, dtype=np.int64), 0

    meta_cols: list[np.ndarray] = []
    if include_genes:
        meta_cols.append(db.v_no.astype(np.int32))
        meta_cols.append(db.j_no.astype(np.int32))
    if include_rep:
        meta_cols.append(db.rep_no.astype(np.int32))
    meta = (
        np.ascontiguousarray(np.stack(meta_cols, axis=1))
        if meta_cols
        else np.zeros((n, 0), dtype=np.int32)
    )
    return group_rows(
        db.seqs, meta, db.pad_value, prehash=db.row_hash,
        progress=progress,
    )


def group_rows(
    seqs: np.ndarray,
    meta: np.ndarray,
    pad_value: int,
    prehash: Optional[np.ndarray] = None,
    progress=None,
) -> tuple[np.ndarray, int]:
    """Group identical (row, meta) records, ids numbered by first
    occurrence. Padded rows are injective (the pad code is not a
    residue), so length needn't join the key. Native open-addressing
    pass when available (~5x the numpy sort-based path at Keck scale);
    numpy hash-sort-verify fallback otherwise. prehash optionally
    carries the parser's per-row content hashes (equal rows share a
    hash by construction; collisions are resolved exactly either way).
    """
    n = len(seqs)
    if n == 0:
        return np.zeros(0, dtype=np.int64), 0

    from ..io.native import group_rows_native

    nat = group_rows_native(seqs, meta, prehash, progress=progress)
    if nat is not None:
        return nat

    if meta.shape[1] % 2:
        meta = np.concatenate(
            [meta, np.zeros((n, 1), dtype=np.int32)], axis=1
        )
    meta = np.ascontiguousarray(meta, dtype=np.int32)

    # hash-first exact grouping: a 64-bit wrapping polynomial hash per
    # row over 8-byte words, then exact verification only inside
    # equal-hash runs. A direct np.unique over 40-byte void rows costs
    # ~90 s at 24M rows; this is an order of magnitude cheaper and
    # provably identical (equal rows always share a hash; unequal rows
    # that collide are separated by the exact subset pass).
    width = seqs.shape[1]
    w8 = -(-width // 8) * 8
    if width == w8 and seqs.flags.c_contiguous:
        seqs8 = seqs
    else:
        seqs8 = np.full((n, w8), pad_value, dtype=np.int8)
        seqs8[:, :width] = seqs
    seq_words = seqs8.view("<u8")
    meta_words = meta.view("<u8")

    h = np.zeros(n, dtype=np.uint64)
    mult = np.uint64(0x9E3779B97F4A7C15)
    for c in range(meta_words.shape[1]):
        h *= mult
        h += meta_words[:, c]
    for c in range(seq_words.shape[1]):
        h *= mult
        h += seq_words[:, c]
    order = np.argsort(h, kind="stable")
    hs = h[order]
    # a sorted position is part of a multi-element hash run iff it
    # shares its hash with either neighbour
    same_prev = np.empty(n, dtype=bool)
    same_prev[0] = False
    np.equal(hs[1:], hs[:-1], out=same_prev[1:])
    in_multi = same_prev.copy()
    in_multi[:-1] |= same_prev[1:]

    # representative (= smallest original index) per group
    rep = np.arange(n, dtype=np.int64)  # singles represent themselves
    multi_rows = order[in_multi]
    if len(multi_rows):
        sub = np.concatenate(
            [meta[multi_rows].view(np.int8), seqs8[multi_rows]], axis=1
        )
        sub = np.ascontiguousarray(sub)
        void = sub.view([("k", np.void, sub.shape[1])]).ravel()
        _, sub_inv = np.unique(void, return_inverse=True)
        sub_inv = sub_inv.reshape(-1)
        rep_sub = np.full(int(sub_inv.max()) + 1, n, dtype=np.int64)
        np.minimum.at(rep_sub, sub_inv, multi_rows)
        rep[multi_rows] = rep_sub[sub_inv]

    # group ids numbered by first occurrence == ascending representative;
    # rank the representatives without sorting (they are indices < n)
    is_rep = np.zeros(n, dtype=bool)
    is_rep[rep] = True
    gid_of_index = np.cumsum(is_rep, dtype=np.int64) - 1
    return gid_of_index[rep], int(gid_of_index[-1]) + 1


def count_duplicates(
    db: SeqDB,
    *,
    include_genes: bool,
    match_groups: Optional[np.ndarray] = None,
    progress=None,
) -> int:
    """Number of entries that have an earlier exact duplicate
    (same repertoire + genes-unless-ignored + sequence), i.e. the
    counts behind the reference's duplicate warnings
    (CompAIRR src/overlap.cc:579-605,861-873).

    When the (sequence, genes) grouping was already computed (the d=0
    match join needs the same one), pass it as match_groups: the
    repertoire refinement then only groups int64 pairs instead of
    re-hashing every residue row."""
    with trace.span("core.dup") as sp:
        sp.count("rows", db.n)
        if match_groups is not None:
            return db.n - count_refined_groups(match_groups, db.rep_no)
        _, n_groups = group_ids(
            db, include_genes=include_genes, include_rep=True,
            progress=progress,
        )
        return db.n - n_groups


def count_refined_groups(groups: np.ndarray, extra: np.ndarray) -> int:
    """Number of distinct (group, extra) pairs."""
    n = len(groups)
    if n == 0:
        return 0
    key = groups.astype(np.int64) * (int(extra.max()) + 1) + extra
    rows = np.ascontiguousarray(key).view(np.int8).reshape(n, 8)
    _, n_groups = group_rows(rows, np.zeros((n, 0), dtype=np.int32), 0)
    return n_groups
