"""Host-side sparse matching paths.

Exact (d=0) hash joins, pigeonhole piece grouping for substitution
distances, the one-indel pigeonhole variant, and the asymmetric d=1
variant-join — all built on the native open-addressing grouping
(core/exact.py group_rows). These resolve the reference's variant-hash
workloads (CompAIRR src/variants.cc, overlap.cc:253-284) on the
host CPU; the tile engine in ops/engine.py remains the device
path for indel grids, candidate blow-ups, and dense throughput.
find_pairs (ops/engine.py) routes between them.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np

from ..core.db import SeqDB
from ..utils.progress import Logger

if TYPE_CHECKING:  # annotation-only; engine imports this module
    from .engine import MatchSpec

def exact_match_groups(
    db1: SeqDB, db2: SeqDB, spec: MatchSpec
) -> tuple[np.ndarray, np.ndarray]:
    """Union (sequence, v, j) grouping over both sets: two entries
    match at d=0 iff they share a group. Shared by the duplicate-
    warning refinement and the d=0 join."""
    from ..core.exact import group_rows

    def meta_of(db):
        if spec.ignore_genes:
            return np.zeros((db.n, 0), dtype=np.int32)
        return np.ascontiguousarray(
            np.stack(
                [db.v_no.astype(np.int32), db.j_no.astype(np.int32)],
                axis=1,
            )
        )

    if db2 is db1:
        ga, _ng = group_rows(
            db1.seqs, meta_of(db1), db1.pad_value, prehash=db1.row_hash
        )
        return ga, ga
    w = max(db1.seqs.shape[1], db2.seqs.shape[1])
    db1.repad(w)
    db2.repad(w)
    seqs = np.concatenate([db1.seqs, db2.seqs], axis=0)
    meta = np.concatenate([meta_of(db1), meta_of(db2)], axis=0)
    prehash = (
        np.concatenate([db1.row_hash, db2.row_hash])
        if db1.row_hash is not None and db2.row_hash is not None
        else None
    )
    g, _ng = group_rows(seqs, meta, db1.pad_value, prehash=prehash)
    return g[: db1.n], g[db1.n :]


def _find_pairs_exact(
    db1: SeqDB,
    db2: SeqDB,
    spec: MatchSpec,
    logger: Optional[Logger] = None,
    progress_prompt: Optional[str] = None,
    exact_groups: Optional[tuple[np.ndarray, np.ndarray]] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """d=0 fast path: exact matching is a hash join on
    (sequence, v, j) — the grid engine (and its multi-hundred-MB
    device upload) is pure overhead for it. Semantics identical to the
    tile path at d=0: pairs match iff sequences equal and genes equal
    unless ignore_genes (CompAIRR src/overlap.cc:195-196);
    exclude_self drops i==j self-pairs of a self-comparison
    (CompAIRR src/cluster.cc:105)."""
    n1, n2 = db1.n, db2.n
    same = db2 is db1
    if logger is not None and progress_prompt is not None:
        logger.progress_init(progress_prompt, max(n1, 1))

    if exact_groups is not None:
        ga, gb = exact_groups
    else:
        ga, gb = exact_match_groups(db1, db2, spec)

    i1, i2 = _join_groups(
        ga, gb, drop_singletons=spec.exclude_self and same
    )
    if spec.exclude_self and same:
        keep = i1 != i2
        i1, i2 = i1[keep], i2[keep]

    if logger is not None and progress_prompt is not None:
        logger.progress_update(max(n1, 1))
        logger.progress_done()
    return i1, i2, np.zeros(len(i1), dtype=np.int64)


def _join_groups(
    ga: np.ndarray, gb: np.ndarray, drop_singletons: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """All (set-1 row, set-2 row) pairs sharing a group id. Group
    extents come from a bincount (a searchsorted pair costs ~2x at
    Keck scale), and rows whose group has exactly one set-2 member —
    virtually all of a deduplicated repertoire — emit through a
    gather instead of the generic variable-repeat path.

    drop_singletons (same-set callers that filter i != j afterwards):
    a singleton group's only pair is its self pair, so the huge
    mostly-diagonal singleton emission — ~24M of ~24.5M pairs at Keck
    scale, ~1.2 GB of transient int64 arrays per grouping pass — is
    skipped entirely, and only rows in multi-member groups (~1% at
    Keck scale) are argsorted; the stable subset sort preserves the
    full sort's within-group member order, so the emitted pair order
    is unchanged."""
    ng = int(max(ga.max(initial=-1), gb.max(initial=-1))) + 1
    i1_parts: list[np.ndarray] = []
    i2_parts: list[np.ndarray] = []
    if drop_singletons:
        gcnt_all = np.bincount(gb, minlength=ng)
        rows_b = np.nonzero(gcnt_all[gb] > 1)[0]
        sub = gb[rows_b]
        order2 = rows_b[np.argsort(sub, kind="stable")]
        gcnt = np.bincount(sub, minlength=ng)
        gstart = np.cumsum(gcnt) - gcnt
        if ga is gb:
            multi_rows = rows_b
            mg = sub
        else:
            multi_rows = np.nonzero(gcnt[ga] > 1)[0]
            mg = ga[multi_rows]
        mcnt = gcnt[mg]
        starts_m = gstart[mg]
    else:
        order2 = np.argsort(gb, kind="stable")
        gcnt = np.bincount(gb, minlength=ng)
        gstart = np.cumsum(gcnt) - gcnt
        starts = gstart[ga]
        cnt = gcnt[ga]
        one = cnt == 1
        multi_rows = np.nonzero(cnt > 1)[0]
        mcnt = cnt[multi_rows]
        starts_m = starts[multi_rows]
        i1_parts.append(np.nonzero(one)[0].astype(np.int64))
        i2_parts.append(order2[starts[one]])
    if len(multi_rows):
        total = int(mcnt.sum())
        i1_parts.append(np.repeat(multi_rows, mcnt).astype(np.int64))
        offs = np.cumsum(mcnt) - mcnt
        ramp = np.arange(total, dtype=np.int64) - np.repeat(offs, mcnt)
        i2_parts.append(order2[np.repeat(starts_m, mcnt) + ramp])
    if not i1_parts:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy()
    return np.concatenate(i1_parts), np.concatenate(i2_parts)


# Candidate budget for the pigeonhole path: beyond this many candidate
# pairs (duplicate- or motif-heavy data) the dense tile engine wins.
PIGEONHOLE_MAX_CANDIDATES = 1 << 26


def _piece_rows(db: SeqDB, p: int, pieces: int, w_max: int) -> np.ndarray:
    """[n, w_max] int8 view of each row's p-th length-proportional
    piece, padded with the pad code. Chunked gather to bound the int64
    index temporaries at Keck scale."""
    n = db.n
    lens = db.lengths.astype(np.int64)
    out = np.empty((n, w_max), dtype=np.int8)
    ar = np.arange(w_max, dtype=np.int64)
    W = db.seqs.shape[1]
    for s0 in range(0, n, 1 << 22):
        s1 = min(s0 + (1 << 22), n)
        ls = lens[s0:s1]
        starts = (ls * p) // pieces
        ends = (ls * (p + 1)) // pieces
        idx = starts[:, None] + ar[None, :]
        valid = idx < ends[:, None]
        np.clip(idx, 0, W - 1, out=idx)
        chunk = np.take_along_axis(db.seqs[s0:s1], idx, axis=1)
        chunk[~valid] = db.pad_value
        out[s0:s1] = chunk
    return out


class VariantJoinPrep:
    """Precomputed state for the asymmetric d=1 variant join.

    Built during the duplicate-warning phase (modes/overlap.py) so the
    expensive pass over the big set runs once: `gb` — the big set's
    (sequence, genes) group ids — yields the big set's duplicate count
    for free (refined by repertoire), and find_pairs reuses the whole
    structure for the join itself. `pairs` carries the native join's
    (seed, big row) candidates directly; the numpy fallback instead
    carries `gv`, the variant rows' ids in the union grouping."""

    __slots__ = (
        "pairs", "gv", "gb", "small_is_1", "W", "ns", "big_distinct"
    )

    def __init__(self, gb, small_is_1, W, ns, pairs=None, gv=None,
                 big_distinct=None):
        self.pairs = pairs
        self.gv = gv
        self.gb = gb
        self.small_is_1 = small_is_1
        self.W = W
        self.ns = ns
        # distinct (sequence, genes, repertoire) count of the big set
        # (the native join counts it during its build)
        self.big_distinct = big_distinct


def prepare_variant_join(
    db1: SeqDB, db2: SeqDB, spec: MatchSpec
) -> VariantJoinPrep:
    """Resolve every single-substitution variant of the smaller set
    (the reference's generate_variants_1,
    CompAIRR src/variants.cc:280-293) against the larger set.
    A variant equals a big-set row iff the pair matches, so no
    verification pass is needed.

    Native path (pack_group.cpp variant_join): open-addressing table
    over the big set — reusing the parser's row hashes — probed by
    variants materialised one at a time in a scratch buffer. Fallback:
    one big tensor of variant rows grouped together with the big set's
    rows through group_rows."""
    from ..core.exact import group_rows
    from ..io.native import variant_join_native

    n1, n2 = db1.n, db2.n
    small_is_1 = n1 <= n2
    dbs, dbb = (db1, db2) if small_is_1 else (db2, db1)
    ns = dbs.n
    A = 4 if db1.nucleotides else 20

    lmax = int(max(db1.longest, db2.longest, 1))
    db1.repad(lmax)
    db2.repad(lmax)
    W = lmax

    nat = variant_join_native(dbs, dbb, spec.ignore_genes)
    if nat is not None:
        i_s, i_b, gb, n_distinct = nat
        return VariantJoinPrep(
            gb=gb, small_is_1=small_is_1, W=W, ns=ns, pairs=(i_s, i_b),
            big_distinct=n_distinct,
        )

    base = np.ascontiguousarray(dbs.seqs[:, :W])
    V = np.broadcast_to(base[:, None, None, :], (ns, W, A, W)).copy()
    for p in range(W):
        V[:, p, :, p] = np.arange(A, dtype=np.int8)[None, :]
    # variants mutating pad columns would fabricate longer sequences;
    # -1 never occurs in real rows, so they can't join anything
    invalid = np.arange(W)[None, :] >= dbs.lengths[:, None]
    V4 = V.reshape(ns, W, A * W)
    V4[invalid] = -1
    V = V.reshape(ns * W * A, W)

    def genes_of(db):
        if spec.ignore_genes:
            return np.zeros((db.n, 0), dtype=np.int32)
        return np.ascontiguousarray(
            np.stack(
                [db.v_no.astype(np.int32), db.j_no.astype(np.int32)],
                axis=1,
            )
        )

    rows = np.concatenate([V, dbb.seqs[:, :W]], axis=0)
    meta = np.concatenate(
        [np.repeat(genes_of(dbs), W * A, axis=0), genes_of(dbb)], axis=0
    )
    g, _ng = group_rows(rows, meta, db1.pad_value)
    del rows, V
    return VariantJoinPrep(
        gb=g[ns * W * A :], small_is_1=small_is_1, W=W, ns=ns,
        gv=g[: ns * W * A],
    )


def _find_pairs_variant_join(
    db1: SeqDB,
    db2: SeqDB,
    spec: MatchSpec,
    logger: Optional[Logger] = None,
    progress_prompt: Optional[str] = None,
    prep: Optional[VariantJoinPrep] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Asymmetric d=1 substitution matching via the precomputed union
    grouping (prepare_variant_join): one grouping over
    (small x L x A + big) rows replaces the pigeonhole's d+1 passes
    over the full union — the win when one side is tiny (existence
    queries)."""
    n1, n2 = db1.n, db2.n
    started = logger is not None and progress_prompt is not None
    if started:
        logger.progress_init(progress_prompt, 2)

    if prep is None:
        prep = prepare_variant_join(db1, db2, spec)
    small_is_1 = prep.small_is_1
    dbs, dbb = (db1, db2) if small_is_1 else (db2, db1)
    W = prep.W
    if started:
        logger.progress_update(1)

    if prep.pairs is not None:
        i_s, i_b = prep.pairs
        keys = np.unique(i_s * np.int64(dbb.n) + i_b)
    else:
        iv, ib = _join_groups(prep.gv, prep.gb)
        A = 4 if db1.nucleotides else 20
        seed = iv // (W * A)
        keys = np.unique(seed * np.int64(dbb.n) + ib)
    i_s = keys // dbb.n
    i_b = keys - i_s * dbb.n
    i1, i2 = (i_s, i_b) if small_is_1 else (i_b, i_s)

    dist = np.empty(len(i1), dtype=np.int64)
    for s0 in range(0, len(i1), 1 << 20):
        sel = slice(s0, min(s0 + (1 << 20), len(i1)))
        dist[sel] = (
            db1.seqs[i1[sel], :W] != db2.seqs[i2[sel], :W]
        ).sum(axis=1)

    if started:
        logger.progress_update(2)
        logger.progress_done()
    return i1, i2, dist


def _find_pairs_pigeonhole(
    db1: SeqDB,
    db2: SeqDB,
    spec: MatchSpec,
    logger: Optional[Logger] = None,
    progress_prompt: Optional[str] = None,
) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Substitution-only d>=1 matching by exact piece grouping.

    Any pair at Hamming distance <= d over equal-length sequences
    leaves at least one of d+1 length-proportional pieces untouched,
    so grouping rows d+1 times — once per piece, on (piece residues,
    length, v, j) — yields a candidate superset, verified here by a
    vectorised Hamming pass. This is the host-side analogue of the
    reference's variant hashing (CompAIRR src/variants.cc): it
    finds the same pairs without enumerating the O(L^d A^d) variant
    space or shipping every row through the device grid.

    Returns None when candidates exceed the budget (duplicate-heavy
    data) — the caller falls back to the dense tile engine, whose cost
    does not grow with match density.
    """
    from ..core.exact import group_rows
    from .engine import _PhaseTimer

    tm = _PhaseTimer()
    tm.mark()
    pieces = spec.differences + 1
    n1, n2 = db1.n, db2.n
    same = db2 is db1
    started = logger is not None and progress_prompt is not None
    ntotal = n1 if same else n1 + n2  # rows per grouping pass
    if started:
        # progress in rows: pieces+1 phases of ntotal rows each (d+1
        # grouping passes + the verification pass), ticked mid-pass by
        # the native grouping's row counter for interactive parity with
        # the reference's ~200 redraws (CompAIRR src/util.cc:28)
        logger.progress_init(progress_prompt, (pieces + 1) * max(ntotal, 1))
    if n1 == 0 or n2 == 0:
        z = np.zeros(0, dtype=np.int64)
        if started:
            logger.progress_done()
        return z, z, z

    lmax = int(max(db1.longest, db2.longest, 1))
    w_max = -(-lmax // pieces)

    def meta_of(db):
        cols = [db.lengths.astype(np.int32)]
        if not spec.ignore_genes:
            cols.append(db.v_no.astype(np.int32))
            cols.append(db.j_no.astype(np.int32))
        return np.ascontiguousarray(np.stack(cols, axis=1))

    if same:
        metas = meta_of(db1)
        g_seqs, g_lens = db1.seqs, db1.lengths
    else:
        metas = np.concatenate([meta_of(db1), meta_of(db2)], axis=0)
        w = max(db1.seqs.shape[1], db2.seqs.shape[1])
        db1.repad(w)
        db2.repad(w)
        g_seqs = np.concatenate([db1.seqs, db2.seqs], axis=0)
        g_lens = np.concatenate([db1.lengths, db2.lengths])

    from ..io.native import group_pieces_native

    cand_keys: list[np.ndarray] = []
    budget = PIGEONHOLE_MAX_CANDIDATES
    for p in range(pieces):
        # fused native pass reads the piece ranges in place; the numpy
        # fallback materialises gathered piece rows first
        tick = (
            (lambda v, _p=p: logger.progress_update(
                _p * ntotal + min(v, ntotal)))
            if started
            else None
        )
        nat = group_pieces_native(
            g_seqs, g_lens, metas, p, pieces, progress=tick
        )
        tm.lap(f"group_p{p}")
        if nat is not None:
            g, _ng = nat
        else:
            if same:
                rows = _piece_rows(db1, p, pieces, w_max)
            else:
                rows = np.concatenate(
                    [
                        _piece_rows(db1, p, pieces, w_max),
                        _piece_rows(db2, p, pieces, w_max),
                    ],
                    axis=0,
                )
            g, _ng = group_rows(rows, metas, db1.pad_value)
            del rows
        ga, gb = (g, g) if same else (g[:n1], g[n1:])

        # candidate volume guard before emission; a same-set run's n
        # guaranteed self-hits are free (filtered below), only the
        # extras count against the budget
        ng = int(g.max()) + 1
        gcnt_b = np.bincount(gb, minlength=ng)
        est = int(gcnt_b[ga].sum())
        if same:
            est -= n1
        budget -= est
        if budget < 0:
            return None

        i1, i2 = _join_groups(ga, gb, drop_singletons=same)
        if same:
            keep = i1 != i2
            i1, i2 = i1[keep], i2[keep]
        cand_keys.append(i1 * np.int64(n2) + i2)
        tm.lap(f"join_p{p}")
        if started:
            logger.progress_update((p + 1) * ntotal)

    keys = np.unique(np.concatenate(cand_keys))
    i1 = keys // n2
    i2 = keys - i1 * n2
    tm.lap("unique")

    # exact verification: genes/length already agree by construction,
    # only the Hamming bound needs checking
    w = min(db1.seqs.shape[1], db2.seqs.shape[1])
    dist = np.empty(len(i1), dtype=np.int64)
    for s0 in range(0, len(i1), 1 << 20):
        sel = slice(s0, min(s0 + (1 << 20), len(i1)))
        dist[sel] = (
            db1.seqs[i1[sel], :w] != db2.seqs[i2[sel], :w]
        ).sum(axis=1)
    ok = dist <= spec.differences
    i1, i2, dist = i1[ok], i2[ok], dist[ok]
    tm.lap("verify")
    tm.report("pigeonhole")

    if started:
        logger.progress_update((pieces + 1) * ntotal)
        logger.progress_done()
    return i1, i2, dist


def _role_piece_rows(
    db: SeqDB, side: str, w_max: int
) -> tuple[np.ndarray, np.ndarray]:
    """Virtual rows for the one-indel pigeonhole: each physical row
    appears twice, once as the shorter member of a cross-length pair
    (pairlen = len) and once as the longer (pairlen = len - 1). The
    piece is the first (side='prefix') or last (side='suffix')
    h = floor((pairlen+1)/2) residues — a single insertion at position
    p in the longer sequence leaves the prefix intact when p >= h and
    the suffix intact when p <= pairlen - h, and with this h one of
    the two always holds. Returns (piece_rows [2n, w_max], pairlen
    [2n])."""
    n = db.n
    lens = db.lengths.astype(np.int64)
    pairlen = np.concatenate([lens, lens - 1])
    h = (pairlen + 1) // 2
    out = np.full((2 * n, w_max), db.pad_value, dtype=np.int8)
    ar = np.arange(w_max, dtype=np.int64)
    W = db.seqs.shape[1]
    both_lens = np.concatenate([lens, lens])
    for s0 in range(0, 2 * n, 1 << 22):
        s1 = min(s0 + (1 << 22), 2 * n)
        hs = h[s0:s1]
        if side == "prefix":
            idx = np.broadcast_to(ar[None, :], (s1 - s0, w_max)).copy()
        else:
            idx = (both_lens[s0:s1] - hs)[:, None] + ar[None, :]
        valid = ar[None, :] < hs[:, None]
        np.clip(idx, 0, W - 1, out=idx)
        phys = np.arange(s0, s1) % n
        chunk = np.take_along_axis(db.seqs[phys], idx, axis=1)
        chunk[~valid] = db.pad_value
        out[s0:s1] = chunk
    return out, pairlen.astype(np.int32)


def _find_pairs_pigeonhole_indel(
    db1: SeqDB,
    db2: SeqDB,
    spec: MatchSpec,
    logger: Optional[Logger] = None,
    progress_prompt: Optional[str] = None,
) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """d=1 with indels: candidates = equal-length half groupings (the
    substitution component) plus prefix/suffix role groupings (the
    cross-length component), verified exactly. The one-indel criterion
    is check_variant's deletion test (CompAIRR src/variants.cc:197-216):
    common prefix + common suffix >= min(len)."""
    from ..core.exact import group_rows

    n1, n2 = db1.n, db2.n
    same = db2 is db1
    started = logger is not None and progress_prompt is not None
    if started:
        logger.progress_init(progress_prompt, 5)
    if n1 == 0 or n2 == 0:
        z = np.zeros(0, dtype=np.int64)
        if started:
            logger.progress_done()
        return z, z, z

    lmax = int(max(db1.longest, db2.longest, 1))
    budget = PIGEONHOLE_MAX_CANDIDATES
    cand_keys: list[np.ndarray] = []
    done = 0

    def genes_of(db):
        if spec.ignore_genes:
            return np.zeros((db.n, 0), dtype=np.int32)
        return np.stack(
            [db.v_no.astype(np.int32), db.j_no.astype(np.int32)], axis=1
        )

    def add_candidates(g, n_virt1, virt_to_phys1, virt_to_phys2,
                       self_free):
        nonlocal budget
        ga = g[:n_virt1]
        gb = g if same else g[n_virt1:]
        ng = int(g.max()) + 1
        gcnt_b = np.bincount(gb, minlength=ng)
        est = int(gcnt_b[ga].sum())
        if self_free:
            est -= len(ga)
        budget -= est
        if budget < 0:
            return False
        # same-set: any singleton's only pair maps to (phys, phys) —
        # the two virtual copies of one physical row always differ in
        # pairlen, hence never share a group
        i1, i2 = _join_groups(ga, gb, drop_singletons=same)
        p1 = virt_to_phys1[i1]
        p2 = virt_to_phys2[i2]
        if same:
            keep = p1 != p2
            p1, p2 = p1[keep], p2[keep]
        cand_keys.append(p1 * np.int64(n2) + p2)
        return True

    # equal-length halves (substitution component incl. d=0)
    w_half = -(-lmax // 2)
    phys1 = np.arange(n1, dtype=np.int64)
    phys2 = np.arange(n2, dtype=np.int64)
    for p in range(2):
        if same:
            rows = _piece_rows(db1, p, 2, w_half)
            meta = np.ascontiguousarray(
                np.concatenate(
                    [db1.lengths.astype(np.int32)[:, None],
                     genes_of(db1)],
                    axis=1,
                )
            )
        else:
            rows = np.concatenate(
                [
                    _piece_rows(db1, p, 2, w_half),
                    _piece_rows(db2, p, 2, w_half),
                ],
                axis=0,
            )
            meta = np.ascontiguousarray(
                np.concatenate(
                    [
                        np.concatenate(
                            [db1.lengths.astype(np.int32)[:, None],
                             genes_of(db1)],
                            axis=1,
                        ),
                        np.concatenate(
                            [db2.lengths.astype(np.int32)[:, None],
                             genes_of(db2)],
                            axis=1,
                        ),
                    ],
                    axis=0,
                )
            )
        g, _ng = group_rows(rows, meta, db1.pad_value)
        del rows
        if not add_candidates(g, n1, phys1, phys2, self_free=same):
            return None
        done += 1
        if started:
            logger.progress_update(done)

    # cross-length prefix/suffix role groupings
    w_role = (lmax + 2) // 2
    vp1 = np.concatenate([phys1, phys1])
    vp2 = np.concatenate([phys2, phys2])
    for side in ("prefix", "suffix"):
        if same:
            rows, pairlen = _role_piece_rows(db1, side, w_role)
            meta = np.ascontiguousarray(
                np.concatenate(
                    [pairlen[:, None],
                     np.tile(genes_of(db1), (2, 1))],
                    axis=1,
                )
            )
        else:
            rows1, pl1 = _role_piece_rows(db1, side, w_role)
            rows2, pl2 = _role_piece_rows(db2, side, w_role)
            rows = np.concatenate([rows1, rows2], axis=0)
            meta = np.ascontiguousarray(
                np.concatenate(
                    [
                        np.concatenate(
                            [pl1[:, None],
                             np.tile(genes_of(db1), (2, 1))],
                            axis=1,
                        ),
                        np.concatenate(
                            [pl2[:, None],
                             np.tile(genes_of(db2), (2, 1))],
                            axis=1,
                        ),
                    ],
                    axis=0,
                )
            )
        g, _ng = group_rows(rows, meta, db1.pad_value)
        del rows
        # same-set role joins include each virtual row's own hit
        if not add_candidates(g, 2 * n1, vp1, vp2, self_free=same):
            return None
        done += 1
        if started:
            logger.progress_update(done)

    keys = np.unique(np.concatenate(cand_keys))
    i1 = keys // n2
    i2 = keys - i1 * n2

    # exact verification: equal lengths -> Hamming <= 1; lengths off
    # by one -> common prefix + common suffix >= min(len); other
    # length gaps are impossible by construction but rejected anyway
    l1 = db1.lengths[i1].astype(np.int64)
    l2 = db2.lengths[i2].astype(np.int64)
    w = min(db1.seqs.shape[1], db2.seqs.shape[1])
    dist = np.ones(len(i1), dtype=np.int64)
    ok = np.zeros(len(i1), dtype=bool)
    for s0 in range(0, len(i1), 1 << 20):
        sel = slice(s0, min(s0 + (1 << 20), len(i1)))
        a = db1.seqs[i1[sel], :w]
        b = db2.seqs[i2[sel], :w]
        la = l1[sel]
        lb = l2[sel]
        eq_len = la == lb
        hd = (a != b).sum(axis=1)
        cross = np.abs(la - lb) == 1
        lmin = np.minimum(la, lb)
        eq = a == b
        pre = (np.cumprod(eq, axis=1) != 0).sum(axis=1)
        # suffix: compare right-aligned via per-row reversed gathers
        ar = np.arange(w, dtype=np.int64)
        ia = np.clip(la[:, None] - 1 - ar[None, :], 0, w - 1)
        ib = np.clip(lb[:, None] - 1 - ar[None, :], 0, w - 1)
        ra = np.take_along_axis(a, ia, axis=1)
        rb = np.take_along_axis(b, ib, axis=1)
        req = (ra == rb) & (ar[None, :] < lmin[:, None])
        suf = (np.cumprod(req, axis=1) != 0).sum(axis=1)
        ok[sel] = (eq_len & (hd <= 1)) | (cross & (pre + suf >= lmin))
        dist[sel] = np.where(eq_len, hd, 1)
    i1, i2, dist = i1[ok], i2[ok], dist[ok]

    if started:
        logger.progress_update(5)
        logger.progress_done()
    return i1, i2, dist


