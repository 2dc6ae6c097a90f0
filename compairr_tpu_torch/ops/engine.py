"""Pair-matching engine: the routes of find_pairs and the dense matrix.

Port of compairr_tpu/ops/engine.py. The host routes (exact hash join,
pigeonhole piece grouping, variant join; ops/sparse_host.py) are the
same code. The device route is the dense engine: both sets are sorted
by a bucket key (V gene, J gene, length), a worklist lists the tile
pairs whose key ranges overlap, and a hand-written CUDA kernel
(ops/kernels.py, csrc/dense_match.cu) reduces the matched pairs'
scores into the [R1, R2] matrix in int64, so the result is exact in
any summation order.

Not ported yet, and raising NotImplementedError where a run needs
them: the sparse tile route of find_pairs (the Pallas count and
extract kernels) and the multi-device dense paths (parallel/mesh.py).

This module imports no torch: host-only routes never load it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.db import SeqDB
from ..utils.progress import Logger
from .sparse_host import (  # noqa: F401  (exact_match_groups re-exported)
    _find_pairs_exact,
    _find_pairs_pigeonhole,
    _find_pairs_pigeonhole_indel,
    _find_pairs_variant_join,
    exact_match_groups,
)

TILE_M = 128
TILE_N = 128

# Route probe: find_pairs records which execution route resolved the
# most recent call ("exact", "variant_join", "pigeonhole",
# "pigeonhole_indel"). Diagnostic only.
LAST_ROUTE: Optional[str] = None

# (value_s, source) of the measured dispatch round trip the tile route
# derives its routing constants from; that route is not ported yet, so
# this stays None and the CLI's -l log never reports it.
ROUTE_PROFILE_INFO: Optional[tuple] = None


def _note_route(name: str) -> None:
    global LAST_ROUTE
    LAST_ROUTE = name


class _PhaseTimer:
    """Opt-in coarse phase timing (COMPAIRR_TIMING=1): prints
    cumulative wall per labelled phase to stderr at the end of the run.
    Zero overhead when disabled. Host clock only: a lap that enqueues
    device work measures the enqueue, not the kernel."""

    def __init__(self) -> None:
        self.enabled = os.environ.get("COMPAIRR_TIMING") == "1"
        self._t = 0.0
        self._acc: dict[str, float] = {}

    def mark(self) -> None:
        if self.enabled:
            import time

            self._t = time.perf_counter()

    def lap(self, label: str) -> None:
        if self.enabled:
            import time

            now = time.perf_counter()
            self._acc[label] = self._acc.get(label, 0.0) + (now - self._t)
            self._t = now

    def report(self, prefix: str) -> None:
        if self.enabled and self._acc:
            import sys

            parts = " ".join(
                f"{k}={v:.2f}s" for k, v in self._acc.items()
            )
            print(f"[timing] {prefix}: {parts}", file=sys.stderr)


@dataclass(frozen=True)
class MatchSpec:
    differences: int
    indels: bool
    ignore_genes: bool
    exclude_self: bool = False  # cluster mode: seed != hit


_KEY_PAD = np.int64(1) << 62


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def canon_rows(n: int, tile: int) -> int:
    """Smallest padded row count >= n + tile (one all-pad dummy tile),
    tile-aligned, drawn from a ~1.25x geometric ladder, so the padded
    shapes take few distinct values across dataset sizes."""
    need = _round_up(n, tile) + tile
    s = tile
    while s < need:
        s = _round_up(int(s * 1.25) + 1, tile)
    return s


def pack_keys(db: SeqDB, tile: int, by_vjl: bool):
    """The bucket sort order and the sorted (padded) key vector; the
    row gathering happens on the device (kernels.device_args_raw).
    by_vjl keys rows by (v, j, length), the match precondition
    (CompAIRR src/overlap.cc:195-196), with the length in the low 16
    bits; otherwise by length alone. Returns
    (order int32[n], keys int64[npad], npad)."""
    n = db.n
    nj = max(len(db.genes.j_names), 1)
    npad = canon_rows(n, tile)
    if n:
        # native stable counting sort over the small (vj, len) bin
        # domain: one count and one scatter pass
        from ..io.native import pack_keys_native

        nat = pack_keys_native(db.v_no, db.j_no, db.lengths, nj, by_vjl)
        if nat is not None:
            order, keys_sorted = nat
            key = np.full(npad, _KEY_PAD, dtype=np.int64)
            key[:n] = keys_sorted
            return order, key, npad
    if by_vjl:
        vj = db.v_no.astype(np.int64) * nj + db.j_no.astype(np.int64)
        key_real = (vj << 16) | db.lengths.astype(np.int64)
    else:
        key_real = db.lengths.astype(np.int64)
    # int32 keys sort ~2x faster (radix passes scale with width)
    sort_view = (
        key_real.astype(np.int32)
        if n == 0 or key_real.max() < (1 << 31)
        else key_real
    )
    order = np.argsort(sort_view, kind="stable").astype(np.int32)
    key = np.full(npad, _KEY_PAD, dtype=np.int64)
    if n:
        key[:n] = key_real[order]
    return order, key, npad


def worklist_from_keys(
    keys_a: np.ndarray,
    n_a: int,
    keys_b: np.ndarray,
    n_b: int,
    delta: int,
    tile_m: int,
    tile_n: int,
) -> np.ndarray:
    """Tile worklist from sorted bucket keys: for each aligned row
    block, the compatible columns (keys within the block's key range
    +- the length tolerance) form one contiguous range. Tiles stay
    aligned to the global grid so no pair is ever visited twice.
    Returns int32 [T, 2] element starts (row, column)."""
    if n_a == 0 or n_b == 0:
        return np.zeros((0, 2), dtype=np.int32)
    kb = keys_b[:n_b]
    row_starts = np.arange(0, n_a, tile_m, dtype=np.int64)
    row_ends = np.minimum(row_starts + tile_m, n_a) - 1
    lo_keys = keys_a[row_starts] - delta
    hi_keys = keys_a[row_ends] + delta
    los = np.searchsorted(kb, lo_keys, side="left")
    his = np.searchsorted(kb, hi_keys, side="right")
    t0 = los // tile_n
    t1 = -(-his // tile_n)  # exclusive end in tile units
    per_row = np.where(his > los, t1 - t0, 0)
    total = int(per_row.sum())
    if total == 0:
        return np.zeros((0, 2), dtype=np.int32)
    out = np.empty((total, 2), dtype=np.int32)
    out[:, 0] = np.repeat(row_starts, per_row).astype(np.int32)
    offs = np.cumsum(per_row) - per_row
    ramp = np.arange(total, dtype=np.int64) - np.repeat(offs, per_row)
    out[:, 1] = ((np.repeat(t0, per_row) + ramp) * tile_n).astype(np.int32)
    return out


def classify_worklist(
    work: np.ndarray,
    keys_a: np.ndarray,
    n_a: int,
    keys_b: np.ndarray,
    n_b: int,
    tile_m: int,
    tile_n: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(has_eq, has_pm) per worklist tile: whether the tile can contain
    a pair with equal bucket keys (Hamming candidate) / keys differing
    by exactly one (one-indel candidate, len+-1 within a (v,j) bucket).

    Exact, not conservative: a tile's row block covers a contiguous
    index range of the sorted keys, so the key values present in it are
    precisely the distinct key values within its [lo, hi] key range;
    class existence reduces to range-restricted membership counts over
    the distinct key values, vectorised with prefix sums. The tile
    route (not ported yet) splits its worklist into kernel classes by
    these flags."""
    nt = len(work)
    if nt == 0 or n_a == 0 or n_b == 0:
        z = np.zeros(nt, dtype=bool)
        return z, z
    ua = np.unique(keys_a[:n_a])
    ub = np.unique(keys_b[:n_b])

    def member(vals):
        idx = np.searchsorted(ub, vals)
        idx = np.minimum(idx, len(ub) - 1)
        return ub[idx] == vals

    def prefix(flags):
        p = np.zeros(len(ua) + 1, dtype=np.int64)
        np.cumsum(flags, out=p[1:])
        return p

    p_eq = prefix(member(ua))
    p_up = prefix(member(ua + 1))
    p_dn = prefix(member(ua - 1))

    r0 = work[:, 0].astype(np.int64)
    c0 = work[:, 1].astype(np.int64)
    ka_lo = keys_a[r0]
    ka_hi = keys_a[np.minimum(r0 + tile_m, n_a) - 1]
    kb_lo = keys_b[np.minimum(c0, n_b - 1)]
    kb_hi = keys_b[np.minimum(c0 + tile_n, n_b) - 1]

    def any_in(p, lo, hi):
        i0 = np.searchsorted(ua, lo, side="left")
        i1 = np.searchsorted(ua, hi, side="right")
        return p[np.maximum(i1, i0)] - p[i0] > 0

    has_eq = any_in(
        p_eq, np.maximum(ka_lo, kb_lo), np.minimum(ka_hi, kb_hi)
    )
    # an up-pair needs a key u in the a-block with u+1 both present in
    # set b and inside the b-block's key range (u in [kb_lo-1, kb_hi-1])
    has_pm = any_in(
        p_up, np.maximum(ka_lo, kb_lo - 1), np.minimum(ka_hi, kb_hi - 1)
    ) | any_in(
        p_dn, np.maximum(ka_lo, kb_lo + 1), np.minimum(ka_hi, kb_hi + 1)
    )
    return has_eq, has_pm


def order_colmajor(work: np.ndarray) -> np.ndarray:
    """Column-major worklist order (b-block, then a-block): tiles that
    share a b-block run next to each other, so its rows stay in cache.
    Result-invariant: the dense sums are exact integers."""
    if len(work) == 0:
        return work
    return work[np.lexsort((work[:, 0], work[:, 1]))]


def _block_rep_stats(
    rep_sorted: np.ndarray,
    cnt_sorted: np.ndarray,
    n: int,
    tile: int,
    nblocks_pad: int,
    nrep: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Per row-block maxima over repertoires of (row count, duplicate
    count sum), on the packed (sorted) row order: a tile (rb, cb)'s
    contribution to any one matrix cell is bounded by products of
    these. The JAX engine's f32 exactness guard chunks its worklist by
    them; the dense path here sums in int64 and needs no guard, so only
    the host helpers of later routes read them."""
    m = np.zeros(nblocks_pad, dtype=np.float64)
    s = np.zeros(nblocks_pad, dtype=np.float64)
    if n == 0:
        return m, s
    blk = np.arange(n, dtype=np.int64) // tile
    idx = blk * nrep + rep_sorted[:n].astype(np.int64)
    size = (int(blk[-1]) + 1) * nrep
    cm = np.bincount(idx, minlength=size).astype(np.float64)
    cs = np.bincount(
        idx, weights=cnt_sorted[:n].astype(np.float64), minlength=size
    )
    cm = cm.reshape(-1, nrep)
    cs = cs.reshape(-1, nrep)
    m[: cm.shape[0]] = cm.max(axis=1)
    s[: cs.shape[0]] = cs.max(axis=1)
    return m, s


def _score_np(ca, cb, score_int: int, ignore_counts: bool):
    """compute_score on host in float64 (reference semantics,
    CompAIRR src/overlap.cc:144-166); ca [M, 1], cb [1, N]."""
    from ..constants import (
        SCORE_JACCARD,
        SCORE_MAX,
        SCORE_MH,
        SCORE_MIN,
        SCORE_PRODUCT,
        SCORE_RATIO,
    )

    if ignore_counts:
        return np.ones((ca.shape[0], cb.shape[1]), dtype=np.float64)
    if score_int in (SCORE_MH, SCORE_PRODUCT):
        return ca * cb
    if score_int == SCORE_RATIO:
        return ca / np.where(cb == 0, 1.0, cb)
    if score_int in (SCORE_JACCARD, SCORE_MIN):
        return np.minimum(ca + np.zeros_like(cb), cb)
    if score_int == SCORE_MAX:
        return np.maximum(ca + np.zeros_like(cb), cb)
    return (ca + cb) / 2.0


def _pair_distances(
    db1: SeqDB, db2: SeqDB, i1: np.ndarray, i2: np.ndarray
) -> np.ndarray:
    """Distances for matched pairs, recomputed on host: Hamming for
    equal lengths (pad residues match themselves), 1 for one-indel
    matches (lengths differ by one). Chunked to bound memory."""
    n = len(i1)
    dist = np.ones(n, dtype=np.int64)
    if n == 0:
        return dist
    w = min(db1.seqs.shape[1], db2.seqs.shape[1])
    l1 = db1.lengths[i1]
    l2 = db2.lengths[i2]
    eq = np.nonzero(l1 == l2)[0]
    for s0 in range(0, len(eq), 1 << 20):
        sel = eq[s0 : s0 + (1 << 20)]
        a = db1.seqs[i1[sel], :w]
        b = db2.seqs[i2[sel], :w]
        dist[sel] = (a != b).sum(axis=1)
    return dist


def dense_matrix(
    db1: SeqDB,
    db2: SeqDB,
    spec: MatchSpec,
    score_int: int,
    ignore_counts: bool,
    logger: Optional[Logger] = None,
    progress_prompt: Optional[str] = None,
    tile_m: int = TILE_M,
    tile_n: int = TILE_N,
    device=None,
) -> np.ndarray:
    """Dense path: the [R1, R2] overlap matrix, reduced on the device.

    Each side is sorted by its bucket key on host (pack_keys), the
    sorted rows are derived on the device (kernels.device_args_raw),
    and the dense_match kernel sums score(count_a, count_b) over every
    worklist pair with equal keys and at most d differing residues.
    Sums are int64, so the matrix is exact in any order (mean sums
    count_a + count_b and is halved here, once).

    device: "cuda" (the default), "cpu" (the kernel's plain PyTorch
    version), or None to read COMPAIRR_DEVICE; see utils.device.
    Configurations whose JAX kernels are not ported yet raise
    NotImplementedError (kernels._dense_kernel_kind)."""
    if spec.exclude_self:
        # the dense kernels do not implement self-exclusion (only the
        # sparse extraction carries per-row original indices)
        raise ValueError(
            "dense_matrix does not support exclude_self specs; use "
            "find_pairs (the sparse engine) for cluster-style matching"
        )
    from ..constants import SCORE_MEAN
    from ..utils.device import resolve_device
    from . import kernels as K

    dev = resolve_device(device)
    by_vjl = not spec.ignore_genes
    use_indels = spec.indels and spec.differences == 1
    lmax = _round_up(int(max(db1.longest, db2.longest, 1)), 8)
    r1p = _round_up(max(db1.repertoire_count, 1), 8)
    r2p = _round_up(max(db2.repertoire_count, 1), 128)

    shared = db2 is db1 and tile_m == tile_n
    order_a, key_a, npad_a = pack_keys(db1, tile_m, by_vjl)
    if shared:
        order_b, key_b, npad_b = order_a, key_a, npad_a
    else:
        order_b, key_b, npad_b = pack_keys(db2, tile_n, by_vjl)
    cmax = max(
        float(db1.counts.max()) if db1.n else 0.0,
        float(db2.counts.max()) if db2.n else 0.0,
    )
    kmax = max(
        int(key_a[: db1.n].max()) if db1.n else 0,
        int(key_b[: db2.n].max()) if db2.n else 0,
    )
    K._dense_kernel_kind(
        indels=use_indels, score_int=score_int,
        ignore_counts=ignore_counts, cmax=cmax, key_max=kmax,
    )

    da = K.device_args_raw(db1, order_a, npad_a, lmax, key_a, dev)
    db_dev = da if shared else K.device_args_raw(
        db2, order_b, npad_b, lmax, key_b, dev
    )
    work = order_colmajor(
        worklist_from_keys(key_a, db1.n, key_b, db2.n, 0, tile_m, tile_n)
    )
    if logger is not None and progress_prompt is not None:
        logger.progress_init(progress_prompt, max(len(work), 1))

    acc = K.dense_match(
        da, db_dev, K.upload_worklist(work, dev),
        differences=spec.differences,
        score_mode=K.score_mode(score_int, ignore_counts),
        tile_m=tile_m, tile_n=tile_n, r1p=r1p, r2p=r2p,
    )
    out = acc.cpu().numpy()[: db1.repertoire_count, : db2.repertoire_count]
    out = out.astype(np.float64)
    if score_int == SCORE_MEAN and not ignore_counts:
        out *= 0.5

    if logger is not None and progress_prompt is not None:
        logger.progress_update(len(work))
        logger.progress_done()
    return out


def variant_join_route(db1: SeqDB, db2: SeqDB, spec: MatchSpec) -> bool:
    """True when find_pairs will resolve this run through the
    asymmetric d=1 variant join (sparse_host.prepare_variant_join) —
    exposed so modes/overlap.py can precompute the join grouping
    during the duplicate-warning phase and reuse it.

    The variant join runs ONE grouping over (variants + big) rows; the
    pigeonhole runs d+1 groupings + gathers over everything. Cheaper
    while the variant rows cost less than the d extra full passes they
    replace."""
    if spec.differences != 1 or spec.indels:
        return False
    if os.environ.get("COMPAIRR_PIGEONHOLE", "1") in ("0", "all"):
        return False
    nmin = min(db1.n, db2.n)
    lmax = int(max(db1.longest, db2.longest, 1))
    alpha = 4 if db1.nucleotides else 20
    return (
        db2 is not db1
        and nmin <= (1 << 16)
        and nmin * lmax * alpha < db1.n + db2.n
    )


def find_pairs(
    db1: SeqDB,
    db2: SeqDB,
    spec: MatchSpec,
    logger: Optional[Logger] = None,
    progress_prompt: Optional[str] = None,
    exact_groups: Optional[tuple[np.ndarray, np.ndarray]] = None,
    vj_prep=None,
    want_dist: bool = True,
) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Sparse path: all matching pairs under the spec.

    Returns (idx1, idx2, dist) in original indices, unordered.
    exact_groups optionally carries a precomputed exact_match_groups
    result (d=0 only). Runs the host routes: the exact hash join at
    d=0, the pigeonhole grouping (or the asymmetric variant join) for
    substitutions, and, under COMPAIRR_PIGEONHOLE=all, the indel
    pigeonhole. Runs those routes hand to the device tile engine raise
    NotImplementedError until its kernels are ported.
    """
    if spec.differences == 0:
        _note_route("exact")
        return _find_pairs_exact(
            db1, db2, spec, logger, progress_prompt, exact_groups
        )

    # self-comparison diagonal fast path: every sequence matches itself
    # at any d, so a same-set run excludes i==i pairs from the search
    # and appends them afterwards for free.
    add_diagonal = db2 is db1 and not spec.exclude_self
    if add_diagonal:
        from dataclasses import replace

        spec = replace(spec, exclude_self=True)

    def with_diagonal(i1, i2, dist):
        if add_diagonal and db1.n:
            diag = np.arange(db1.n, dtype=np.int64)
            i1 = np.concatenate([diag, i1])
            i2 = np.concatenate([diag, i2])
            if dist is not None:
                dist = np.concatenate(
                    [np.zeros(db1.n, dtype=np.int64), dist]
                )
        return i1, i2, dist

    # routing: substitution-only runs go through the pigeonhole host
    # path; indel runs take the tile engine unless
    # COMPAIRR_PIGEONHOLE=all forces the host indel pigeonhole.
    mode = os.environ.get("COMPAIRR_PIGEONHOLE", "1")
    if mode != "0":
        if spec.indels and spec.differences == 1:
            route = "pigeonhole_indel"
            ph = (
                _find_pairs_pigeonhole_indel(
                    db1, db2, spec, logger, progress_prompt
                )
                if mode == "all"
                else None
            )
        else:
            if vj_prep is not None or variant_join_route(db1, db2, spec):
                route = "variant_join"
                ph = _find_pairs_variant_join(
                    db1, db2, spec, logger, progress_prompt, prep=vj_prep
                )
            else:
                route = "pigeonhole"
                ph = _find_pairs_pigeonhole(
                    db1, db2, spec, logger, progress_prompt
                )
        if ph is not None:
            _note_route(route)
            return with_diagonal(*ph)

    raise NotImplementedError(
        "the sparse tile route of find_pairs (indel runs, "
        "COMPAIRR_PIGEONHOLE=0, candidate-budget overflows) is not "
        "ported yet: it needs the count and extract kernels "
        "(compairr_tpu/ops/pallas_kernels.py count_tiles_pallas and "
        "extract_tiles_pallas)"
    )
