"""Pair-matching engine: the routes of find_pairs and the dense matrix.

Port of compairr_tpu/ops/engine.py. The host routes (exact hash join,
pigeonhole piece grouping, variant join; ops/sparse_host.py) are the
same code. Both sets are sorted by a bucket key (V gene, J gene,
length) and a worklist lists the tile pairs whose key ranges can match;
two device routes then run hand-written CUDA kernels (ops/kernels.py):

  * the dense engine (dense_matrix) reduces the matched pairs' scores
    into the [R1, R2] matrix with one of four kernels, chosen as the
    JAX package chooses among v3, v2, v2c and v1: dense_match
    (csrc/dense_match.cu; no indels, keys below 2^31, integer scores
    with counts below 2^16), dense_onehot (csrc/dense_onehot.cu; the
    same runs under COMPAIRR_V3=0, as an int8 one-hot product on the
    tensor cores), dense_indel (csrc/dense_general.cu; the same with
    -d 1 -i) and dense_general (csrc/dense_general.cu; every other run:
    ratio, min/max/Jaccard with a count above 64, counts >= 2^16, keys
    >= 2^31, with or without the indel). Integer sums are int64, exact
    in any order; ratio, and runs where a cell could pass 2^62, sum in
    float64;
  * the tile route of find_pairs (csrc/tile_match.cu) counts the
    matches of every worklist tile, drops the empty tiles and extracts
    the matched pairs of the rest in one launch a tile class, each
    tile's pairs of original indices written to the slots that the
    prefix sum of the counts gives it. It serves every
    one-indel run (-d 1 -i), every run under COMPAIRR_PIGEONHOLE=0 and
    every pigeonhole candidate-budget overflow (card_route).

Over several devices the tile route splits every class stream of its
worklist into contiguous spans, one a device, each device holding a
replica of both sets' rows; the dense engine's shards (parallel/mesh.py)
run dense_plan and dense_side once, and side_span / dense_span a shard.

This module imports no torch: host-only routes never load it.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.db import SeqDB
from ..utils import trace
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
# "pigeonhole_indel", "tiles") and, for "tiles", the rows of its tiles.
# Diagnostic only.
LAST_ROUTE: Optional[str] = None
LAST_TILE: Optional[int] = None


def _note_route(name: str, tile: Optional[int] = None) -> None:
    global LAST_ROUTE, LAST_TILE
    LAST_ROUTE, LAST_TILE = name, tile
    trace.note("route", name)
    if tile is not None:
        trace.note("tile", tile)


class _PhaseTimer:
    """Opt-in coarse phase timing (COMPAIRR_TIMING=1), a front end of
    utils.trace: each lap records the span from the previous mark or
    lap to now under the current span, named <layer>.<label> (the label
    alone without a layer), with the counts add() gave it; report
    prints the laps' wall summed per label to stderr. One flag check
    when disabled. Host clock only: a lap that enqueues device work
    measures the enqueue, not the kernel. enabled and _t (the last mark
    or lap, perf_counter seconds) are read by the benchmark's recorder
    (portbench/trace.py)."""

    def __init__(self, layer: str = "") -> None:
        self.enabled = trace.refresh()
        self._t = 0.0
        self._ns = 0
        self._prefix = f"{layer}." if layer else ""
        self._laps: list = []
        self._counts: list = []

    def mark(self) -> None:
        if self.enabled:
            self._ns = time.perf_counter_ns()
            self._t = self._ns / 1e9

    def add(self, key: str, n) -> None:
        """Add n to a count of the phase the next lap closes."""
        if self.enabled:
            self._counts.append((key, n))

    def lap(self, label: str) -> None:
        if self.enabled:
            now = time.perf_counter_ns()
            sp = trace.record(self._prefix + label, self._ns, now)
            for key, n in self._counts:
                sp.count(key, n)
            self._counts.clear()
            self._laps.append((label, sp))
            self._ns = now
            self._t = now / 1e9

    def report(self, prefix: str) -> None:
        if self.enabled and self._laps:
            acc: dict[str, float] = {}
            for label, sp in self._laps:
                if sp:  # NULL where COMPAIRR_TIMING changed meanwhile
                    acc[label] = acc.get(label, 0.0) + (sp.t1 - sp.t0) / 1e9
            parts = " ".join(f"{k}={v:.6f}s" for k, v in acc.items())
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
    route (find_pairs) splits its worklist into kernel classes by
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
    these (_cell_bound). The JAX engine's f32 exactness guard chunks its
    worklist by them; here dense_general reads them to choose between
    int64 and float64 sums."""
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


# dense_general sums in int64 while no matrix cell can reach this; the
# headroom to 2^63 leaves the float64 bound's rounding no room to matter
INT64_EXACT_LIMIT = float(1 << 62)


def _cell_bound(work: np.ndarray, stats_a, stats_b, tile_m: int,
                tile_n: int, score_int: int, ignore_counts: bool) -> float:
    """An upper bound on any one matrix cell of a dense run over the
    worklist, from the per-block statistics of _block_rep_stats (the
    bounds of the JAX package's _tile_exact_bounds, summed over every
    tile): with per-block per-repertoire maxima M (rows) and S (count
    sum), a tile adds at most M_a M_b (-f), S_a S_b (product, MH) or
    S_a M_b + S_b M_a (min, max, Jaccard and the kernels' mean, which
    sums cnt_a + cnt_b) to one cell. Ratio has no integer bound (inf)."""
    from ..constants import SCORE_MH, SCORE_PRODUCT, SCORE_RATIO

    if len(work) == 0:
        return 0.0
    ma, sa = stats_a
    mb, sb = stats_b
    rb = work[:, 0] // tile_m
    cb = work[:, 1] // tile_n
    if ignore_counts:
        bound = ma[rb] * mb[cb]
    elif score_int == SCORE_RATIO:
        return float("inf")
    elif score_int in (SCORE_PRODUCT, SCORE_MH):
        bound = sa[rb] * sb[cb]
    else:
        bound = sa[rb] * mb[cb] + sb[cb] * ma[rb]
    return float(bound.sum())


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


@dataclass(frozen=True)
class DensePlan:
    """What every shard of a dense run shares, decided once on the host
    (dense_plan): both sets' key sort (pack_keys' order, padded sorted
    keys and padded row count), the kernel (kernels._dense_kernel_kind
    from the largest count and key of both sets), the key width (wide
    rows for dense_general) and the sum type (float_out: float64 for
    ratio and where a cell of the whole run could reach 2^62, which
    bounds every partial sum too; else int64). work is the whole run's
    column-major worklist."""

    spec: MatchSpec
    score_int: int
    ignore_counts: bool
    tile_m: int
    tile_n: int
    lpad: int
    r1: int
    r2: int
    r1p: int
    r2p: int
    indels: bool
    kind: str
    float_out: bool
    shared: bool
    order_a: np.ndarray
    key_a: np.ndarray
    npad_a: int
    order_b: np.ndarray
    key_b: np.ndarray
    npad_b: int
    work: np.ndarray


@dataclass(frozen=True)
class DenseSide:
    """One side of a dense kernel call: its rows on a device
    (kernels.device_args_raw), and the padded sorted keys and real row
    count on the host that its worklists read."""

    rows: dict
    key: np.ndarray
    n: int


def dense_plan(db1: SeqDB, db2: SeqDB, spec: MatchSpec, score_int: int,
               ignore_counts: bool, tile_m: int = TILE_M,
               tile_n: int = TILE_N) -> DensePlan:
    """The host plan of a dense run (DensePlan), for one device or for
    every shard of a multi-device one."""
    if spec.exclude_self:
        # the dense kernels do not implement self-exclusion (only the
        # sparse extraction carries per-row original indices)
        raise ValueError(
            "dense paths do not support exclude_self specs; use "
            "find_pairs (the sparse engine) for cluster-style matching"
        )
    from . import kernels as K

    by_vjl = not spec.ignore_genes
    use_indels = spec.indels and spec.differences == 1
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
    kind = K._dense_kernel_kind(
        indels=use_indels, score_int=score_int,
        ignore_counts=ignore_counts, cmax=cmax, key_max=kmax,
    )
    work = order_colmajor(
        worklist_from_keys(key_a, db1.n, key_b, db2.n, int(use_indels),
                           tile_m, tile_n)
    )
    float_out = kind == "dense_general" and _cell_bound(
        work,
        _block_rep_stats(
            db1.rep_no[order_a], db1.counts[order_a], db1.n, tile_m,
            npad_a // tile_m, max(db1.repertoire_count, 1),
        ),
        _block_rep_stats(
            db2.rep_no[order_b], db2.counts[order_b], db2.n, tile_n,
            npad_b // tile_n, max(db2.repertoire_count, 1),
        ),
        tile_m, tile_n, score_int, ignore_counts,
    ) >= INT64_EXACT_LIMIT
    return DensePlan(
        spec=spec, score_int=score_int, ignore_counts=ignore_counts,
        tile_m=tile_m, tile_n=tile_n,
        lpad=_round_up(int(max(db1.longest, db2.longest, 1)), 8),
        r1=db1.repertoire_count, r2=db2.repertoire_count,
        r1p=_round_up(max(db1.repertoire_count, 1), 8),
        r2p=_round_up(max(db2.repertoire_count, 1), 128),
        indels=use_indels, kind=kind, float_out=float_out, shared=shared,
        order_a=order_a, key_a=key_a, npad_a=npad_a,
        order_b=order_b, key_b=key_b, npad_b=npad_b, work=work,
    )


def dense_side(plan: DensePlan, db: SeqDB, order: np.ndarray,
               key: np.ndarray, npad: int, dev) -> DenseSide:
    """db's rows in pack_keys' order (`order`; `key` its sorted keys,
    padded to npad) on dev, in the layout plan.kind reads: wide rows for
    dense_general, reversed rows with the indel, residue planes for
    dense_match and, on CUDA, for dense_indel and dense_general, whose
    int8 rows are then dropped."""
    from . import kernels as K

    planes_only = dev.type == "cuda" and plan.kind in ("dense_indel",
                                                       "dense_general")
    rows = K.device_args_raw(
        db, order, npad, plan.lpad, key, dev, indels=plan.indels,
        wide=plan.kind == "dense_general",
        planes=plan.kind == "dense_match" or planes_only,
    )
    if planes_only:
        del rows["seqs"]
        rows.pop("rseqs", None)
    return DenseSide(rows, key, db.n)


def side_span(side: DenseSide, lo: int, hi: int, npad: int,
              dev) -> DenseSide:
    """Rows lo..hi-1 of a derived side (a shard's span of its set), then
    copies of its first pad row up to npad rows, on dev: the side that
    dense_side would derive from the span alone, cut on the device
    instead of gathered and derived again on the host. The whole side
    itself when the span is all of it, on its device."""
    import torch

    src = side.rows["rep"].device
    if lo == 0 and hi == side.n and dev == src:
        return side
    n = hi - lo
    idx = torch.full((npad,), side.n, dtype=torch.int64, device=src)
    idx[:n] = torch.arange(lo, hi, device=src)
    key = np.full(npad, _KEY_PAD, dtype=np.int64)
    key[:n] = side.key[lo:hi]
    return DenseSide(
        {k: t.index_select(0, idx).to(dev) for k, t in side.rows.items()},
        key, n,
    )


def dense_span(plan: DensePlan, a: DenseSide, b: DenseSide,
               work: Optional[np.ndarray] = None):
    """The raw [r1p, r2p] sums (int64, or float64 under plan.float_out)
    of plan.kind's kernel over the worklist of a against b (by default
    worklist_from_keys of their keys, column-major; the rows of a, a
    span of set 1, and of b on one device)."""
    from . import kernels as K

    if work is None:
        work = order_colmajor(worklist_from_keys(
            a.key, a.n, b.key, b.n, int(plan.indels), plan.tile_m,
            plan.tile_n,
        ))
    return dense_launch(plan, a.rows, b.rows,
                        K.upload_worklist(work, a.rows["rep"].device))


def dense_launch(plan: DensePlan, a_rows: dict, b_rows: dict, work_dev):
    """One call of plan.kind's kernel wrapper on derived rows (a DenseSide's
    rows) and a worklist already on their device (kernels.upload_worklist):
    the raw [r1p, r2p] sums, queued on the device without a host sync."""
    from . import kernels as K

    kw = dict(differences=plan.spec.differences,
              score_mode=K.score_mode(plan.score_int, plan.ignore_counts),
              tile_m=plan.tile_m, tile_n=plan.tile_n, r1p=plan.r1p,
              r2p=plan.r2p)
    if plan.kind == "dense_general":
        return K.dense_general(a_rows, b_rows, work_dev, indels=plan.indels,
                               float_out=plan.float_out, **kw)
    return getattr(K, plan.kind)(a_rows, b_rows, work_dev, **kw)


def dense_result(plan: DensePlan, acc) -> np.ndarray:
    """The float64 [R1, R2] matrix of a run's summed raw sums: mean sums
    count_a + count_b and is halved here, once."""
    from ..constants import SCORE_MEAN

    out = acc.cpu().numpy()[: plan.r1, : plan.r2].astype(np.float64)
    if plan.score_int == SCORE_MEAN and not plan.ignore_counts:
        out *= 0.5
    return out


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
    and one kernel (kernels._dense_kernel_kind: dense_match,
    dense_onehot, dense_indel or dense_general) sums score(count_a,
    count_b) over every worklist pair with equal keys and at most d
    differing residues, and with -d 1 -i also over the pairs whose keys
    are 1 apart and which pass the indel test (the worklist then spans
    keys k-1..k+1). Integer sums are int64, exact in any order (mean sums
    count_a + count_b and is halved here, once). dense_general sums in
    float64, the reference's type, for ratio and where a cell could
    reach 2^62 (_cell_bound); otherwise in int64. The run is
    dense_plan, dense_side and dense_span on one device;
    parallel.mesh runs it over several.

    device: "cuda" (the default), "cpu" (the kernels' plain PyTorch
    versions), or None to read COMPAIRR_DEVICE; see utils.device."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    tm = _PhaseTimer("engine")
    tm.mark()
    plan = dense_plan(db1, db2, spec, score_int, ignore_counts, tile_m,
                      tile_n)
    tm.lap("plan")
    a = dense_side(plan, db1, plan.order_a, plan.key_a, plan.npad_a, dev)
    b = a if plan.shared else dense_side(plan, db2, plan.order_b,
                                         plan.key_b, plan.npad_b, dev)
    tm.lap("derive")
    if logger is not None and progress_prompt is not None:
        logger.progress_init(progress_prompt, max(len(plan.work), 1))
    out = dense_result(plan, dense_span(plan, a, b, plan.work))
    tm.lap("kernel")  # dense_result's copy back waits for the kernel
    if logger is not None and progress_prompt is not None:
        logger.progress_update(len(plan.work))
        logger.progress_done()
    tm.report(f"dense_matrix {plan.kind} tiles={len(plan.work)}")
    return out


# TILES_PER_DEVICE_MIN: worklist tiles a card at least before
# find_pairs spreads over another card. The split is in effect off: no
# measurement has resolved what a card's first use in a process costs.
# Fresh CLI processes on one NVIDIA H100 80GB HBM3 against four (700 W;
# chip_smoke.py --cold-tiles, PERF.md "Routing") gave 0.79, 1.005 and
# -0.15 s a card (-d 1 -i, -g -d 1 -i, -d 2 at 4M rows a set), each
# inside the 2-3 s spread between repeats, and a worklist tile's
# count+extract time varies about 25x between runs (8.5 us at -d 1 -i,
# 0.33 us under -g), so those readings give thresholds from about 93,000
# tiles to 3.03M or none. 3,000,000, the largest, is
# above every worklist measured (the 24.2M-row headline's 627,847
# tiles included). The JAX package derives its threshold from its
# TPU's dispatch round trip (compairr_tpu/ops/engine.py route_profile).
TILES_PER_DEVICE_MIN = 3_000_000


def card_route(spec: MatchSpec) -> bool:
    """True when find_pairs takes the tile route from the start, False
    when it takes a host route (which may still hand a candidate-budget
    overflow to the tile route); find_pairs and prefetch_find_pairs
    both ask it.

    d=0 runs take the exact hash join. COMPAIRR_PIGEONHOLE=0 sends every
    other run to the tile route and =all keeps every run on the host.
    Otherwise (unset or 1) one-indel runs take the tile route and
    substitution runs the host pigeonhole, or the variant join, at any
    size: on an NVIDIA H100 80GB HBM3 at 700 W a fresh process paid
    6.1-9 s to start the card, more than the tile route saved at any
    size measured (at most 4.5 s, on the 24.2M-row headline; PERF.md
    "Routing"). No torch is imported: a run that stays on the host
    never loads it."""
    if spec.differences == 0:
        return False
    mode = os.environ.get("COMPAIRR_PIGEONHOLE", "1")
    if mode in ("0", "all"):
        return mode == "0"
    return spec.indels and spec.differences == 1


def _pair_plan(db1: SeqDB, db2: SeqDB, spec: MatchSpec, device_type: str,
               tile: Optional[int] = None):
    """Static launch parameters of a tile-route run: (tile, lpad, by_vjl,
    use_indels).

    Tiles are 128 on the CPU and 512 on CUDA, unless `tile` is given:
    on an NVIDIA H100 80GB HBM3 at 700 W, 512-row tiles were no slower
    than 128-row ones at any size measured (30,000 to 4M rows a set)
    and faster from 1M, where the host worklist and the per-tile cost
    of 16x more tiles outweigh the padding (PERF.md "Routing"). lpad is
    the longest sequence rounded up to 8: the kernels read rows as
    4-byte words."""
    lmax = _round_up(int(max(db1.longest, db2.longest, 1)), 8)
    by_vjl = not spec.ignore_genes
    use_indels = spec.indels and spec.differences == 1
    if tile is None:
        tile = 512 if device_type == "cuda" else TILE_M
    return tile, lmax, by_vjl, use_indels


def _sparse_inputs(db1: SeqDB, db2: SeqDB, tile: int, by_vjl: bool,
                   lmax: int, dev, indels: bool):
    """Both sets' tile-route inputs: the key sort on the host
    (pack_keys) and the rows derived on dev (kernels.device_rows_raw,
    with the residue planes that the CUDA kernels read when dev is a
    card), pad salt 0 for set 1 and 2 for set 2. The key rows take one
    width for both sets, from the largest real key of either, so the
    kernels always get two rows of one type. A self-comparison shares one
    derive, pad band and all. Returns a pair of (rows, key int64[npad]),
    one for each set."""
    from . import kernels as K

    tm = _PhaseTimer("engine")
    tm.mark()
    order_a, key_a, npad_a = pack_keys(db1, tile, by_vjl)
    if db2 is db1:
        order_b, key_b, npad_b = order_a, key_a, npad_a
    else:
        order_b, key_b, npad_b = pack_keys(db2, tile, by_vjl)
    tm.lap("pack_keys")
    wide = K.wide_keys(key_a[: db1.n], key_b[: db2.n])

    def side(db, order, key, npad, salt):
        rows = K.device_rows_raw(
            db, order, npad, lmax, indels, key, salt, dev, wide=wide,
            planes=dev.type == "cuda",
        )
        return rows, key

    up0 = K.UPLOAD_BYTES
    launches0 = K.LAUNCHES["derive_rows"]
    a = side(db1, order_a, key_a, npad_a, 0)
    b = a if db2 is db1 else side(db2, order_b, key_b, npad_b, 2)
    tm.add("upload_bytes", K.UPLOAD_BYTES - up0)
    tm.add("derive_launches", K.LAUNCHES["derive_rows"] - launches0)
    tm.lap("rows_raw")
    tm.report(f"_sparse_inputs n={db1.n}/{db2.n}")
    return a, b


def _width_counts(db1: SeqDB, db2: SeqDB, lmax: int, pa: dict,
                  pb: dict) -> dict:
    """The row-width counts of a tile-route run, for its traced spans:
    chunks (plane words a row: kernels.plane_chunks of lpad), lpad,
    rows_long (rows that reach the last chunk, longer than 32 (chunks -
    1)) and plane_bytes (bytes of the residue planes and reversed planes
    the derive built; none on the CPU), each set counted once, so a
    self-comparison's one set and one derive once."""
    from . import kernels as K

    chunks = K.plane_chunks(lmax)
    sides = [(db1, pa)] if db2 is db1 else [(db1, pa), (db2, pb)]
    return {
        "chunks": chunks,
        "lpad": lmax,
        "rows_long": sum(
            int(np.count_nonzero(db.lengths > K.PLANE_BITS * (chunks - 1)))
            for db, _ in sides),
        "plane_bytes": sum(
            p[k].numel() * p[k].element_size() for _, p in sides
            for k in ("planes", "rplanes") if p.get(k) is not None),
    }


# full-result prefetch for the tile route: the whole find_pairs call
# runs on the worker, so the device phases overlap the host
# duplicate-check phase. key -> (db1, db2, thread, holder), holder
# [result, exception]. The db references are stored strong and
# identity-checked on hit so a recycled id() can never serve a stale
# result; every prefetch clears the cache first.
_RESULT_PREFETCH: dict = {}


def prefetch_find_pairs(db1: SeqDB, db2: SeqDB, spec: MatchSpec,
                        want_dist: bool = False, device=None,
                        devices=None) -> None:
    """Start find_pairs on a worker thread for every run that
    card_route sends to the tile route, so that the route overlaps the
    CLI's host-side duplicate check. Runs that take a host route
    prefetch nothing. A failure on the worker is stored and re-raised by
    the find_pairs call that joins it."""
    import contextvars
    import threading

    from ..utils.device import resolve_device

    _RESULT_PREFETCH.clear()
    if not card_route(spec):
        return

    dev = resolve_device(device)
    holder = [None, None]

    def run():
        try:
            holder[0] = find_pairs(db1, db2, spec, want_dist=want_dist,
                                   device=dev, devices=devices)
        except Exception as e:  # re-raised by the joining call
            holder[1] = e

    # under a copy of the caller's context, so that the worker's spans
    # sit under the caller's current span (its job)
    thread = threading.Thread(target=contextvars.copy_context().run,
                              args=(run,), daemon=True)
    # insert BEFORE start so the worker's own find_pairs call sees the
    # entry and the current-thread check keeps it computing
    _RESULT_PREFETCH[(id(db1), id(db2), spec, want_dist)] = (
        db1, db2, thread, holder,
    )
    thread.start()


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


def replicate(sides: tuple, devs: list) -> list:
    """sides (dicts of tensors) on each device of devs, in order (the JAX
    package's _put_tree): a device that repeats shares one replica, a
    tensor already on its device is not copied, and a side given twice
    (a self-comparison's) stays one side."""
    by_dev: dict = {}
    for d in devs:
        if d not in by_dev:
            copies: dict = {}
            for side in sides:
                if id(side) not in copies:
                    copies[id(side)] = {k: None if t is None else t.to(d)
                                        for k, t in side.items()}
            by_dev[d] = tuple(copies[id(side)] for side in sides)
    return [by_dev[d] for d in devs]


def find_pairs(
    db1: SeqDB,
    db2: SeqDB,
    spec: MatchSpec,
    logger: Optional[Logger] = None,
    progress_prompt: Optional[str] = None,
    exact_groups: Optional[tuple[np.ndarray, np.ndarray]] = None,
    vj_prep=None,
    want_dist: bool = True,
    device=None,
    devices=None,
) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Sparse path: all matching pairs under the spec.

    Returns (idx1, idx2, dist) in original indices, unordered.
    exact_groups optionally carries a precomputed exact_match_groups
    result (d=0 only). card_route picks the route: the host routes
    take the exact hash join at d=0, the pigeonhole grouping (or the
    asymmetric variant join) for substitutions and, under
    COMPAIRR_PIGEONHOLE=all, the indel pigeonhole. One-indel runs, runs
    under COMPAIRR_PIGEONHOLE=0 and candidate-budget overflows take the
    tile route on `device`: "cuda" (the default), "cpu" (the kernels'
    plain versions), or None to read COMPAIRR_DEVICE; see utils.device.
    The tile route spreads over `devices` (a list, which may repeat a
    device; by default utils.device.local_devices of `device`): each
    class stream of the worklist is cut into contiguous spans of at
    least TILES_PER_DEVICE_MIN tiles, one a device, and each device
    extracts the matched tiles of its spans, so the pair set is the
    same for any device count. want_dist=False lets
    the tile route skip the host distance recompute (dist is then
    None); only the pairs file with --distance reads it.
    """
    # a full-result prefetch (the tile route) may already hold the
    # answer: join the worker instead of recomputing
    import threading

    rkey = (id(db1), id(db2), spec, want_dist)
    hit = _RESULT_PREFETCH.get(rkey)
    if (
        hit is not None
        and hit[0] is db1
        and hit[1] is db2
        # the worker's own find_pairs call must compute, not join itself
        and hit[2] is not threading.current_thread()
    ):
        _RESULT_PREFETCH.pop(rkey, None)
        with trace.span("engine.join"):
            hit[2].join()
        if hit[3][1] is not None:
            raise hit[3][1]
        res = hit[3][0]
        if logger is not None and progress_prompt is not None:
            logger.progress_init(progress_prompt, 1)
            logger.progress_update(1)
            logger.progress_done()
        return res

    with trace.span("engine.find_pairs"):
        return _find_pairs_route(db1, db2, spec, logger, progress_prompt,
                                 exact_groups, vj_prep, want_dist, device,
                                 devices)


def _find_pairs_route(db1, db2, spec, logger, progress_prompt, exact_groups,
                      vj_prep, want_dist, device, devices):
    """find_pairs' computation (its docstring), on the route that
    card_route picks."""
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

    # routing (card_route): the host routes, or the tile route on the
    # device; a pigeonhole run that overflows its candidate budget
    # returns None and goes on to the tile route
    if not card_route(spec):
        if spec.indels and spec.differences == 1:
            route = "pigeonhole_indel"
            ph = _find_pairs_pigeonhole_indel(
                db1, db2, spec, logger, progress_prompt
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

    import torch

    from ..utils.device import local_devices, resolve_device
    from . import kernels as K

    devs = ([resolve_device(d) for d in devices] if devices is not None
            else local_devices(device))
    if not devs:
        raise ValueError("the tile route needs at least one device")
    dev = devs[0]
    tm = _PhaseTimer("engine")
    tm.mark()
    tile, lmax, by_vjl, use_indels = _pair_plan(db1, db2, spec, dev.type)
    _note_route("tiles", tile)
    tm.lap("pair_plan")
    delta = 1 if use_indels else 0
    # a self-comparison shares one derive, pad band and all: each pad
    # then key-matches its own twin, and exclude_self (forced above for
    # every same-set run) drops that pair through orig -1
    (pa, key_a), (pb, key_b) = _sparse_inputs(
        db1, db2, tile, by_vjl, lmax, dev, use_indels
    )
    tm.lap("inputs")

    work = worklist_from_keys(key_a, db1.n, key_b, db2.n, delta, tile, tile)
    # per-tile kernel classes: Hamming-only tiles skip the indel test,
    # pure key-distance-1 tiles skip the Hamming test, and tiles that
    # can hold no key-compatible pair are dropped before counting
    has_eq, has_pm = classify_worklist(
        work, key_a, db1.n, key_b, db2.n, tile, tile
    )
    if delta:
        streams = [
            (work[has_eq & ~has_pm], K.CLS_HAMMING),
            (work[has_eq & has_pm], K.CLS_BOTH),
            (work[~has_eq & has_pm], K.CLS_INDEL_ONLY),
        ]
    else:
        streams = [(work[has_eq], K.CLS_HAMMING)]
    # column-major order: consecutive tiles share their b rows in L2.
    # The pair set is order-invariant.
    streams = [(order_colmajor(sw), c) for sw, c in streams if len(sw)]
    w = sum(len(sw) for sw, _ in streams)
    if tm.enabled:
        for sw, c in streams:
            tm.add(f"tiles.{K.CLASS_NAMES[c]}", len(sw))
    tm.lap("worklist")

    if logger is not None and progress_prompt is not None:
        logger.progress_init(progress_prompt, max(w, 1))

    out1: list[np.ndarray] = []
    out2: list[np.ndarray] = []
    if w:
        kw = dict(differences=spec.differences,
                  exclude_self=spec.exclude_self, tile_m=tile, tile_n=tile)
        n_dev = max(1, min(len(devs), w // TILES_PER_DEVICE_MIN))
        replicas = replicate((pa, pb), devs[:n_dev])

        # phase 1: per-tile match counts, every stream's device spans
        # launched before the first copy back; empty tiles are dropped
        up0 = K.UPLOAD_BYTES
        launched = []
        for sw, cls in streams:
            nd = max(1, min(n_dev, len(sw) // TILES_PER_DEVICE_MIN))
            span = [len(sw) * di // nd for di in range(nd + 1)]
            launched.append((sw, cls, span, [
                K.count_tiles(*replicas[di], K.upload_worklist(
                    sw[span[di]:span[di + 1]], devs[di]), cls=cls, **kw)
                for di in range(nd)
            ]))
        filtered = []  # (device, matched tiles, their counts, class)
        for sw, cls, span, parts in launched:
            for di, c in enumerate(parts):
                counts = c.cpu().numpy()
                nz = counts > 0
                if nz.any():
                    filtered.append(
                        (di, sw[span[di]:span[di + 1]][nz], counts[nz], cls))
        widths = {}  # the row-width counts, on the traced spans alone
        if tm.enabled:
            widths = _width_counts(db1, db2, lmax, pa, pb)
            tm.add("upload_bytes", K.UPLOAD_BYTES - up0)
            for key, n in widths.items():
                tm.add(key, n)
            tm.add("tiles", w)
            tm.add("tiles_matched", sum(len(fw) for _, fw, _, _ in filtered))
        tm.lap("count")

        # phase 2: one extract_tiles launch a class stream and device
        # span, writing each matched tile's pairs of original indices to
        # the slots that the exclusive prefix sum of the counts gives it;
        # each device's pairs then come back in one copy
        found: list = [[] for _ in range(n_dev)]
        done = 0
        for di, fwork, tile_counts, cls in filtered:
            offsets = np.cumsum(tile_counts, dtype=np.int64) - tile_counts
            with trace.span("kernels.extract") as sp:
                up0 = K.UPLOAD_BYTES
                pairs = K.extract_tiles(
                    *replicas[di], K.upload_worklist(fwork, devs[di]),
                    offsets=K.upload(offsets, devs[di]),
                    total=int(tile_counts.sum()), cls=cls, **kw,
                )
                if sp:
                    sp.count("tiles", len(fwork))
                    sp.count("pairs", len(pairs[0]))
                    sp.count("upload_bytes", K.UPLOAD_BYTES - up0)
                    for key, n in widths.items():
                        sp.count(key, n)
            found[di].append(pairs)
            done += len(fwork)
            if logger is not None and progress_prompt is not None:
                logger.progress_update(done)
        with trace.span("engine.decode") as sp:
            for parts in found:
                if not parts:
                    continue
                host = torch.stack([
                    torch.cat([p[k] for p in parts]) for k in (0, 1)
                ]).cpu().numpy()
                out1.append(host[0].astype(np.int64))
                out2.append(host[1].astype(np.int64))
                if sp:  # bytes copied from a card; none on the CPU
                    sp.count("d2h_bytes", 0 if parts[0][0].device.type
                             == "cpu" else host.nbytes)
            if sp:
                sp.count("pairs", sum(len(x) for x in out1))
        tm.lap("extract")

    if logger is not None and progress_prompt is not None:
        logger.progress_done()

    if out1:
        i1 = np.concatenate(out1)
        i2 = np.concatenate(out2)
        dist = _pair_distances(db1, db2, i1, i2) if want_dist else None
        tm.add("pairs", len(i1))
        tm.lap("distances")
        res = with_diagonal(i1, i2, dist)
        tm.add("pairs", len(res[0]))
        tm.lap("diagonal")
        tm.report(f"find_pairs tiles={w} pairs={len(res[0])}")
        return res
    tm.report(f"find_pairs tiles={w} pairs=0")
    z = np.zeros(0, dtype=np.int64)
    return with_diagonal(z, z, z.copy())
