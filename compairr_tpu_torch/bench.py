"""The port's benchmark: the repertoire overlap matrix at d=2 on synthetic
CDR3 data, the counterpart of the JAX package's bench.py.

    python -m compairr_tpu_torch.bench                        # on the card
    COMPAIRR_DEVICE=cpu COMPAIRR_BENCH_N=8192 \\
        python -m compairr_tpu_torch.bench                    # on the CPU

Prints one JSON line:
  {"metric": ..., "value": N, "unit": "pairs/s", "vs_baseline": N, ...}

Baseline: CompAIRR's headline benchmark (the Keck 24.2M-sequence
self-comparison, d=2, 4 threads, 3200 s on an M1), i.e. about 1.83e11
effective candidate pairs/s (5.86e14 pairs / 3200 s).

The headline measures what the tool does for `-m -d 2`: find_pairs
through the port's default routing (the host pigeonhole grouping, the
tile route on the card for its overflows; COMPAIRR_PIGEONHOLE=0 sends
the whole run through the tile route) plus the float64 score
accumulation into the [R1, R2] matrix, on an in-memory set of the
baseline's shape and scale (24,205,557 sequences, 120 repertoires,
CDR3 lengths 9-22, 50 V / 13 J genes, 1 % planted near-duplicates).
The inputs are in memory: the file parse is left out.

The kernel section, on the card only, times the dense engine on inputs
already resident there (1M x 1M, the plan, both sides and the worklist
made once): the pruned pair rate, the rate over the worklist's tiles
and, beside the wall, kernel_bound_s, the least time the card could
take for the same work. It prints no share of a peak: the JAX package's
mfu counted the one-hot products that its TPU kernel did, which the
port's kernel (bit planes on the CUDA cores) does not do.

The generator is a line-for-line copy of the JAX package's, so numpy's
RNG gives the same rows. No card and no COMPAIRR_DEVICE=cpu: main()
raises; it never falls back on the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

BASELINE_PAIRS_PER_SEC = 5.86e14 / 3200.0  # CompAIRR d=2, 4 threads (M1)

AA_LEN_MEAN, AA_LEN_STD = 14.5, 1.8
LEN_LO, LEN_HI = 9, 22

HEADLINE_ROWS = 24_205_557

# published dense peaks of the card, for kernel_bound_s: int8 tensor-core
# op/s and device memory byte/s (NVIDIA's H100 SXM data sheet, at its
# full 700 W power limit), by the name torch gives the card
PEAKS = {"NVIDIA H100 80GB HBM3": (1979e12, 3.35e12)}


def _ensure_native() -> None:
    """Build the native helpers if absent (the pigeonhole grouping is
    faster through them; the bench measures the shipped
    configuration)."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    so = os.path.join(here, "native", "libairr_parser.so")
    if not os.path.exists(so):
        try:
            subprocess.run(
                ["make", "-C", os.path.join(here, "native")],
                check=False, capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            pass


def synth_arrays(n, n_reps, n_v, n_j, seed):
    """Synthetic repertoire with a realistic CDR3 length distribution."""
    from .core.db import GeneTables, SeqDB

    rng = np.random.default_rng(seed)
    lengths = np.clip(
        np.round(rng.normal(AA_LEN_MEAN, AA_LEN_STD, size=n)),
        LEN_LO,
        LEN_HI,
    ).astype(np.int32)
    lmax = int(lengths.max())
    seqs = np.full((n, lmax), 20, dtype=np.int8)
    mask = np.arange(lmax)[None, :] < lengths[:, None]
    vals = rng.integers(0, 20, size=(n, lmax), dtype=np.int8)
    seqs[mask] = vals[mask]
    genes = GeneTables()
    for k in range(n_v):
        genes.intern_v(f"TRBV{k}")
    for k in range(n_j):
        genes.intern_j(f"TRBJ{k}")
    return SeqDB(
        nucleotides=False,
        seqs=seqs,
        lengths=lengths,
        counts=rng.integers(1, 100, size=n).astype(np.int64),
        rep_no=rng.integers(0, n_reps, size=n).astype(np.int32),
        v_no=rng.integers(0, n_v, size=n).astype(np.int32),
        j_no=rng.integers(0, n_j, size=n).astype(np.int32),
        sequence_ids=[None] * n,
        keep=[None] * n,
        repertoire_ids=[f"R{r:03d}" for r in range(n_reps)],
        genes=genes,
        residues_count=int(lengths.sum()),
        total_dup_count=n,
        shortest=int(lengths.min()),
        longest=lmax,
    )


_HEADLINE_ARRS = ("seqs", "lengths", "counts", "rep_no", "v_no", "j_no")


def _headline_db(n):
    """The headline's planted self-comparison set, cached on disk under
    the temporary directory (its own path, apart from the JAX package's):
    generating 24.2M rows is set-up, outside the measured wall. The cache
    is one raw .npy per array, loaded memory-mapped (read-only), so a hit
    costs seconds."""
    from .core.db import GeneTables, SeqDB

    cache = os.path.join(tempfile.gettempdir(),
                         f"compairr_torch_bench_headline_{n}_v2")
    arrs = None
    if os.path.isdir(cache):
        try:
            arrs = {
                k: np.load(
                    os.path.join(cache, f"{k}.npy"),
                    mmap_mode="r", allow_pickle=False,
                )
                for k in _HEADLINE_ARRS
            }
            sys.stderr.write(f"bench: dataset cache hit ({cache})\n")
        except (OSError, ValueError):
            arrs = None
    if arrs is None:
        d1 = synth_arrays(n, n_reps=120, n_v=50, n_j=13, seed=1)
        _plant_near_dups(d1, d1, 0.01, seed=7)
        try:
            tmp = cache + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            for k in _HEADLINE_ARRS:
                np.save(os.path.join(tmp, f"{k}.npy"), getattr(d1, k))
            os.replace(tmp, cache)
        except OSError:
            pass
        return d1
    genes = GeneTables()
    for k in range(50):
        genes.intern_v(f"TRBV{k}")
    for k in range(13):
        genes.intern_j(f"TRBJ{k}")
    lengths = arrs["lengths"]
    return SeqDB(
        nucleotides=False,
        seqs=arrs["seqs"],
        lengths=lengths,
        counts=arrs["counts"],
        rep_no=arrs["rep_no"],
        v_no=arrs["v_no"],
        j_no=arrs["j_no"],
        sequence_ids=[None] * n,
        keep=[None] * n,
        repertoire_ids=[f"R{r:03d}" for r in range(120)],
        genes=genes,
        residues_count=int(np.asarray(lengths, dtype=np.int64).sum()),
        total_dup_count=n,
        shortest=int(lengths.min()),
        longest=int(arrs["seqs"].shape[1]),
    )


def _plant_near_dups(d_src, d_dst, frac, seed):
    """Copy ~frac of d_src's rows into d_dst with one substitution so
    the run produces real matches."""
    rng = np.random.default_rng(seed)
    n = d_dst.n
    k = max(int(n * frac), 1)
    src = rng.choice(d_src.n, size=k, replace=False)
    dst = rng.choice(n, size=k, replace=False)
    width = min(d_src.seqs.shape[1], d_dst.seqs.shape[1])
    d_dst.seqs[dst, :width] = d_src.seqs[src, :width]
    d_dst.lengths[dst] = np.minimum(d_src.lengths[src], width)
    d_dst.v_no[dst] = d_src.v_no[src]
    d_dst.j_no[dst] = d_src.j_no[src]
    pos = rng.integers(0, LEN_LO, size=k)
    d_dst.seqs[dst, pos] = (d_dst.seqs[dst, pos] + 1) % 20


def headline_matrix(d1):
    """One `-m -d 2` self-comparison of d1: find_pairs through the port's
    routing, then the float64 matrix of the pairs' product scores.
    Returns (matrix, matched pairs)."""
    from .constants import SCORE_PRODUCT
    from .core.score import pair_scores
    from .ops.engine import MatchSpec, _PhaseTimer, find_pairs

    spec = MatchSpec(differences=2, indels=False, ignore_genes=False)
    r = d1.repertoire_count
    tm = _PhaseTimer("bench")
    tm.mark()
    idx1, idx2, _dist = find_pairs(d1, d1, spec)
    tm.lap("find_pairs")
    scores = pair_scores(d1.counts[idx1], d1.counts[idx2], SCORE_PRODUCT,
                         False)
    matrix = np.zeros((r, r), dtype=np.float64)
    np.add.at(matrix, (d1.rep_no[idx1], d1.rep_no[idx2]), scores)
    tm.lap("matrix")
    tm.report(f"headline n={d1.n} pairs={len(idx1)}")
    return matrix, int(len(idx1))


def _headline(n, d1=None):
    """The headline's end-to-end work on an in-memory set (by default
    _headline_db(n)): the best wall of 2 headline_matrix runs at 4M rows
    and above, else 3. Returns (best wall, matrix checksum, matched
    pairs, matrix)."""
    t0 = time.perf_counter()
    if d1 is None:
        d1 = _headline_db(n)
    sys.stderr.write(
        f"bench: dataset ready {time.perf_counter() - t0:.0f}s\n"
    )
    wall = float("inf")
    iters = 2 if n >= 4_000_000 else 3
    for _ in range(iters):
        t0 = time.perf_counter()
        matrix, npairs = headline_matrix(d1)
        wall = min(wall, time.perf_counter() - t0)
    return wall, float(matrix.sum()), npairs, matrix


def kernel_sets(nk):
    """The kernel section's pair of sets: nk rows each, 60 repertoires,
    48 V x 13 J genes, seeds 11 and 12, 1 % of set 1's rows planted into
    set 2 (seed 13)."""
    d1 = synth_arrays(nk, n_reps=60, n_v=48, n_j=13, seed=11)
    d2 = synth_arrays(nk, n_reps=60, n_v=48, n_j=13, seed=12)
    _plant_near_dups(d1, d2, 0.01, seed=13)
    return d1, d2


def prepared_dense(d1, d2, tile, dev, indels=False):
    """The dense engine prepared once on dev (the port's counterpart of
    the JAX package's dense_matrix_pallas_prepared): the plan, both
    sides and the uploaded worklist, for -d 2 product or, with indels,
    -d 1 -i. Returns (run, plan, a, b), where run() queues one kernel
    call and returns its raw sums without a host sync."""
    from .constants import SCORE_PRODUCT
    from .ops import engine as E
    from .ops import kernels as K

    spec = E.MatchSpec(differences=1 if indels else 2, indels=indels,
                       ignore_genes=False)
    plan = E.dense_plan(d1, d2, spec, SCORE_PRODUCT, False, tile, tile)
    a = E.dense_side(plan, d1, plan.order_a, plan.key_a, plan.npad_a, dev)
    b = a if plan.shared else E.dense_side(plan, d2, plan.order_b,
                                           plan.key_b, plan.npad_b, dev)
    work = K.upload_worklist(plan.work, dev)
    return (lambda: E.dense_launch(plan, a.rows, b.rows, work)), plan, a, b


def touched_rows(starts, tile, npad):
    """Rows of one side that the worklist's tiles cover (each distinct
    tile start once, clipped at the side's npad rows)."""
    s = np.unique(starts[starts >= 0]).astype(np.int64)
    return int((np.minimum(s + tile, npad) - s).sum())


# engine.pack_keys keeps a row's length in its bucket key's low 16 bits
KEY_LENGTH_MASK = 0xFFFF


def key_pairs(keys_a, keys_b, shift=0):
    """Over the pairs of rows, one of each set, whose bucket keys (real
    rows only) satisfy key_a + shift == key_b: their count, and the sum
    over them of the shorter row's length, the residues that the pair's
    comparison must read. A key's low 16 bits are its rows' length
    (engine.pack_keys), so equal keys hold rows of one length and keys 1
    apart rows of lengths 1 apart."""
    ua, ca = np.unique(keys_a, return_counts=True)
    ub, cb = np.unique(keys_b, return_counts=True)
    _, ia, ib = np.intersect1d(ua + shift, ub, assume_unique=True,
                               return_indices=True)
    n = ca[ia].astype(np.int64) * cb[ib]
    length = np.minimum(ua[ia] & KEY_LENGTH_MASK, ub[ib] & KEY_LENGTH_MASK)
    return int(n.sum()), int((n * length).sum())


def dense_bound(plan, a, b, card_name):
    """Least time the card could take for one dense kernel call of the
    plan (its work, tile_m, tile_n, lpad, indels, r1p and r2p) over sides
    a and b (engine.DenseSide): the larger of its bytes over the memory
    rate and its operations over the int8 peak, in ms, with the counts
    behind them. Bytes: each row a worklist tile covers read once
    (residues as int8 rows of lpad, reversed residues on indel runs,
    key, repertoire and count; the pad rows past the last tile are never
    read; the bit planes are the same input in another layout), the
    worklist read once, the matrix written once. Operations: what this
    data needs, one compare and one add a residue of every equal-key
    pair and, on indel runs, two (prefix and suffix) a residue of the
    shorter row of every pair with keys 1 apart (the other pairs of the
    worklist differ in key and need no residue work). Raises for a card
    without published peaks."""
    if card_name not in PEAKS:
        raise ValueError(f"no published peaks for {card_name!r}")
    peak_ops, peak_bw = PEAKS[card_name]
    n_bytes = plan.work.nbytes + plan.r1p * plan.r2p * 8
    for side, col, tile in ((a, 0, plan.tile_m), (b, 1, plan.tile_n)):
        key, cnt = (("key64", "cnt64") if "key64" in side.rows
                    else ("key32", "cnt"))
        row_bytes = plan.lpad * (2 if plan.indels else 1) + sum(
            side.rows[k].element_size() for k in (key, "rep", cnt))
        n_bytes += row_bytes * touched_rows(
            plan.work[:, col], tile, side.rows["rep"].shape[0])
    ka, kb = a.key[: a.n], b.key[: b.n]
    eq, eq_res = key_pairs(ka, kb)
    pm = pm_res = 0
    for shift in ((1, -1) if plan.indels else ()):
        n, res = key_pairs(ka, kb, shift)
        pm, pm_res = pm + n, pm_res + res
    ops = 2.0 * eq_res + 4.0 * pm_res
    bytes_ms = n_bytes / peak_bw * 1e3
    ops_ms = ops / peak_ops * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": n_bytes, "bytes_ms": bytes_ms, "ops": ops,
        "ops_ms": ops_ms, "equal_key_pairs": eq,
        "key_distance_1_pairs": pm,
    }


def _sync(dev):
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def _kernel_metrics(tile, device=None):
    """The dense engine on device-resident 1M x 1M inputs (rows from
    COMPAIRR_BENCH_NK): pruned pair rate, rate over the worklist's tiles,
    wall and bound. The plan, both sides and the worklist are made once
    (prepared_dense); then COMPAIRR_BENCH_KERNEL_REPS (8) calls are
    queued back to back, the card synchronised and the wall divided by
    the calls, best of 3 batches. kernel_compile_s is the first call,
    the lazy nvcc build included. kernel_bound_s is None off the card."""
    from .utils.device import resolve_device

    dev = resolve_device(device)
    nk = int(os.environ.get("COMPAIRR_BENCH_NK", 1_000_000))
    d1, d2 = kernel_sets(nk)
    run, plan, a, b = prepared_dense(d1, d2, tile, dev)
    _sync(dev)
    t_c = time.perf_counter()
    out = run()
    _sync(dev)
    compile_s = time.perf_counter() - t_c
    checksum = float(out.sum().item())
    reps = int(os.environ.get("COMPAIRR_BENCH_KERNEL_REPS", 8))
    rep_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        _sync(dev)
        rep_walls.append((time.perf_counter() - t0) / reps)
    best = min(rep_walls)

    tiles = len(plan.work)
    visited_pairs = float(tiles) * tile * tile
    if dev.type == "cuda":
        import torch

        kind = torch.cuda.get_device_name(dev)
        bound_s = dense_bound(plan, a, b, kind)["bound_ms"] / 1e3
    else:
        kind, bound_s = "cpu", None
    return {
        "kernel_pairs_per_sec": float(nk) * float(nk) / best,
        "kernel_vs_baseline": (
            float(nk) * float(nk) / best / BASELINE_PAIRS_PER_SEC
        ),
        "kernel_visited_pairs_per_sec": visited_pairs / best,
        "kernel_visited_fraction": visited_pairs / (float(nk) * float(nk)),
        "kernel_wall_s": best,
        "kernel_bound_s": bound_s,
        "kernel_compile_s": compile_s,
        "kernel_rep_walls_s": rep_walls,
        "kernel_checksum": checksum,
        "kernel_tiles": tiles,
        "device_kind": kind,
    }


def power_limit_w():
    """The card's power limit in watts, from nvidia-smi; None where it
    cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
        return float(out[0].rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def main():
    from .ops import engine as E
    from .utils.device import resolve_device
    from .utils.mem import retain_heap

    retain_heap()
    _ensure_native()
    dev = resolve_device()  # raises with no card and no CPU request
    on_card = dev.type == "cuda"
    n = int(
        os.environ.get(
            "COMPAIRR_BENCH_N", HEADLINE_ROWS if on_card else 8_192
        )
    )
    tile = int(os.environ.get("COMPAIRR_BENCH_TILE", 768))

    t0 = time.perf_counter()
    wall, checksum, npairs, _ = _headline(n)
    sys.stderr.write(
        f"bench: headline section {time.perf_counter() - t0:.0f}s "
        f"(best iter {wall:.0f}s)\n"
    )
    pairs = float(n) * float(n)
    rate = pairs / wall

    result = {
        "metric": (
            f"d=2 matrix in-memory candidate-pairs/sec "
            f"({n} self-compare, {dev.type}; excludes parse)"
        ),
        "value": rate,
        "unit": "pairs/s",
        "vs_baseline": rate / BASELINE_PAIRS_PER_SEC,
        "wall_s": wall,
        "matched_pairs": npairs,
        "matrix_checksum": checksum,
        # the route find_pairs took (engine.LAST_ROUTE): "pigeonhole"
        # by default, "tiles" under COMPAIRR_PIGEONHOLE=0
        "route": E.LAST_ROUTE,
    }
    if on_card:
        import torch

        t0 = time.perf_counter()
        result.update(_kernel_metrics(tile, dev))
        sys.stderr.write(
            f"bench: kernel section {time.perf_counter() - t0:.0f}s\n"
        )
        result["device_kind"] = torch.cuda.get_device_name(dev)
        result["power_limit_w"] = power_limit_w()
    else:
        result["device_kind"] = "cpu"
        result["power_limit_w"] = None
    result["route_tiles_per_device_min"] = E.TILES_PER_DEVICE_MIN
    print(json.dumps(result))


if __name__ == "__main__":
    main()
