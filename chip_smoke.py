#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (compairr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 17,20   # phases 1, 2 and these alone
    python3 chip_smoke.py --phases 21 --cold-tiles  # with phase 21's
                                           # fresh-process split walls

Builds every CUDA kernel of the port from compairr_tpu_torch/csrc, then:

  1. prints the card (nvidia-smi name and power limit, torch's name);
  2. builds the kernels with nvcc, one process per source, all started
     together, and prints the build seconds;
  3. holds dense_match (which reads the residue bit planes of
     kernels.residue_planes) against its plain PyTorch version on the
     card at full width (tile 768, lpad 24, r1p 64, r2p 128): the first
     worklist tiles of the workload below, every score mode, and
     torch.equal on the int64 matrices;
  4. drives the dense engine (ops.engine.dense_matrix) over the 1M x 1M
     workload of the JAX package's kernel benchmark (60 repertoires a
     side, seeds 11/12/13, tile 768, d=2, product score; the data comes
     from this file's copy of that benchmark's generator, so numpy's
     RNG gives the same rows): the matrix must sum to 24,865,230 and
     equal the port's host route (find_pairs, pair_scores, np.add.at)
     exactly, and the kernel must have launched. Times the kernel with
     CUDA events, the plain version once, and computes the bound;
  5. runs the CLI (-m with COMPAIRR_ENGINE=dense) on two synthetic TSVs
     of 30,000 rows each, at -d 2, -d 2 -f and -d 0 -s MH: each output
     must be byte-equal to the host route's (`python -m
     compairr_tpu_torch` without COMPAIRR_ENGINE), and each dense run
     must launch the kernel;
  6. holds count_tiles and extract_tiles against their plain versions
     on every tile of the full-width worklists of phases 7 to 9 (all
     three tile classes; d = 1, 2, 3; exclude_self on and off), at tile
     512, and on a nucleotide set with lpad 48: equal counts, and equal
     pairs in each tile's slots, none repeated;
  7. drives the tile route (ops.engine.find_pairs, -d 1 -i) over the
     1M x 1M workload with 0.5 % of set 1's rows planted into a copy of
     set 2 with one residue inserted or deleted: its pairs and distances
     must equal the port's host route (COMPAIRR_PIGEONHOLE=all), hold
     more than 10,000 pairs, indel pairs among them, and both kernels
     must have launched;
  8. the same for set 1 against itself, with substitution and indel
     near-duplicates of its own rows planted (exclude_self, the
     diagonal, the pad twins);
  9. runs -d 2 under COMPAIRR_PIGEONHOLE=0 on the dense phase's data:
     the matrix of the tile route's pairs must sum to 24,865,230 and
     equal dense_matrix's cell for cell;
 10. times both tile kernels with CUDA events at phase 7's shapes (count
     and extract once per stream, as find_pairs calls them),
     their plain versions over the same tiles, their bounds, their
     design floors (tile_floor: C (P + 2) integer operations an
     equal-key pair, 2 C (P + 2) a key-distance-1 pair), and
     find_pairs' wall split by phase;
 11. runs the CLI's tile route on phase 5's TSVs (-m/-x/-c -d 1 -i, a
     pairs file with --distance, -m -d 2 under COMPAIRR_PIGEONHOLE=0)
     with no COMPAIRR_DEVICE: each run must launch both kernels and be
     byte-equal to the host route, and one runs again as `python -m
     compairr_tpu_torch`;
 12. the routing sweep (phase_route_sweep) at 30k, 100k, 300k, 1M and
     4M rows a set of the headline's shape: find_pairs on the host
     route against the tile route at 128-row and 512-row tiles (-d 1,
     -d 2, -d 3), 128 against 512 (-d 1 -i; under -g in phase 19), the
     tile route's start-up in a fresh process step by step, and at 1M
     rows a set the CLI in a fresh process a run (-m -d 2, -m -d 1,
     -x -d 2, -c -d 1) on the host route, the tile route and the
     default (engine.card_route: the host), each alternative equal to
     the others; the crossovers printed beside the rule and the tile,
     and the start-up beside the most the tile route saved; then the
     CLI's -m -d 1 -i at 1M rows with and without the find_pairs
     prefetch, in turns, byte-equal;
 13. holds dense_indel and dense_general (both on residue bit planes,
     and reversed rows' planes on indel runs) against their plain
     versions on every full-width tile: the indel workload's dense
     worklist (-d 1 -i, keys k-1..k+1; dense_indel in product and mean,
     dense_general in min and max, since its counts pass 64), the kernel
     workload at d=2 and tile 768 under min (= Jaccard), max and ratio
     (float64: the largest relative difference), 200,000-row sets with
     bucket keys >= 2^31, with counts >= 2^16 and with counts whose
     products pass int64 (float64 sums), and the -g cut of 100,000 rows
     a set with 1 % near-duplicates planted (-d 1 -i at tile 128 on both
     kernels, -d 2 min and ratio at 768); integer sums torch.equal;
 14. drives dense_matrix -d 1 -i over the indel workload with product
     (dense_indel) and min (dense_general): each matrix must equal, cell
     for cell, the matrix of the tile route's pairs (phase 7's 14,951)
     with float64 scores, and launch its kernel once;
 15. drives dense_matrix -d 2 at tile 768 over the kernel workload with
     min (int64) and ratio (float64) through dense_general, against the
     host route's pairs: min equal, ratio within rtol 1e-12;
 16. runs the CLI (COMPAIRR_ENGINE=dense) on phase 5's TSVs, counts 1
     to 99: -m -d 1 -i (dense_indel), -m -d 1 -i -s max and -m -d 2 -s
     min (dense_general), each byte-equal to the host route and
     launching its kernel;
 17. times dense_indel (phase 14's product run) and dense_general (phase
     15's min run) with CUDA events, their plain versions, their bounds
     and design floors (tile_floor over dense_bound's pairs), and
     dense_matrix's wall on the same data; the indel workload's derive
     with and without the residue planes, in turns; the tile route's
     derive at the benchmark cells' shapes (4,034,260 rows at lpad 24,
     5,000,000 at lpad 40, indels and planes): its wall and launches,
     the rows' upload, derive_rows (csrc/derive_rows.cu) a call and
     alone, its plain version on the card and its byte bound, every
     array equal to the plain version's; and both kernels
     under -g at 1M x 1M (dense_indel -d 1 -i at tiles 128 and 768,
     dense_general -d 2 min at 128 and 768 and ratio at 768), timing
     only, with bound, floor, and the plain version on the -g cut;
 18. dense onehot: holds dense_onehot against its plain version (and
     dense_match) on every full-width tile of the kernel workload
     (product, -f; min and max with counts clamped to 64), the CLI
     workload, a -g cut of 100,000 rows a set and the 20,000-row
     nucleotide pair (lpad 48); drives dense_matrix under
     COMPAIRR_V3=0 over the kernel workload (sum 24,865,230) and the
     1M x 1M -g run, each equal to dense_match's matrix; times
     dense_onehot against dense_match in turns, a call (CUDA events)
     and the kernel alone (torch.profiler), on the kernel workload at
     tiles 768 and 128, -g at 1M rows a set at tiles 768 and 128 (2
     calls a turn) and the 100k -g cut at 768 and 128, with the plain
     versions (not on the 1M -g runs), the bound, dense_match's design
     floor (C (P + 2) integer operations an equal-key pair on the CUDA
     cores), the one-hot formulation's tensor-core operations (every
     worklist tile), its skip floor (the same over the 64 x 128
     sub-blocks whose key ranges meet, from the 64-row groups' ranges)
     and a torch._int_mm of the same depth as a rate yardstick for the
     skip floor's operations; and runs the CLI's -m -d 2 under
     COMPAIRR_ENGINE=dense COMPAIRR_V3=0 against the host route;
 19. times the tile route of find_pairs under -g (keys by length alone)
     on the indel workload's sets (phase 7's), their 100k cut and the 1M
     x 1M sets, -d 1 -i and -d 2 under
     COMPAIRR_PIGEONHOLE=0, and the -d 1 -i runs again at the other
     tile of 128 and 512 (forced_tile, as in phase 12; the same
     pairs):
     find_pairs' wall, phases and launches, count_tiles and
     extract_tiles (CUDA events), their bounds and design floors;
     timing only, keeping the 1M runs' pairs;
 20. drives dense_matrix under -g over phase 19's 1M x 1M sets, -d 1 -i
     product (dense_indel) and -d 2 min (dense_general): each matrix
     must equal, cell for cell, the matrix of phase 19's tile-route
     pairs of the same run (indel pairs among the -d 1 -i ones), and
     launch its kernel once;
 21. multi-device (parallel/mesh.py and the tile route's device split)
     over the local cards in turn (on one card every shard shares
     cuda:0, and the two ranks share it over gloo): the kernel
     workload's dense_matrix_sharded over 1, 2 and 4 shards (sum
     24,865,230, equal to dense_matrix cell for cell, each shard with
     work launching dense_match once), again over 2 and 4 under
     COMPAIRR_V3=0 (dense_onehot), and dense_matrix_ring over 4; the
     indel workload's -d 1 -i matrices over 4 shards, product
     (dense_indel) equal and ratio (dense_general, float64) within rtol
     1e-12; find_pairs -d 1 -i over 4 devices (split at 2 tiles a
     device), the pairs equal to one device's, count_tiles launched once
     per class stream and device span; with several cards and
     --cold-tiles, the tile route's CLI runs (-m -d 1 -i and -g -m -d 1
     -i on the indel workload, -m -d 2 at 4M rows a set) in a fresh
     process on one card, on all split at 2 tiles a card and on all at
     engine.TILES_PER_DEVICE_MIN, byte-equal, with a card's first-use
     cost and the threshold it gives (phase_cold_tiles: what decides
     TILES_PER_DEVICE_MIN, run only when it is re-decided); two
     processes on
     torch.distributed (2 shards each) whose sharded and ring matrices
     of the kernel workload reproduce 24,865,230, and
     graft_entry.dryrun_multichip(4) (sum 238). Prints the walls of 1,
     2 and 4 shards and of each rank, LAST_STATS
     (pad_fraction, allreduce_s, backend) and each shard's kernel time:
     on one card overheads of the split, not scaling;
 22. drives the entry point graft_entry.entry() on the card, on
     its own sets (no pair within d=2: zero sums) and on the planted
     ones (planted=True): step(*args) must equal engine.dense_span's
     raw sums on the same plan exactly, with dense_match launched once,
     and the planted sums must not be zero;
 23. the bench's headline at its full size, 24,205,557 rows (the port's
     bench._headline_db: 120 repertoires, 50 V x 13 J, a -d 2
     self-comparison), each run's wall and its phases printed: the
     default routing (bench._headline; engine.card_route keeps it on the
     host pigeonhole, no kernel launched) and the tile route
     (COMPAIRR_PIGEONHOLE=0, 512-row tiles, count_tiles and
     extract_tiles launched) must each give 24,684,757 matched pairs and the checksum 81,495,996,090; dense_matrix of the
     set against itself at tile 128 (the CLI's) and 768 must sum to it
     and equal the host route's matrix cell for cell, dense_match
     launched once each, and its kernel is timed at both tiles (CUDA
     events) beside its bound (bench.dense_bound); the tile route's
     tile is the one its run recorded (engine.LAST_TILE);
 24. the bench's kernel section (bench._kernel_metrics(768)): its JSON,
     kernel_checksum 24,865,230, a wall no shorter than kernel_bound_s;
 25. weak scaling (scripts/weak_scaling.py, --devices 4: 1, 2 and 4
     shards in turn over the local cards) at WS_ROWS rows a shard: the
     checksums exactly linear, dense_match launched, and one shard's
     compute_s at least 10 x a launch's fixed cost (0.1 ms);
 26. the parse kernels of csrc/airr_parse.cu (io/card.py's card route of
     read_db) at the benchmark's shape: the keck20 cohort TSV
     (portbench/gen.py, its configuration's 4,034,260 rows, seed
     AIRR_SEED) uploaded by card._upload, then airr_scan, airr_ids,
     airr_pack and airr_gather on the card held to their plain versions
     on the same body, every returned array and count exactly, with the
     launches counted from zero; the kernels' device time (torch.profiler)
     beside the plain version's wall and the bound (the body read once
     and the returned arrays written once over HBM); then read_db's card
     route against the native parser on that file and on a copy with
     rows that -u and -e ignore (stop codons, empty junctions), each
     SeqDB equal, with both routes' walls;
 27. prints the card line, one JSON line listing every kernel, and as
     its last line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is present or
any phase fails. Writes every measurement to
chiprun_out/chip_smoke.json as well. With --phases it runs phases 1, 2
and the ones named (each falls back on its own inputs where an earlier
phase would have made them) and prints no kernels line: it times a
parent tree's kernels beside this one's, from a copy of this file.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# the port's bench: its copy of the JAX package's generator (so numpy's
# RNG gives the same rows), the kernel workload's sets, the card's
# published peaks and the dense kernels' bound with its pair counts
from compairr_tpu_torch.bench import (  # noqa: E402
    KEY_LENGTH_MASK,
    PEAKS,
    _plant_near_dups as plant_near_dups,
    dense_bound,
    kernel_sets as workload,
    key_pairs,
    synth_arrays,
)
from compairr_tpu_torch.constants import (  # noqa: E402
    AA_CHARS,
    SCORE_PRODUCT,
)

# the JAX package's dense-kernel benchmark workload (bench.kernel_sets:
# seeds 11, 12, 13) and its result
N_ROWS = 1_000_000
SEEDS = (11, 12, 13)
TILE = 768
DIFFERENCES = 2
KERNEL_CHECKSUM = 24_865_230
CHECK_TILES = 384  # worklist tiles of phase 3
KERNEL_SOURCES = ("dense_match", "tile_match", "dense_general",
                  "dense_onehot", "derive_rows")
DEVICE = "cuda"  # every device route below runs here
# the tile route's own near-duplicates: set 1 rows planted with one
# edit (0 substitution, 1 deletion, 2 insertion), each with its seed
INDEL_FRAC, INDEL_SEED = 0.005, 14
SELF_FRAC, SELF_SEED = 0.005, 15
MIN_INDEL_PAIRS = 10_000  # the -d 1 -i run must find more pairs
# phase 13's sets for dense_general's wide rows: the first SIDE_ROWS rows
# of each kernel-workload set, set 2 with 1 % near-duplicates of set 1
SIDE_ROWS, SIDE_SEED = 200_000, 16
RATIO_RTOL = 1e-12  # float64 sums, added in no fixed order
# phase 18: the -g cut that the plain version checks, and the largest
# side of the torch._int_mm yardstick (a 4 GiB int32 product)
G_ROWS = 100_000
INT_MM_SIDE_MAX = 32768
# phase 18: dense_onehot's sub-block, 64 a rows by its b chunk of 128
# columns (csrc/dense_onehot.cu at lpad 24, every timed run's), and the
# launches timed a 1M -g run, each of which takes a sizeable fraction of a
# second
ONEHOT_SLICE, ONEHOT_CHUNK = 64, 128
G_ONEHOT_REPS = 2
# phase 17: launches timed a -g 1M run of dense_indel or dense_general
G_JOIN_REPS = 2
# phase 23: the bench headline's outputs (the JAX package's BENCH_r05.json)
HEADLINE_PAIRS, HEADLINE_CHECKSUM = 24_684_757, 81_495_996_090
# phase 21: worklist tiles a card at which the tile route's split is
# exercised (the parent's threshold), and rows a set of its fresh-process
# -m -d 2 runs
TILES_PER_DEVICE_SPLIT = 2
COLD_D2_ROWS = 4_000_000
# phase 25: rows a shard of the weak-scaling run, and the least compute_s
# of one shard: 10 x a launch's fixed cost (about 0.1 ms a shard, phase 21)
WS_ROWS = 1_500_000
WS_MIN_COMPUTE_S = 10 * 1e-4
# phase 26: the seed of the keck20 cohort TSV, and the parse kernels'
# names in csrc/airr_parse.cu (their device time is the kernels' ms)
AIRR_SEED, AIRR_ROWS = 2_718_281_828, 4_034_260
AIRR_KERNELS = ("line_count_kernel", "scan_kernel", "line_starts_kernel",
                "init_kernel", "row_kernel", "slot_tokens_kernel",
                "verify_kernel", "compact_kernel", "ids_kernel",
                "pack_kernel", "block_sums_kernel", "scan_write_kernel",
                "gather_kernel")

# phase 17: the derive at the benchmark cells' shapes (portbench/configs):
# (cell, rows, length mean and deviation, shortest and longest (the int8
# rows' width), lpad)
DERIVE_SHAPES = (("keck20", 4_034_260, 14.5, 1.8, 9, 22, 24),
                 ("igh10", 5_000_000, 17.0, 4.0, 5, 40, 40))
DERIVE_SEED = 3_141_592_653

# 32-bit integer lane operations a second on the CUDA cores, for the
# design floors of dense_match and the tile kernels: 132 SMs x 64 a
# clock (LOP3, integer add and compare; popcount at 16 a clock on its
# own pipe) x 1.98 GHz, the H100 SXM's boost clock (NVIDIA's data sheet,
# and the arithmetic instruction throughput table of the CUDA C++
# documentation for compute capability 9.0)
CORE_INT_OPS = {"NVIDIA H100 80GB HBM3": 132 * 64 * 1.98e9}


def with_planted(d_src, d_dst, frac, seed, kinds):
    """A copy of d_dst, its rows one residue wider (so that an insertion
    fits), with ~frac of them replaced by copies of d_src rows carrying
    one edit drawn from `kinds` (0 substitution, 1 deletion, 2
    insertion): the same V and J, the length +-1 for an indel. d_dst
    itself is left as it is."""
    from dataclasses import replace

    rng = np.random.default_rng(seed)
    n = d_dst.n
    k = max(int(n * frac), 1)
    src = rng.choice(d_src.n, size=k, replace=False)
    dst = rng.choice(n, size=k, replace=False)
    kind = rng.choice(np.asarray(kinds), size=k)
    alpha = 4 if d_dst.nucleotides else 20
    pad = int(d_dst.pad_value)
    width = max(d_src.seqs.shape[1], d_dst.seqs.shape[1]) + 1
    seqs = np.full((n, width), pad, dtype=np.int8)
    seqs[:, : d_dst.seqs.shape[1]] = d_dst.seqs
    lengths = d_dst.lengths.copy()
    v_no, j_no = d_dst.v_no.copy(), d_dst.j_no.copy()
    for s, t, kd in zip(src, dst, kind):
        row = d_src.seqs[s, : d_src.lengths[s]].tolist()
        pos = int(rng.integers(0, len(row)))
        if kd == 0:
            row[pos] = (row[pos] + int(rng.integers(1, alpha))) % alpha
        elif kd == 1 and len(row) > 1:
            del row[pos]
        else:
            row.insert(pos, int(rng.integers(0, alpha)))
        seqs[t] = pad
        seqs[t, : len(row)] = row
        lengths[t] = len(row)
        v_no[t], j_no[t] = d_src.v_no[s], d_src.j_no[s]
    return replace(
        d_dst, seqs=seqs, lengths=lengths, v_no=v_no, j_no=j_no,
        residues_count=int(lengths.sum()),
        shortest=int(lengths.min()), longest=int(lengths.max()),
    )


def nt_pair(n, seed):
    """Two nucleotide sets (pad residue 4, lengths 36..45, so lpad 48)
    with 2 V x 2 J genes; set 2 holds set 1 rows with one edit each."""
    from dataclasses import replace

    rng = np.random.default_rng(seed)
    dbs = []
    for _ in range(2):
        lengths = rng.integers(36, 46, size=n).astype(np.int32)
        seqs = np.full((n, 45), 4, dtype=np.int8)
        mask = np.arange(45)[None, :] < lengths[:, None]
        seqs[mask] = rng.integers(0, 4, size=int(mask.sum()), dtype=np.int8)
        db = synth_arrays(n, 4, 2, 2, int(rng.integers(1 << 30)))
        dbs.append(replace(
            db, nucleotides=True, seqs=seqs, lengths=lengths,
            residues_count=int(lengths.sum()),
            shortest=int(lengths.min()), longest=int(lengths.max()),
        ))
    return dbs[0], with_planted(dbs[0], dbs[1], 0.2, seed + 1, (0, 1, 2))


@contextlib.contextmanager
def env(**kv):
    """os.environ with kv set (None: unset) for the block."""
    saved = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cuda_ms(fn, reps, warm=2):
    """Mean device milliseconds of fn() over reps back-to-back calls,
    from CUDA events, after warm calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_ms(fn, kernel, reps=10, warm=2):
    """Mean device milliseconds a call of fn() spends in the CUDA kernels
    whose name holds `kernel` (the kernel alone, without the wrapper's
    checks and allocations or the host's gaps between launches), from
    torch.profiler's CUDA activity over reps calls after warm ones; None
    when the profiler records no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
             for e in prof.key_averages() if kernel in e.key)
    return us / reps / 1e3 if us else None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def parse_timing(text):
    """[(report, {phase: seconds})] of the `[timing]` lines that the
    port's phase timer (COMPAIRR_TIMING=1) printed into text."""
    out = []
    for line in text.splitlines():
        if line.startswith("[timing] "):
            report, _, parts = line[len("[timing] "):].rpartition(": ")
            out.append((report, {
                k: float(v.rstrip("s"))
                for k, v in (kv.split("=") for kv in parts.split())
            }))
    return out


def timed(fn):
    """(fn(), wall seconds, parse_timing of what it printed) of one call
    under COMPAIRR_TIMING=1, the card synchronised before and after."""
    import io

    import torch

    err = io.StringIO()
    with env(COMPAIRR_TIMING="1"), contextlib.redirect_stderr(err):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, parse_timing(err.getvalue())


@contextlib.contextmanager
def patched(obj, name, value):
    """obj.name set to value for the block."""
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def ensure_native():
    """Build native/libairr_parser.so (the parser and pack_keys'
    counting sort) when it is missing; the port runs without it too."""
    so = os.path.join(HERE, "native", "libairr_parser.so")
    if os.path.exists(so):
        return True
    proc = subprocess.run(
        ["make", "-C", os.path.join(HERE, "native")],
        capture_output=True, text=True, timeout=300,
    )
    return proc.returncode == 0


def prepare(d1, d2, dev, tile=TILE, differences=DIFFERENCES, indels=False,
            wide=False, by_vjl=True):
    """A dense kernel's inputs on dev, as engine.dense_matrix builds
    them: both sets' derived rows (reversed rows with indels; int64 key
    and count rows when wide, for dense_general) with the residue planes
    that the CUDA kernels but dense_onehot read (and, with indels, the
    reversed rows' planes), the int8 rows kept for the plain versions,
    and the column-major worklist over keys k-delta..k+delta;
    by_vjl=False keys the rows by length alone (-g). "bound" holds the
    arguments of bench.dense_bound but the card: the plan's fields that
    it reads and both sides."""
    from types import SimpleNamespace

    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    lpad = E._round_up(int(max(d1.longest, d2.longest)), 8)
    oa, ka, na = E.pack_keys(d1, tile, by_vjl)
    ob, kb, nb = E.pack_keys(d2, tile, by_vjl)
    work = E.order_colmajor(
        E.worklist_from_keys(ka, d1.n, kb, d2.n, int(indels), tile, tile)
    )
    rows = dict(indels=indels, wide=wide, planes=True)
    a = K.device_args_raw(d1, oa, na, lpad, ka, dev, **rows)
    b = K.device_args_raw(d2, ob, nb, lpad, kb, dev, **rows)
    r1p = E._round_up(d1.repertoire_count, 8)
    r2p = E._round_up(d2.repertoire_count, 128)
    plan = SimpleNamespace(work=work, tile_m=tile, tile_n=tile, lpad=lpad,
                           indels=indels, r1p=r1p, r2p=r2p)
    return {
        "a": a,
        "b": b,
        "work": work,
        "work_dev": K.upload_worklist(work, dev),
        "keys": (ka[: d1.n], kb[: d2.n]),
        "bound": (plan, E.DenseSide(a, ka, d1.n), E.DenseSide(b, kb, d2.n)),
        "lpad": lpad,
        "r1p": r1p,
        "r2p": r2p,
        "tile": tile,
        "differences": differences,
        "indels": indels,
        "wide": wide,
    }


def run_kernel(p, score_mode, work=None, differences=None):
    from compairr_tpu_torch.ops import kernels as K

    return K.dense_match(
        p["a"], p["b"], p["work_dev"] if work is None else work,
        differences=p["differences"] if differences is None else differences,
        score_mode=score_mode, tile_m=p["tile"], tile_n=p["tile"],
        r1p=p["r1p"], r2p=p["r2p"],
    )


def run_plain(p, score_mode, work=None, differences=None):
    from compairr_tpu_torch.ops import kernels as K

    return K.dense_match_plain(
        p["a"], p["b"], p["work_dev"] if work is None else work,
        differences=p["differences"] if differences is None else differences,
        score_mode=score_mode, tile_m=p["tile"], tile_n=p["tile"],
        r1p=p["r1p"], r2p=p["r2p"],
    )


def phase_kernel_vs_plain(p, n_tiles):
    """Kernel and plain version on the first n_tiles worklist tiles,
    every score mode at the workload's d and product at d = 0, 1:
    the largest absolute difference over all cells (0 when equal)."""
    import torch

    from compairr_tpu_torch.ops import kernels as K

    work = p["work_dev"][:n_tiles].contiguous()
    cases = [(m, p["differences"]) for m in
             (K.SC_ONE, K.SC_PRODUCT, K.SC_MIN, K.SC_MAX, K.SC_SUM)]
    cases += [(K.SC_PRODUCT, d) for d in range(p["differences"])]
    worst, total = 0, 0
    for mode, d in cases:
        k = run_kernel(p, mode, work, d)
        ref = run_plain(p, mode, work, d)
        err = int((k - ref).abs().max())
        worst = max(worst, err)
        total += int(ref.sum())
        print(f"  mode={mode} d={d}: kernel sum {int(k.sum())}, "
              f"plain sum {int(ref.sum())}, equal={torch.equal(k, ref)}")
    if total == 0:
        raise AssertionError("phase 3 matched no pair: nothing compared")
    return worst


def bound(p, card_name):
    """dense_match's bound (dense_bound), beside the TPU kernel's own
    formulation of the same work for comparison: an int8 one-hot
    product over every pair of every visited tile plus the two chain
    products, 21 residue classes a position."""
    b = dense_bound(*p["bound"], card_name)
    t = p["tile"]
    v3_ops = len(p["work"]) * (
        2.0 * t * t * 21 * p["lpad"] + 2.0 * p["r1p"] * t * t
        + 2.0 * p["r1p"] * t * p["r2p"]
    )
    return {
        **b,
        "v3_formulation_ops": v3_ops,
        "v3_formulation_ms": v3_ops / PEAKS[card_name][0] * 1e3,
        "peak_int8_ops": PEAKS[card_name][0],
        "peak_bytes_per_s": PEAKS[card_name][1],
    }


def host_matrix(d1, d2):
    """The port's host route for the same -m run: pigeonhole pairs,
    their scores, summed into the matrix."""
    from compairr_tpu_torch.core.score import pair_scores
    from compairr_tpu_torch.ops.engine import MatchSpec, find_pairs

    spec = MatchSpec(differences=DIFFERENCES, indels=False,
                     ignore_genes=False)
    i1, i2, _ = find_pairs(d1, d2, spec)
    m = np.zeros((d1.repertoire_count, d2.repertoire_count))
    s = pair_scores(d1.counts[i1], d2.counts[i2], SCORE_PRODUCT, False)
    np.add.at(m, (d1.rep_no[i1], d2.rep_no[i2]), s)
    return m, len(i1)


def pairs_matrix(d1, d2, pairs, score_int):
    """The -m matrix of a pair list (find_pairs' i1, i2): float64 scores
    summed with np.add.at, as the host route sums them."""
    from compairr_tpu_torch.core.score import pair_scores

    i1, i2 = pairs[0], pairs[1]
    m = np.zeros((d1.repertoire_count, d2.repertoire_count))
    np.add.at(m, (d1.rep_no[i1], d2.rep_no[i2]),
              pair_scores(d1.counts[i1], d2.counts[i2], score_int, False))
    return m


def run_join(p, mode, d, float_out=False, plain=False):
    """dense_general (wide rows) or dense_indel on p's inputs: the
    kernel, or its plain version."""
    from compairr_tpu_torch.ops import kernels as K

    kw = dict(differences=d, score_mode=mode, tile_m=p["tile"],
              tile_n=p["tile"], r1p=p["r1p"], r2p=p["r2p"])
    if p["wide"]:
        fn = K.dense_general_plain if plain else K.dense_general
        return fn(p["a"], p["b"], p["work_dev"], indels=p["indels"],
                  float_out=float_out, **kw)
    fn = K.dense_indel_plain if plain else K.dense_indel
    return fn(p["a"], p["b"], p["work_dev"], **kw)


def side_sets(d1, d2):
    """Phase 13's smaller sets: the first SIDE_ROWS rows of each
    kernel-workload set, set 2 with 1 % substitution and indel
    near-duplicates of set 1 rows planted."""
    idx = np.arange(SIDE_ROWS)
    a = subset(d1, idx)
    return a, with_planted(a, subset(d2, idx), 0.01, SIDE_SEED, (0, 1, 2))


def wide_keys(db):
    """db with every V index raised by 2^15: bucket keys >= 2^31, past
    the int32 key rows."""
    from dataclasses import replace

    return replace(db, v_no=db.v_no + (1 << 15))


def with_counts(db, fn):
    """db with its duplicate counts mapped by fn (int64 in, int64 out)."""
    from dataclasses import replace

    return replace(db, counts=fn(db.counts.astype(np.int64)))


def compare_join(p, label, cases):
    """Each (kernel label, mode, d, float_out) of cases: the kernel
    against its plain version on every tile of p's worklist. Returns
    (largest absolute difference, largest relative difference of the
    float64 sums, matched score total); integer sums must be equal."""
    import torch

    worst = rel = 0.0
    total = 0.0
    for name, mode, d, float_out in cases:
        k = run_join(p, mode, d, float_out)
        ref = run_join(p, mode, d, float_out, plain=True)
        diff = (k - ref).abs()
        err = float(diff.max())
        worst = max(worst, err)
        if float_out:
            nz = ref != 0
            r = float((diff[nz] / ref[nz].abs()).max()) if nz.any() else 0.0
            rel = max(rel, r)
            if r > RATIO_RTOL or bool((k[~nz] != 0).any()):
                raise AssertionError(f"{label} {name}: float64 sums differ "
                                     f"by {r} relative")
        elif not torch.equal(k, ref):
            raise AssertionError(f"{label} {name}: kernel differs from plain")
        total += float(ref.sum())
        print(f"  {label}: {name} d={d}: {len(p['work'])} tiles, kernel sum "
              f"{float(k.sum())}, plain sum {float(ref.sum())}, max abs err "
              f"{err}{f', max rel err {r}' if float_out else ''}")
    if total == 0:
        raise AssertionError(f"{label}: no match, nothing compared")
    return worst, rel, total


# tag, flags, the kernel the dense run must launch (phase 5's TSVs hold
# counts 1 to 99, so min and max take dense_general)
CLI_JOIN_RUNS = (
    ("d1_i", ["-m", "-d", "1", "-i"], "dense_indel"),
    ("d1_i_max", ["-m", "-d", "1", "-i", "-s", "max"], "dense_general"),
    ("d2_min", ["-m", "-d", "2", "-s", "min"], "dense_general"),
)


def phase_cli_join(workdir, files):
    """The CLI's dense runs on dense_indel and dense_general: each in
    this process with COMPAIRR_ENGINE=dense and no COMPAIRR_DEVICE (so
    on the card, and its launches count) against the host route run as
    `python -m compairr_tpu_torch` (the host indel route,
    COMPAIRR_PIGEONHOLE=all, for -i). Returns each run's launches."""
    from compairr_tpu_torch import cli
    from compairr_tpu_torch.ops import kernels as K

    a, b = files["a"], files["b"]
    launches = {}
    for tag, flags, kernel in CLI_JOIN_RUNS:
        host = module_run(flags, (a, b), os.path.join(workdir, f"{tag}.host"),
                          {"COMPAIRR_PIGEONHOLE": "all",
                           "COMPAIRR_DEVICE": None})
        out = os.path.join(workdir, f"{tag}.dense")
        with env(COMPAIRR_ENGINE="dense", COMPAIRR_DEVICE=None,
                 COMPAIRR_PIGEONHOLE=None):
            K.reset_launches()
            rc = cli.main([*flags, a, b, "-o", out, "-l",
                           os.path.join(workdir, f"{tag}.log")])
            launches[tag] = {k: K.LAUNCHES[k] for k in
                             ("dense_match", "dense_indel", "dense_general")}
        with open(out, "rb") as f:
            dense = f.read()
        if rc != 0 or dense != host:
            raise AssertionError(f"CLI {tag}: dense output differs from "
                                 "the host route")
        if host.count(b"\n") < 2:
            raise AssertionError(f"CLI {tag}: empty output")
        if launches[tag][kernel] < 1:
            raise AssertionError(f"CLI {tag}: {kernel} not launched: "
                                 f"{launches[tag]}")
        print(f"  {tag}: dense == host ({len(host)} bytes), launches "
              f"{launches[tag]}")
    return launches


def run_onehot(p, score_mode, plain=False):
    """dense_onehot on p's inputs (prepare's), or its plain version."""
    from compairr_tpu_torch.ops import kernels as K

    fn = K.dense_onehot_plain if plain else K.dense_onehot
    return fn(p["a"], p["b"], p["work_dev"], differences=p["differences"],
              score_mode=score_mode, tile_m=p["tile"], tile_n=p["tile"],
              r1p=p["r1p"], r2p=p["r2p"])


def compare_onehot(p, label, modes):
    """dense_onehot against its plain version and against dense_match on
    every tile of p's worklist, in each (name, mode) of modes: the
    largest absolute difference from the plain version (0 when equal)."""
    import torch

    worst, total = 0, 0
    for mname, mode in modes:
        k = run_onehot(p, mode)
        ref = run_onehot(p, mode, plain=True)
        match = run_kernel(p, mode)
        err = int((k - ref).abs().max())
        worst = max(worst, err)
        total += int(ref.sum())
        print(f"  {label}: {mname}: {len(p['work'])} tiles of {p['tile']}, "
              f"lpad {p['lpad']}, kernel sum {int(k.sum())}, plain sum "
              f"{int(ref.sum())}, max abs err {err}, equal to dense_match "
              f"{torch.equal(k, match)}")
        if err or not torch.equal(k, match):
            raise AssertionError(f"{label} {mname}: dense_onehot differs")
    if total == 0:
        raise AssertionError(f"{label}: no match, nothing compared")
    return worst


def onehot_ops(p):
    """The int8 tensor-core operations of dense_onehot's formulation on
    p: 2 tile_m tile_n K for every worklist tile, whatever its keys."""
    from compairr_tpu_torch.ops import kernels as K

    return 2.0 * len(p["work"]) * p["tile"] ** 2 * K.onehot_width(p["lpad"])


def group_ranges(side):
    """The min and max key over the rows with rep >= 0 of each 64-row
    group of a side (lo > hi for a group without one), as int64 [groups]
    rows lo and hi: the key ranges dense_onehot skips sub-blocks by,
    computed here on their own."""
    import torch

    real = side["rep"] >= 0
    key = side["key32"].long()
    n = key.shape[0]
    fill = -(-n // ONEHOT_SLICE) * ONEHOT_SLICE - n
    lo = torch.nn.functional.pad(torch.where(real, key, 1 << 31), (0, fill),
                                 value=1 << 31)
    hi = torch.nn.functional.pad(torch.where(real, key, -(1 << 31) - 1),
                                 (0, fill), value=-(1 << 31) - 1)
    return (lo.view(-1, ONEHOT_SLICE).amin(1),
            hi.view(-1, ONEHOT_SLICE).amax(1))


def skip_floor(p, card_name):
    """dense_onehot's skip floor on p (prepare's; tiles multiples of
    ONEHOT_CHUNK): 2 x 64 x ONEHOT_CHUNK x K int8 tensor-core operations
    for each 64-row a slice and b chunk of the worklist's tiles whose key
    ranges meet (the sub-blocks the kernel multiplies), over the int8
    peak, in ms; with the sub-blocks counted."""
    import torch

    from compairr_tpu_torch.ops import kernels as K

    tile = p["tile"]
    n_s, n_c = tile // ONEHOT_SLICE, tile // ONEHOT_CHUNK
    alo, ahi = group_ranges(p["a"])
    blo, bhi = group_ranges(p["b"])
    per = ONEHOT_CHUNK // ONEHOT_SLICE  # groups a chunk
    meet = 0
    work = p["work_dev"].long()
    for s0 in range(0, len(work), 1 << 20):
        w = work[s0:s0 + (1 << 20)]
        ga = w[:, :1] // ONEHOT_SLICE + torch.arange(n_s, device=w.device)
        gb = (w[:, 1:] // ONEHOT_SLICE
              + torch.arange(n_c * per, device=w.device)).view(-1, n_c, per)
        la, ha = alo[ga][:, :, None], ahi[ga][:, :, None]
        lb, hb = blo[gb].amin(2)[:, None, :], bhi[gb].amax(2)[:, None, :]
        meet += int(((la <= ha) & (lb <= hb) & (la <= hb) & (lb <= ha))
                    .sum())
    total = len(work) * n_s * n_c
    ops = 2.0 * ONEHOT_SLICE * ONEHOT_CHUNK * K.onehot_width(p["lpad"]) * meet
    return {"sub_blocks": total, "sub_blocks_meeting": meet,
            "skip_ops": ops, "skip_floor_ms": ops / PEAKS[card_name][0] * 1e3}


def match_floor(q, card_name):
    """dense_match's design floor on q (prepare's): C (P + 2) integer
    operations an equal-key pair (P LOP3 folding the planes' XORs into
    the mismatch mask, one popcount, one compare, each of the C
    chunks) over the CUDA cores' integer rate, in ms."""
    n_chunks, n_planes = q["a"]["planes"].shape[1:]
    ops = (float(key_pairs(*q["keys"])[0]) * n_chunks
           * (n_planes + 2))
    return {"floor_ops": ops,
            "floor_ms": ops / CORE_INT_OPS[card_name] * 1e3}


def int_mm_yardstick(macs, lpad, dev):
    """A rate yardstick for the product stage, which the port never
    calls: torch._int_mm on int8 one-hot rows of depth K =
    onehot_width(lpad), [S, K] x [K, S] with S chosen so that the
    product has `macs` multiply-adds, S capped at INT_MM_SIDE_MAX (the
    time is then scaled by macs over the product's multiply-adds)."""
    import torch

    from compairr_tpu_torch.ops import kernels as K

    kdim = K.onehot_width(lpad)
    side = int(min(INT_MM_SIDE_MAX, (macs / kdim) ** 0.5)) // 64 * 64
    gen = torch.Generator(device=dev).manual_seed(SEEDS[0])
    a, b = (K.onehot_rows(torch.randint(0, K.ONEHOT_CLASSES, (side, lpad),
                                        generator=gen, device=dev,
                                        dtype=torch.int8))
            for _ in range(2))
    ms = cuda_ms(lambda: torch._int_mm(a, b.t()), reps=5)
    scale = macs / (float(side) * side * kdim)
    return {"shape": [side, kdim, side], "ms": ms, "scale": scale,
            "ms_scaled": ms * scale,
            "tops": 2.0 * side * side * kdim / (ms * 1e-3) / 1e12}


def tile_inputs(d1, d2, spec, dev, tile=None):
    """The tile route's inputs as engine.find_pairs builds them: both
    sets' rows on dev (one derive for a self-comparison) and the
    column-major worklist streams [(work, class)]; tile=None takes the
    route's own tile choice."""
    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    t, lpad, by_vjl, indels = E._pair_plan(d1, d2, spec, dev.type)
    tile = tile or t
    (a, ka), (b, kb) = E._sparse_inputs(d1, d2, tile, by_vjl, lpad, dev,
                                        indels)
    work = E.worklist_from_keys(ka, d1.n, kb, d2.n, int(indels), tile, tile)
    eq, pm = E.classify_worklist(work, ka, d1.n, kb, d2.n, tile, tile)
    if indels:
        parts = [(eq & ~pm, K.CLS_HAMMING), (eq & pm, K.CLS_BOTH),
                 (~eq & pm, K.CLS_INDEL_ONLY)]
    else:
        parts = [(eq, K.CLS_HAMMING)]
    streams = [(E.order_colmajor(work[m]), c) for m, c in parts if m.any()]
    return {"a": a, "b": b, "keys": (ka, d1.n, kb, d2.n), "tile": tile,
            "lpad": lpad, "streams": streams,
            "spec": spec, "tiles": len(work)}


def tile_kw(p, cls, d=None, xself=None):
    spec = p["spec"]
    return dict(
        differences=spec.differences if d is None else d, cls=cls,
        exclude_self=spec.exclude_self if xself is None else xself,
        tile_m=p["tile"], tile_n=p["tile"],
    )


def matched_offsets(work, counts, dev):
    """The matched tiles of work (counts: count_tiles' host counts) and
    extract_tiles' slot arguments for them, as find_pairs makes them:
    (worklist on dev, offsets on dev, total)."""
    import torch

    from compairr_tpu_torch.ops import kernels as K

    nz = counts > 0
    mc = counts[nz].astype(np.int64)
    return (K.upload_worklist(work[nz], dev),
            torch.from_numpy(np.cumsum(mc) - mc).to(dev), int(mc.sum()))


def compare_tile_kernels(p, label, ds=None, xselfs=(None,)):
    """count_tiles and extract_tiles against their plain versions over
    every tile of every stream of p: (largest count difference, number
    of pairs differing from the plain version's or repeated, tiles,
    matches). ds: the distances the Hamming class is also run at."""
    import torch

    from compairr_tpu_torch.ops import kernels as K

    worst = bad = tiles = matched = 0
    for work, cls in p["streams"]:
        wd = K.upload_worklist(work, p["a"]["seqs"].device)
        for d in (ds if ds and cls == K.CLS_HAMMING else (None,)):
            for xself in xselfs:
                kw = tile_kw(p, cls, d, xself)
                got = K.count_tiles(p["a"], p["b"], wd, **kw)
                want = K.count_tiles_plain(p["a"], p["b"], wd, **kw)
                worst = max(worst, int((got - want).abs().max()))
                total = int(want.sum())
                mw, offs, n = matched_offsets(work, want.cpu().numpy(),
                                              wd.device)
                pairs = [
                    [x.cpu().numpy().astype(np.int64) for x in r] for r in (
                        K.extract_tiles(p["a"], p["b"], mw, offsets=offs,
                                        total=n, **kw),
                        K.extract_tiles_plain(p["a"], p["b"], mw,
                                              offsets=offs, total=n, **kw))
                ]
                tid = np.repeat(np.arange(len(offs)),
                                np.diff(np.append(offs.cpu().numpy(), n)))
                gs, ws = (np.stack([tid, i1, i2], 1) for i1, i2 in pairs)
                gs, ws = (x[np.lexsort(x.T[::-1])] for x in (gs, ws))
                pdiff = (int((gs != ws).any(1).sum()) if gs.shape == ws.shape
                         else abs(len(gs) - len(ws)) + 1)
                bad += pdiff
                tiles += len(work)
                matched += total
                print(f"  {label}: class {cls} d={kw['differences']} "
                      f"exclude_self={kw['exclude_self']}: {len(work)} "
                      f"tiles, {total} matches, equal counts "
                      f"{torch.equal(got, want)}; {n} pairs, {pdiff} "
                      f"differ or repeat")
    return worst, bad, tiles, matched


def sorted_pairs(res):
    i1, i2, dist = res
    o = np.lexsort((i2, i1))
    return i1[o], i2[o], (None if dist is None else dist[o])


def pairs_equal(got, want):
    g, w = sorted_pairs(got), sorted_pairs(want)
    return all(
        (a is None and b is None) or np.array_equal(a, b)
        for a, b in zip(g, w)
    )


def tile_pair_counts(p, work):
    """Over the tiles of work, among their real rows: (equal-key pairs,
    key-distance-1 pairs), the pairs whose residues the kernels must
    read, and the shorter row's residues summed over each kind of pair
    (a key's low 16 bits are its rows' length, bench.key_pairs)."""
    ka, na, kb, nb = p["keys"]
    tile = p["tile"]
    kbr = kb[:nb]
    eq = pm = eq_res = pm_res = 0
    step = max(1, (1 << 22) // tile)
    for s in range(0, len(work), step):
        w = work[s : s + step].astype(np.int64)
        r = w[:, :1] + np.arange(tile)
        valid = r < na
        kr = ka[np.minimum(r, na - 1)]
        length = (kr & KEY_LENGTH_MASK) * valid
        c0 = w[:, 1:]
        c1 = np.minimum(c0 + tile, nb)

        def overlap(k):
            lo = np.searchsorted(kbr, k, side="left")
            hi = np.searchsorted(kbr, k, side="right")
            return np.clip(np.minimum(hi, c1) - np.maximum(lo, c0), 0, None)

        o_eq, o_up, o_down = overlap(kr), overlap(kr + 1), overlap(kr - 1)
        eq += int((o_eq * valid).sum())
        pm += int(((o_up + o_down) * valid).sum())
        eq_res += int((o_eq * length).sum())
        pm_res += int((o_up * length + o_down * (length - valid)).sum())
    return eq, pm, eq_res, pm_res


def tile_bound(p, groups, out_bytes, card_name, pairs=None):
    """Least time the card could take for the kernel calls over groups
    [(work, class)]: the larger of their bytes over the memory rate and
    their operations over the int8 peak. Bytes: each row a tile touches
    read once (its residues, its reversed residues where an indel class
    touches it, its key, and its original index when the call excludes
    self-pairs), the worklists read once, out_bytes written. Operations:
    one byte compare a residue of each equal-key pair of a class that
    tests Hamming and two a residue of the shorter row of each
    key-distance-1 pair of a class that tests indels, counted on this
    data (the other pairs of a tile differ in key and need no residue
    work). pairs=((equal-key pairs, their residues), (key-distance-1
    pairs, their residues)), bench.key_pairs' counts, gives the counts
    of groups that cover every pair of the run, in place of counting
    them tile by tile."""
    from compairr_tpu_torch.ops import kernels as K

    if card_name not in PEAKS:
        raise ValueError(f"no published peaks for {card_name!r}")
    peak_ops, peak_bw = PEAKS[card_name]
    lpad, tile = p["lpad"], p["tile"]
    n_bytes = out_bytes
    for side, col in ((p["a"], 0), (p["b"], 1)):
        fwd = set()
        rev = set()
        for work, cls in groups:
            blocks = set(np.unique(work[:, col] // tile).tolist())
            fwd |= blocks
            if cls != K.CLS_HAMMING:
                rev |= blocks
        row = lpad + side["key"].element_size() + (
            4 if p["spec"].exclude_self else 0)
        n_bytes += tile * (len(fwd) * row + len(rev) * lpad)
    ops = 0
    eq_pairs = pm_pairs = 0
    for work, cls in groups:
        n_bytes += work.nbytes
    for work, cls in ([] if pairs else groups):
        eq, pm, eq_res, pm_res = tile_pair_counts(p, work)
        if cls != K.CLS_INDEL_ONLY:
            eq_pairs += eq
            ops += eq_res
        if cls != K.CLS_HAMMING:
            pm_pairs += pm
            ops += 2 * pm_res
    if pairs:
        (eq_pairs, eq_res), (pm_pairs, pm_res) = pairs
        ops = eq_res + 2 * pm_res
    bytes_ms = n_bytes / peak_bw * 1e3
    ops_ms = ops / peak_ops * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": n_bytes, "bytes_ms": bytes_ms, "ops": ops,
        "ops_ms": ops_ms, "equal_key_pairs": eq_pairs,
        "key_distance_1_pairs": pm_pairs,
    }


def tile_floor(p, bd, card_name):
    """The design floor of the tile kernels and of dense_indel and
    dense_general for the pairs that a tile_bound or dense_bound result
    bd counted on p (tile_inputs' or prepare's): C (P + 2) integer
    operations for each equal-key pair that takes the Hamming test (P
    LOP3 folding the planes' XORs into the mismatch mask, one popcount,
    one compare, each of the C chunks) and 2 C (P + 2) for each
    key-distance-1 pair that takes the indel test (the same fold on the
    forward and the reversed planes, the lowest set bit in place of the
    popcount), over the CUDA cores' integer rate, in ms."""
    n_chunks, n_planes = p["a"]["planes"].shape[1:]
    per_pair = n_chunks * (n_planes + 2)
    ops = float(per_pair) * (bd["equal_key_pairs"]
                             + 2 * bd["key_distance_1_pairs"])
    return {"floor_ops": ops,
            "floor_ms": ops / CORE_INT_OPS[card_name] * 1e3}


def write_tsv(db, path):
    """An AIRR TSV holding db's rows (amino acids): each sequence as the
    fixed-width bytes of its letters, the pad residue (20) as a NUL that
    the bytes type drops at the end."""
    letters = np.frombuffer(AA_CHARS.encode() + b"\0", dtype=np.uint8)
    width = db.seqs.shape[1]
    seqs = np.ascontiguousarray(letters[np.minimum(db.seqs, 20)])

    def names(table, idx):
        return np.array([x.encode() for x in table], dtype=object)[idx]

    rows = zip(names(db.repertoire_ids, db.rep_no),
               (b"S%d" % i for i in range(db.n)),
               db.counts.astype("S20").tolist(),
               names(db.genes.v_names, db.v_no),
               names(db.genes.j_names, db.j_no),
               seqs.view(f"S{width}").ravel().tolist())
    with open(path, "wb") as f:
        f.write(b"repertoire_id\tsequence_id\tduplicate_count\tv_call\t"
                b"j_call\tjunction_aa\n")
        f.write(b"".join(b"\t".join(r) + b"\n" for r in rows))


CLI_RUNS = (
    ("d2", ["-m", "-d", "2"]),
    ("d2_f", ["-m", "-d", "2", "-f"]),
    ("d0_mh", ["-m", "-d", "0", "-s", "MH"]),
)


def subset(db, idx):
    """The rows idx of db, as a SeqDB of their own."""
    from dataclasses import replace

    return replace(
        db, **{f: getattr(db, f)[idx] for f in
               ("seqs", "lengths", "counts", "rep_no", "v_no", "j_no")},
        sequence_ids=[None] * len(idx), keep=[None] * len(idx),
    )


def cli_sets(n):
    """The CLI workload's two sets of n rows, set 2 holding 5 %
    near-duplicates and 2 % exact copies of set 1 rows."""
    d1 = synth_arrays(n, 12, 8, 4, 21)
    d2 = synth_arrays(n, 16, 8, 4, 22)
    plant_near_dups(d1, d2, 0.05, 23)
    # exact copies too, so that -d 0 has matches
    rng = np.random.default_rng(24)
    src = rng.choice(n, size=n // 50, replace=False)
    dst = rng.choice(n, size=n // 50, replace=False)
    width = min(d1.seqs.shape[1], d2.seqs.shape[1])
    keep = d1.lengths[src] <= width
    src, dst = src[keep], dst[keep]
    d2.seqs[dst] = 20
    d2.seqs[dst, :width] = d1.seqs[src, :width]
    for f in ("lengths", "v_no", "j_no"):
        getattr(d2, f)[dst] = getattr(d1, f)[src]
    return d1, d2


def cli_files(workdir, n):
    """The CLI phases' inputs: cli_sets' two sets as TSVs and, for -x,
    a one-repertoire query file (set 1's rows of its first
    repertoire)."""
    d1, d2 = cli_sets(n)
    paths = {k: os.path.join(workdir, f"{k}.tsv") for k in "abq"}
    write_tsv(d1, paths["a"])
    write_tsv(d2, paths["b"])
    write_tsv(subset(d1, np.nonzero(d1.rep_no == 0)[0]), paths["q"])
    return paths


def module_timed(flags, inputs, out, env_extra):
    """`python -m compairr_tpu_torch` on inputs in a process of its own,
    with env_extra set (None: unset) and COMPAIRR_ENGINE unset unless
    given: (the output file's bytes, the process's wall seconds, its
    stderr)."""
    env = dict(os.environ)
    env.pop("COMPAIRR_ENGINE", None)
    for k, v in env_extra.items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = v
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "compairr_tpu_torch", *flags, *inputs,
         "-o", out],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=600,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{flags}: {proc.stderr[-3000:]}")
    with open(out, "rb") as f:
        return f.read(), wall, proc.stderr


def module_run(flags, inputs, out, env_extra):
    """module_timed's output bytes."""
    return module_timed(flags, inputs, out, env_extra)[0]


def phase_cli(workdir, files, device_env):
    """CLI end to end: each dense run in this process (so its launches
    count) and as `python -m compairr_tpu_torch`, against the host
    route run as `python -m compairr_tpu_torch`. Returns the launches
    of each in-process dense run."""
    from compairr_tpu_torch import cli
    from compairr_tpu_torch.ops import kernels as K

    a, b = files["a"], files["b"]
    launches = {}
    for tag, flags in CLI_RUNS:
        host = module_run(flags, (a, b), os.path.join(workdir, f"{tag}.host"),
                          {})
        out = os.path.join(workdir, f"{tag}.dense")
        with env(COMPAIRR_ENGINE="dense", **device_env):
            K.reset_launches()
            rc = cli.main([*flags, a, b, "-o", out, "-l",
                           os.path.join(workdir, f"{tag}.log")])
            launches[tag] = K.LAUNCHES["dense_match"]
        with open(out, "rb") as f:
            dense = f.read()
        if rc != 0 or dense != host:
            raise AssertionError(f"CLI {tag}: dense output differs from "
                                 "the host route")
        if host.count(b"\n") < 2 or not any(
            v not in (b"0", b"0.0") for line in host.splitlines()[1:]
            for v in line.split(b"\t")[1:]
        ):
            raise AssertionError(f"CLI {tag}: empty matrix, nothing compared")
        print(f"  {tag}: dense == host ({len(host)} bytes), "
              f"{launches[tag]} launch(es)")
    # the module entry point itself on the dense engine
    tag, flags = CLI_RUNS[0]
    mod = module_run(flags, (a, b), os.path.join(workdir, f"{tag}.module"),
                     {"COMPAIRR_ENGINE": "dense", **device_env})
    with open(os.path.join(workdir, f"{tag}.host"), "rb") as f:
        if mod != f.read():
            raise AssertionError("python -m compairr_tpu_torch with "
                                 "COMPAIRR_ENGINE=dense differs")
    print(f"  python -m compairr_tpu_torch {' '.join(flags)} "
          "(COMPAIRR_ENGINE=dense): byte-equal")
    return launches


# tag, flags, inputs, COMPAIRR_PIGEONHOLE of the host route's run and of
# the tile route's run (None: unset), whether it writes a pairs file
CLI_TILE_RUNS = (
    ("m_d1_i", ["-m", "-d", "1", "-i"], "ab", "all", None, False),
    ("x_d1_i", ["-x", "-d", "1", "-i"], "qb", "all", None, False),
    ("c_d1_i", ["-c", "-d", "1", "-i"], "b", "all", None, False),
    ("m_d1_i_pairs", ["-m", "-d", "1", "-i", "--distance"], "ab", "all",
     None, True),
    ("m_d2_ph0", ["-m", "-d", "2"], "ab", None, "0", False),
)


def phase_cli_tiles(workdir, files):
    """The CLI's tile route: each run in this process with no
    COMPAIRR_DEVICE (so on the card, and its launches count) against
    the host route run as `python -m compairr_tpu_torch`; the first
    run again as `python -m compairr_tpu_torch` on the card. Returns
    each run's launches."""
    from compairr_tpu_torch import cli
    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    launches = {}
    for tag, flags, which, host_ph, tile_ph, pairs in CLI_TILE_RUNS:
        inputs = [files[k] for k in which]

        def run_flags(side):
            if not pairs:
                return flags
            return [*flags, "-p", os.path.join(workdir, f"{tag}.{side}.pairs")]

        host = module_run(run_flags("host"), inputs,
                          os.path.join(workdir, f"{tag}.host"),
                          {"COMPAIRR_PIGEONHOLE": host_ph,
                           "COMPAIRR_DEVICE": None})
        out = os.path.join(workdir, f"{tag}.tiles")
        with env(COMPAIRR_PIGEONHOLE=tile_ph, COMPAIRR_DEVICE=None,
                 COMPAIRR_ENGINE=None):
            K.reset_launches()
            rc = cli.main([*run_flags("tiles"), *inputs, "-o", out, "-l",
                           os.path.join(workdir, f"{tag}.log")])
            launches[tag] = {k: K.LAUNCHES[k]
                             for k in ("count_tiles", "extract_tiles")}
        with open(out, "rb") as f:
            got = f.read()
        if rc != 0 or got != host:
            raise AssertionError(f"CLI {tag}: tile route output differs "
                                 "from the host route")
        if pairs:
            with open(os.path.join(workdir, f"{tag}.host.pairs"), "rb") as f:
                hp = f.read()
            with open(os.path.join(workdir, f"{tag}.tiles.pairs"), "rb") as f:
                tp = f.read()
            if hp != tp or hp.count(b"\n") < 2:
                raise AssertionError(f"CLI {tag}: pairs files differ or "
                                     "are empty")
        if host.count(b"\n") < 2:
            raise AssertionError(f"CLI {tag}: empty output")
        if E.LAST_ROUTE != "tiles" or min(launches[tag].values()) < 1:
            raise AssertionError(f"CLI {tag}: route {E.LAST_ROUTE}, "
                                 f"launches {launches[tag]}")
        print(f"  {tag}: tiles == host ({len(host)} bytes"
              f"{', pairs file too' if pairs else ''}), launches "
              f"{launches[tag]}")
    tag, flags, which, _, tile_ph, _ = CLI_TILE_RUNS[0]
    mod = module_run(flags, [files[k] for k in which],
                     os.path.join(workdir, f"{tag}.module"),
                     {"COMPAIRR_PIGEONHOLE": tile_ph,
                      "COMPAIRR_DEVICE": None})
    with open(os.path.join(workdir, f"{tag}.host"), "rb") as f:
        if mod != f.read():
            raise AssertionError("python -m compairr_tpu_torch "
                                 f"{' '.join(flags)} differs")
    print(f"  python -m compairr_tpu_torch {' '.join(flags)} (tile route, "
          "card by default): byte-equal")
    return launches


# the order of the alternatives in an A/B: each twice at each end, so
# that a drift of the card or the host touches both alike
AB_ORDER = (True, False, False, True, True, False, False, True)


# phase 12's routing sweep: rows a set, the CLI commands it times (tag,
# flags, inputs), and its routes by COMPAIRR_PIGEONHOLE (None: the rule)
SWEEP_ROWS = (30_000, 100_000, 300_000, 1_000_000, 4_000_000)
SWEEP_CLI_ROWS = (1_000_000,)  # a fresh process a run
SWEEP_CLI = (
    ("-m -d 2", ["-m", "-d", "2"], "ab"),
    ("-m -d 1", ["-m", "-d", "1"], "ab"),
    ("-x -d 2", ["-x", "-d", "2"], "qb"),
    ("-c -d 1", ["-c", "-d", "1"], "b"),
)
SWEEP_ROUTES = (("host", "all"), ("tile", "0"), ("default", None))
SWEEP_REPS = 2  # find_pairs calls of each alternative, in turns
# the tile a route does not take, of 128 and 512
OTHER_TILE = {128: 512, 512: 128}


def forced_tile(tile):
    """engine._pair_plan made to plan tile-row tiles for the block."""
    from functools import partial

    from compairr_tpu_torch.ops import engine as E

    return patched(E, "_pair_plan", partial(E._pair_plan, tile=tile))


def sweep_sets(n):
    """The sweep's two sets of n rows in the bench headline's shape (120
    repertoires, 50 V x 13 J, lengths 9-22; seeds 31 and 32): 1 % of
    set 1's rows planted into set 2 with one substitution (seed 33),
    then 0.5 % with one indel (seed 34)."""
    a = synth_arrays(n, 120, 50, 13, 31)
    b = synth_arrays(n, 120, 50, 13, 32)
    plant_near_dups(a, b, 0.01, 33)
    return a, with_planted(a, b, INDEL_FRAC, 34, (1, 2))


def fp_run(a, b, spec, ph, tile=None):
    """find_pairs(a, b, spec) on the card under COMPAIRR_PIGEONHOLE=ph,
    with tile-row tiles when tile is given (forced_tile): (pairs, wall,
    route, the tile route's count+extract seconds a worklist tile or
    None, the phase splits)."""
    from compairr_tpu_torch.ops import engine as E

    force = forced_tile(tile) if tile else contextlib.nullcontext()
    with env(COMPAIRR_PIGEONHOLE=ph), force:
        got, wall, split = timed(lambda: E.find_pairs(
            a, b, spec, device=DEVICE, want_dist=False))
    per_tile = None
    for rep, parts in split:
        w = int(rep.split("tiles=")[1].split()[0]) if "tiles=" in rep else 0
        if rep.startswith("find_pairs") and w:
            per_tile = (parts.get("count", 0) + parts.get("extract", 0)) / w
    return got[:2], wall, E.LAST_ROUTE, per_tile, split


def start_probe():
    """The tile route's start-up in this fresh process, step by step, as
    a CLI run pays it: seconds to import torch, to ask for a card, to
    start cuda:0, to import the port's kernels module and load
    tile_match's library, and of a first and a second find_pairs -d 1
    -i on 2,000-row sets (the first launches load the kernels). Prints
    them as JSON."""
    t = [time.perf_counter()]
    steps = {}

    def lap(label):
        t.append(time.perf_counter())
        steps[label] = t[-1] - t[-2]

    import torch

    lap("import torch")
    torch.cuda.is_available()
    lap("torch.cuda.is_available")
    torch.zeros(1, device="cuda:0")
    torch.cuda.synchronize()
    lap("start cuda:0")
    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    lap("import the port's engine and kernels")
    K.load_library("tile_match")
    lap("load tile_match's library")
    a, b = workload(2000)
    lap("make 2,000-row sets")
    for label in ("first find_pairs -d 1 -i", "second find_pairs -d 1 -i"):
        E.find_pairs(a, b, E.MatchSpec(1, True, False), device="cuda:0")
        torch.cuda.synchronize()
        lap(label)
    print(json.dumps(steps))


def start_walls():
    """start_probe's steps from a fresh process, with the wall of the
    whole process and of an empty one beside them."""
    res = []
    for _ in range(1):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", "pass"], check=True,
                       timeout=600)
        empty = time.perf_counter() - t0
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c",
             "import chip_smoke; chip_smoke.start_probe()"],
            cwd=HERE, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"start probe: {proc.stderr[-3000:]}")
        steps = json.loads(proc.stdout.strip().splitlines()[-1])
        # what the route adds before its work: every step but the sets,
        # and of the first find_pairs what the second does not take
        startup = (sum(v for k, v in steps.items()
                       if "find_pairs" not in k and "sets" not in k)
                   + steps["first find_pairs -d 1 -i"]
                   - steps["second find_pairs -d 1 -i"])
        res.append({"process_s": wall, "empty_process_s": empty,
                    "steps_s": steps, "startup_s": startup})
        print(f"  the tile route's start-up in a fresh process: {startup:.6f}"
              f" s ({wall:.6f} s the whole process, an empty one "
              f"{empty:.6f} s); by step (s) {steps}")
    return res


def no_slower(a, b):
    """Walls a no slower than walls b beyond their repeats' spread: the
    best of a at most the best of b plus the larger spread."""
    spread = max(max(a) - min(a), max(b) - min(b))
    return min(a) <= min(b) + spread


def crossover(rows, wins):
    """The first of rows (ascending) from which wins[i] holds at every
    row on; None when it fails at the last."""
    first = None
    for r, w in zip(reversed(rows), reversed(wins)):
        if not w:
            break
        first = r
    return first


def phase_route_sweep(workdir):
    """The routing sweep at SWEEP_ROWS rows a set of sweep_sets, timing
    only but for the checks that every alternative gives the same
    pairs or bytes:

    find_pairs on the card, SWEEP_REPS calls of each alternative in
    turns: the host route (COMPAIRR_PIGEONHOLE=all) against the tile
    route (=0) at 128-row and 512-row tiles for -d 1, -d 2 and -d 3, and
    128 against 512 for -d 1 -i (phase 19 does so under -g). Then, at
    SWEEP_CLI_ROWS, the CLI in a fresh process a run (`python -m
    compairr_tpu_torch`, the import of torch and the card's start
    included) for each of SWEEP_CLI on TSVs of the sets (-x: set 1's
    first repertoire against set 2; -c: set 2) on the host route, the
    tile route and the default (engine.card_route: the host, which each
    run must take). The crossovers are printed beside the rule and the
    tile: rows of both sets from which the tile route beats the host
    route at every larger size, with the card started and in a fresh
    process (card_route keeps substitution runs on the host while a
    fresh process finds none), and rows a set from which 512-row tiles
    are no slower than 128-row ones beyond their repeats' spread
    (engine._pair_plan takes 512 on the card at every size)."""
    from compairr_tpu_torch.ops import engine as E

    spec_i = E.MatchSpec(1, True, False)
    subs = {f"-d {d}": E.MatchSpec(d, False, False) for d in (1, 2, 3)}
    res = {"find_pairs": {}, "cli": {}}
    for n in SWEEP_ROWS:
        t0 = time.perf_counter()
        a, b = sweep_sets(n)
        cases = [(label, spec, (("host", "all", None), ("tile 128", "0", 128),
                                ("tile 512", "0", 512)))
                 for label, spec in subs.items()]
        cases.append(("-d 1 -i", spec_i, (("tile 128", "0", 128),
                                          ("tile 512", "0", 512))))
        for label, spec, alts in cases:
            r = res["find_pairs"].setdefault(label, {}).setdefault(n, {})
            want = None
            for _ in range(SWEEP_REPS):
                for alt, ph, tile in alts:
                    got, wall, route, per_tile, split = fp_run(a, b, spec,
                                                               ph, tile)
                    if want is None:
                        want = got
                    elif not pairs_equal((*got, None), (*want, None)):
                        raise AssertionError(f"{n} rows, {label}: {alt} "
                                             "gives other pairs")
                    x = r.setdefault(alt, {"wall_s": [], "route": route})
                    x["wall_s"].append(wall)
                    x["pairs"] = len(got[0])
                    x["per_tile_s"] = per_tile
                    x["phases"] = split
            print(f"  find_pairs {label}, {n} rows a set: "
                  + "; ".join(f"{alt} ({x['route']}) {min(x['wall_s']):.6f}"
                              f" s (walls {x['wall_s']}"
                              + (f", count+extract {x['per_tile_s'] * 1e6:.4f}"
                                 " us a tile" if x["per_tile_s"] else "")
                              + ")" for alt, x in r.items())
                  + f"; {x['pairs']} pairs, equal")
        if n not in SWEEP_CLI_ROWS:
            print(f"  {n} rows a set: {time.perf_counter() - t0:.1f} s")
            continue
        files = {k: os.path.join(workdir, f"sweep_{k}.tsv") for k in "abq"}
        write_tsv(a, files["a"])
        write_tsv(b, files["b"])
        write_tsv(subset(a, np.nonzero(a.rep_no == 0)[0]), files["q"])
        rows = {"ab": a.n + b.n, "qb": int((a.rep_no == 0).sum()) + b.n,
                "b": 2 * b.n}
        del a, b
        for tag, flags, which in SWEEP_CLI:
            r = res["cli"].setdefault(tag, {}).setdefault(
                n, {"rows": rows[which]})
            want = None
            for alt, ph in SWEEP_ROUTES:
                out, wall, err = module_timed(
                    flags, [files[k] for k in which],
                    os.path.join(workdir, "sweep.out"),
                    {"COMPAIRR_PIGEONHOLE": ph, "COMPAIRR_DEVICE": None,
                     "COMPAIRR_TIMING": "1"})
                if want is None:
                    want = out
                    if out.count(b"\n") < 2:
                        raise AssertionError(f"{tag}, {n} rows: empty output")
                elif out != want:
                    raise AssertionError(f"{tag}, {n} rows: the {alt} "
                                         "route's output differs")
                route = ("tiles" if any(rep.startswith("find_pairs tiles")
                                        for rep, _ in parse_timing(err))
                         else "host")
                r[alt] = {"wall_s": wall, "route": route}
            if r["default"]["route"] != "host":
                raise AssertionError(f"{tag}, {n} rows: the default took "
                                     f"{r['default']['route']}, not the "
                                     "host route (engine.card_route)")
            print(f"  CLI {tag}, {n} rows a set ({rows[which]} rows of both "
                  "sets), a fresh process a run: "
                  + "; ".join(f"{alt} ({r[alt]['route']}) "
                              f"{r[alt]['wall_s']:.6f} s"
                              for alt, _ in SWEEP_ROUTES)
                  + "; byte-equal")
        print(f"  {n} rows a set: {time.perf_counter() - t0:.1f} s")

    # the crossovers, beside the constants
    fp, cli = res["find_pairs"], res["cli"]
    cross = {"find_pairs": {}, "cli": {}, "tile_512": {}}
    for label in subs:
        wins = [min(min(fp[label][n][t]["wall_s"])
                    for t in ("tile 128", "tile 512"))
                < min(fp[label][n]["host"]["wall_s"]) for n in SWEEP_ROWS]
        c = crossover(SWEEP_ROWS, wins)
        cross["find_pairs"][label] = None if c is None else 2 * c
    for tag, _, _ in SWEEP_CLI:
        rows = [cli[tag][n]["rows"] for n in SWEEP_CLI_ROWS]
        wins = [cli[tag][n]["tile"]["wall_s"] < cli[tag][n]["host"]["wall_s"]
                for n in SWEEP_CLI_ROWS]
        cross["cli"][tag] = crossover(rows, wins)
    for label in [*subs, "-d 1 -i"]:
        wins = [no_slower(fp[label][n]["tile 512"]["wall_s"],
                          fp[label][n]["tile 128"]["wall_s"])
                for n in SWEEP_ROWS]
        cross["tile_512"][label] = crossover(SWEEP_ROWS, wins)
    res["crossovers"] = cross
    res["constants"] = {"TILES_PER_DEVICE_MIN": E.TILES_PER_DEVICE_MIN}
    print("  card_route: substitution runs on the host at any size; the "
          "tile route beats the host route from (rows of both sets; None: "
          "not at the largest size): with the card started (find_pairs) "
          f"{cross['find_pairs']}; in a fresh process (the CLI) "
          f"{cross['cli']}")
    print("  engine._pair_plan: 512-row tiles on the card at every size; "
          "512-row tiles are no slower than 128-row ones, beyond the spread of their "
          f"repeats, from (rows a set): {cross['tile_512']}")
    return res


def phase_prefetch(workdir, a, b):
    """The CLI's -m -d 1 -i in this process on TSVs of a and b, with the
    find_pairs prefetch (engine.prefetch_find_pairs, started before the
    duplicate check) and without it (the call replaced by a no-op), in
    AB_ORDER after one warm run: the outputs must be byte-equal. Returns
    each side's walls and the phase splits of its last run."""
    from compairr_tpu_torch import cli
    from compairr_tpu_torch.ops import engine as E

    paths = [os.path.join(workdir, f"pf{k}.tsv") for k in "ab"]
    write_tsv(a, paths[0])
    write_tsv(b, paths[1])
    out = os.path.join(workdir, "pf.out")

    def run(prefetch):
        fn = E.prefetch_find_pairs if prefetch else (lambda *_, **__: None)
        with patched(E, "prefetch_find_pairs", fn), env(
            COMPAIRR_DEVICE=None, COMPAIRR_PIGEONHOLE=None,
            COMPAIRR_ENGINE=None,
        ):
            rc, wall, split = timed(
                lambda: cli.main(["-m", "-d", "1", "-i", *paths, "-o", out]))
        if rc != 0 or E.LAST_ROUTE != "tiles":
            raise AssertionError(f"prefetch={prefetch}: rc {rc}, route "
                                 f"{E.LAST_ROUTE}")
        with open(out, "rb") as f:
            return f.read(), wall, split

    want = run(True)[0]
    res = {"on": {"wall_s": []}, "off": {"wall_s": []}}
    for prefetch in AB_ORDER:
        got, wall, split = run(prefetch)
        if got != want:
            raise AssertionError(f"prefetch={prefetch}: output differs")
        r = res["on" if prefetch else "off"]
        r["wall_s"].append(wall)
        r["phases_s"] = split
    for side, r in res.items():
        print(f"  -m -d 1 -i, {a.n} x {b.n} rows, prefetch {side}: CLI walls "
              f"(s) {r['wall_s']}, mean {np.mean(r['wall_s'])}; last run by "
              f"phase {r['phases_s']}")
    return res


def tile_route_timing(a, b, spec, label):
    """Timing only, no plain version: find_pairs on the card (its wall,
    phase split, launches and pairs (i1, i2), every count set to 0 just
    before), then
    count_tiles over each worklist stream and extract_tiles
    over each stream's nonzero tiles, once each after one warm call
    (CUDA events), with their bounds. The count's bound takes the pair
    counts of the whole run (every equal-key pair lies in a Hamming or
    both tile, every key-distance-1 pair in a both or indel-only tile),
    so no per-tile count over millions of tiles is needed; the
    extract's counts its matched tiles' pairs."""
    import torch

    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    name = torch.cuda.get_device_name(0)
    dev = torch.device(DEVICE)
    K.reset_launches()
    got, wall, split = timed(lambda: E.find_pairs(a, b, spec, device=DEVICE,
                                                  want_dist=False))
    launches = {k: K.LAUNCHES[k] for k in ("count_tiles", "extract_tiles")}
    route = E.LAST_ROUTE
    if route != "tiles" or min(launches.values()) < 1:
        raise AssertionError(f"{label}: route {route}, launches {launches}")
    tp = tile_inputs(a, b, spec, dev)
    count_ms = 0.0
    filtered = []
    last = {}  # the timed call's result
    for work, cls in tp["streams"]:
        wd = K.upload_worklist(work, dev)
        kw = tile_kw(tp, cls)
        count_ms += cuda_ms(lambda: last.update(
            out=K.count_tiles(tp["a"], tp["b"], wd, **kw)), reps=1, warm=1)
        counts = last["out"].cpu().numpy()
        filtered.append((work, counts, cls))
    total = sum(int(c.sum()) for _, c, _ in filtered)
    extract_ms = 0.0
    matched = []
    for work, counts, cls in filtered:
        if not counts.any():
            continue
        mw, offs, n = matched_offsets(work, counts, dev)
        kw = tile_kw(tp, cls)
        extract_ms += cuda_ms(lambda: K.extract_tiles(
            tp["a"], tp["b"], mw, offsets=offs, total=n, **kw),
            reps=1, warm=1)
        matched.append((work[counts > 0], cls))
    ka, na, kb, nb = tp["keys"]
    eq = key_pairs(ka[:na], kb[:nb])
    pm = [key_pairs(ka[:na], kb[:nb], s) for s in (1, -1)] \
        if spec.indels else [(0, 0)]
    cb = tile_bound(tp, tp["streams"],
                    4 * sum(len(w) for w, _ in tp["streams"]), name,
                    pairs=(eq, tuple(map(sum, zip(*pm)))))
    eb = tile_bound(tp, matched,
                    8 * total + 8 * sum(len(w) for w, _ in matched), name)
    cf, ef = tile_floor(tp, cb, name), tile_floor(tp, eb, name)
    print(f"  {label}: route {route}, {len(got[0])} pairs, launches "
          f"{launches}, find_pairs {wall:.6f} s, by phase (s) {split}; "
          f"{tp['tiles']} worklist tiles of {tp['tile']} in streams "
          f"{[(len(w), c) for w, c in tp['streams']]}: count_tiles "
          f"{count_ms:.4f} ms (design floor {cf['floor_ms']:.6f} ms; bound "
          f"{cb['bound_ms']:.6f} ms by {cb['bound_by']}; "
          f"{cb['equal_key_pairs']} equal-key and "
          f"{cb['key_distance_1_pairs']} key-distance-1 pairs, "
          f"{cb['ops']:.4g} ops), {total} matches in {len(matched)} "
          f"launches: "
          f"extract_tiles {extract_ms:.4f} ms (design floor "
          f"{ef['floor_ms']:.6f} ms; bound {eb['bound_ms']:.6f} ms by "
          f"{eb['bound_by']}) (CUDA events, 1 launch each after a warm "
          f"one)")
    return {"pairs": len(got[0]), "launches": launches, "find_pairs_s": wall,
            "find_pairs_phases_s": split, "tiles": tp["tiles"],
            "tile": tp["tile"],
            "streams": [(len(w), c) for w, c in tp["streams"]],
            "count_ms": count_ms, "count_bound": cb, "count_floor": cf,
            "matches": total, "extract_launches": len(matched),
            "extract_ms": extract_ms,
            "extract_bound": eb, "extract_floor": ef}, got[:2]


def kernel_case():
    """The kernel workload as the keyword arguments of a dense run, for
    parallel.worker.launch's CASE: every rank makes the same sets from
    the seeds."""
    from compairr_tpu_torch.ops.engine import MatchSpec

    d1, d2 = workload(N_ROWS)
    return dict(db1=d1, db2=d2, spec=MatchSpec(DIFFERENCES, False, False),
                score_int=SCORE_PRODUCT, ignore_counts=False, tile_m=TILE,
                tile_n=TILE)


def cold_main(label, n):
    """One dense run of the kernel workload (or, label "-g", its keys by
    length) in this fresh process, as a CLI run makes it: engine.
    dense_matrix on cuda:0 (n 1) or mesh.dense_matrix_sharded over
    cuda:0 .. cuda:n-1, each card but cuda:0 first touched inside the
    run. Prints its wall, shards and matrix sum as JSON."""
    import torch

    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.parallel import mesh

    kw = kernel_case()
    if label == "-g":
        kw["spec"] = E.MatchSpec(DIFFERENCES, False, True)
    torch.zeros(1, device="cuda:0")  # the process's CUDA start, paid alike
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if n == 1:
        m = E.dense_matrix(**kw, device="cuda:0")
        shards = 1
    else:
        m = mesh.dense_matrix_sharded(
            **kw, devices=[torch.device("cuda", i) for i in range(n)])
        shards = mesh.LAST_STATS["devices"]
    print(json.dumps({"wall_s": time.perf_counter() - t0, "shards": shards,
                      "sum": float(m.sum())}))


def cold_wall(label, n):
    """cold_main's result, from a process of its own."""
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.cold_main({label!r}, {n})"],
        cwd=HERE, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"cold run {label} {n}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def cold_cli(argv, tiles_per_device):
    """One CLI run, cli.main(argv), in this fresh process over the local
    cards (COMPAIRR_DEVICES caps them), with engine.TILES_PER_DEVICE_MIN
    set to tiles_per_device and cuda:0 started before the clock, so that
    each other card's first use is part of the wall. Prints its wall,
    route and count_tiles launches as JSON."""
    import torch

    from compairr_tpu_torch import cli
    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    torch.zeros(1, device="cuda:0")  # the process's CUDA start, paid alike
    torch.cuda.synchronize()
    E.TILES_PER_DEVICE_MIN = tiles_per_device
    K.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    print(json.dumps({"wall_s": wall, "rc": rc, "route": E.LAST_ROUTE,
                      "count_tiles": K.LAUNCHES["count_tiles"]}))


def cold_cli_wall(argv, tiles_per_device, cards, pigeonhole=None):
    """cold_cli's result and the output's bytes, from a process of its
    own that sees `cards` cards (None: all), under COMPAIRR_PIGEONHOLE
    =pigeonhole (None: unset)."""
    env_run = dict(os.environ, COMPAIRR_TIMING="1")
    for k in ("COMPAIRR_PIGEONHOLE", "COMPAIRR_DEVICE", "COMPAIRR_ENGINE"):
        env_run.pop(k, None)
    if pigeonhole is not None:
        env_run["COMPAIRR_PIGEONHOLE"] = pigeonhole
    if cards is None:
        env_run.pop("COMPAIRR_DEVICES", None)
    else:
        env_run["COMPAIRR_DEVICES"] = str(cards)
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.cold_cli({argv!r}, "
         f"{tiles_per_device})"],
        cwd=HERE, env=env_run, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"cold CLI {argv}: {proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["phases"] = [x for x in parse_timing(proc.stderr)
                     if x[0].startswith("find_pairs")]
    with open(argv[argv.index("-o") + 1], "rb") as f:
        return out, f.read()


def phase_cold_tiles(d1, d2i, cards):
    """Phase 21's fresh-process walls of the tile route's CLI runs:
    -m -d 1 -i on the indel workload (d1, d2i), -g -d 1 -i on the same
    sets, and -m -d 2 on sweep_sets(COLD_D2_ROWS) under
    COMPAIRR_PIGEONHOLE=0, each on one card, on all `cards` split at
    TILES_PER_DEVICE_SPLIT tiles a card, and on all at
    engine.TILES_PER_DEVICE_MIN, twice in turns, every output
    byte-equal. From the one-card and split walls: a card's first-use
    cost, (split - one) / (cards - 1), and the threshold it gives over
    the run's count+extract seconds a tile."""
    from compairr_tpu_torch.ops import engine as E

    a2, b2 = sweep_sets(COLD_D2_ROWS)
    variants = (("one card", E.TILES_PER_DEVICE_MIN, 1),
                (f"{cards} cards, split", TILES_PER_DEVICE_SPLIT, None),
                (f"{cards} cards, TILES_PER_DEVICE_MIN",
                 E.TILES_PER_DEVICE_MIN, None))
    res = {}
    with tempfile.TemporaryDirectory() as workdir:
        files = {}
        for k, db in (("a", d1), ("b", d2i), ("a2", a2), ("b2", b2)):
            files[k] = os.path.join(workdir, f"cold_{k}.tsv")
            write_tsv(db, files[k])
        del a2, b2
        out = os.path.join(workdir, "cold.out")
        # a fresh process keeps -d 2 on the host (engine.card_route), so
        # its tile route runs under COMPAIRR_PIGEONHOLE=0
        runs = (
            ("-m -d 1 -i", ["-m", "-d", "1", "-i"], "ab", None),
            ("-g -m -d 1 -i", ["-g", "-m", "-d", "1", "-i"], "ab", None),
            (f"-m -d 2, {COLD_D2_ROWS} rows a set, COMPAIRR_PIGEONHOLE=0",
             ["-m", "-d", "2"], ("a2", "b2"), "0"),
        )
        for label, flags, which, pigeonhole in runs:
            argv = [*flags, *(files[k] for k in which), "-o", out]
            r = res[label] = {}
            want = None
            for _ in range(2):
                for vlabel, tpd, n in variants:
                    got, data = cold_cli_wall(argv, tpd, n, pigeonhole)
                    if got["rc"] != 0 or got["route"] != "tiles":
                        raise AssertionError(f"cold {label} {vlabel}: {got}")
                    if want is None:
                        want = data
                    elif data != want:
                        raise AssertionError(f"cold {label} {vlabel}: "
                                             "output differs")
                    r.setdefault(vlabel, []).append(got)
    for label, r in res.items():
        walls = {v: [x["wall_s"] for x in r[v]] for v, _, _ in variants}
        one, split = (min(walls[v]) for v, _, _ in variants[:2])
        rep, parts = r["one card"][0]["phases"][-1]
        tiles = int(rep.split("tiles=")[1].split()[0])
        per_tile = (parts["count"] + parts["extract"]) / max(tiles, 1)
        first_use = (split - one) / (cards - 1)
        r.update(first_use_s=first_use, per_tile_s=per_tile,
                 threshold_tiles=first_use / per_tile)
        print(f"  {label}, a fresh process a run (walls, s): "
              + "; ".join(f"{v} {walls[v]} (count_tiles launches "
                          f"{r[v][0]['count_tiles']})"
                          for v, _, _ in variants)
              + f"; {tiles} tiles, count+extract {per_tile * 1e6:.4f} us a "
              f"tile on one card; first use {first_use:.6f} s a card, so "
              f"about {first_use / per_tile:.0f} tiles a card "
              f"(TILES_PER_DEVICE_MIN {E.TILES_PER_DEVICE_MIN}); byte-equal")
    return res


def launch_ms(fn, kernel):
    """Device milliseconds of each launch of the CUDA kernels whose name
    holds `kernel` in one call of fn(), in launch order, from
    torch.profiler; [] when it records none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and kernel in e.name),
                 key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in evs]


def count_spans(d1, d2, spec, n_dev):
    """count_tiles launches that find_pairs makes over n_dev devices: one
    per class stream and device span (engine.TILES_PER_DEVICE_MIN tiles
    at least a span), from the same host worklist and classes."""
    from compairr_tpu_torch.ops import engine as E

    tile, _, by_vjl, indels = E._pair_plan(d1, d2, spec, "cuda")
    oa, ka, _ = E.pack_keys(d1, tile, by_vjl)
    _, kb, _ = E.pack_keys(d2, tile, by_vjl)
    work = E.worklist_from_keys(ka, d1.n, kb, d2.n, int(indels), tile, tile)
    eq, pm = E.classify_worklist(work, ka, d1.n, kb, d2.n, tile, tile)
    masks = [eq & ~pm, eq & pm, ~eq & pm] if indels else [eq]
    sizes = [int(m.sum()) for m in masks if m.any()]
    tpd = E.TILES_PER_DEVICE_MIN
    nd = max(1, min(n_dev, sum(sizes) // tpd))
    return sum(max(1, min(nd, sz // tpd)) for sz in sizes), sizes


def derive_db(n, mean, std, lo, hi, seed):
    """A set of n amino-acid rows (20 repertoires, 50 V x 13 J genes),
    lengths N(mean, std) rounded and clipped to lo..hi, its int8 rows hi
    wide."""
    from dataclasses import replace

    rng = np.random.default_rng(seed)
    lengths = np.clip(np.round(rng.normal(mean, std, n)), lo,
                      hi).astype(np.int32)
    seqs = rng.integers(0, 20, (n, hi), dtype=np.int8)
    seqs[np.arange(hi)[None, :] >= lengths[:, None]] = 20
    return replace(synth_arrays(n, 20, 50, 13, seed + 1), seqs=seqs,
                   lengths=lengths, residues_count=int(lengths.sum()),
                   shortest=int(lengths.min()), longest=int(lengths.max()))


def derive_shape_timing(dev, card_name):
    """The tile route's derive of one set (a self-comparison's one
    derive: device_rows_raw with indels, planes and int32 keys, tile 512)
    at each of DERIVE_SHAPES: the whole derive's wall (the uploads of
    order, key and rows and the launch, synchronised) and its
    derive_rows launches; the int8 rows' upload alone (synchronised
    wall, 3 times); derive_rows a call (CUDA events) and its kernel alone
    (torch.profiler); its plain version on the card (synchronised wall);
    the byte bound (each byte read once and written once over HBM). The
    kernel's arrays must equal the plain version's."""
    import torch

    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    peak_bw = PEAKS.get(card_name, (None, None))[1]
    out = {}
    for label, n, mean, std, lo, hi, lpad in DERIVE_SHAPES:
        db = derive_db(n, mean, std, lo, hi, DERIVE_SEED)
        order, key, npad = E.pack_keys(db, 512, True)
        pad = int(db.pad_value)

        def whole():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = K.device_rows_raw(db, order, npad, lpad, True, key, 0,
                                     dev, wide=False, planes=True)
            torch.cuda.synchronize()
            return rows, time.perf_counter() - t0

        whole()
        K.reset_launches()
        rows, wall = whole()
        launches = K.LAUNCHES["derive_rows"]
        host = np.ascontiguousarray(db.seqs)
        uploads = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            raw = K.upload(host, dev)
            torch.cuda.synchronize()
            uploads.append(time.perf_counter() - t0)
        order_full = np.full(npad, n, dtype=np.int64)
        order_full[:n] = order
        o = K.upload(order_full, dev)
        k = rows["key"]

        def kernel():
            return K.derive_rows(raw, o, k, lpad, pad, indels=True,
                                 planes=True)

        ms = cuda_ms(kernel, reps=10)
        dev_ms = kernel_ms(kernel, "derive_rows_kernel")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = K.derive_rows_plain(raw, o, k, lpad, pad, indels=True,
                                   planes=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = kernel()
        differ = sorted(x for x in want if not (torch.equal(got[x], want[x])
                                                and torch.equal(rows[x],
                                                                want[x])))
        c, p = K.plane_chunks(lpad), pad.bit_length()
        n_bytes = (n * min(hi, lpad) + npad * (o.element_size()
                                               + k.element_size())
                   + npad * (2 * lpad + 2 * 4 * c * p))
        bound_ms = n_bytes / peak_bw * 1e3 if peak_bw else None
        out[label] = {"rows": n, "npad": npad, "w": hi, "lpad": lpad,
                      "chunks": c, "planes": p, "derive_wall_s": wall,
                      "launches": launches, "upload_s": uploads,
                      "upload_bytes": host.nbytes, "ms": ms,
                      "kernel_ms": dev_ms, "plain_ms": plain_ms,
                      "bytes": n_bytes, "bound_ms": bound_ms,
                      "bound_by": "HBM bytes", "arrays_differ": differ}
        print(f"  derive at {label}'s shape ({n} rows {hi} wide, {npad} "
              f"padded, lpad {lpad}: C {c}, P {p}): device_rows_raw "
              f"{wall:.6f} s with {launches} derive_rows launch(es); rows' "
              f"upload ({host.nbytes} bytes) {[f'{u:.6f}' for u in uploads]}"
              f" s; derive_rows {ms:.4f} ms a call (CUDA events), the "
              f"kernel alone {fmt_ms(dev_ms)}; plain version on the card "
              f"{plain_ms:.1f} ms; bound {fmt_ms(bound_ms)} ({n_bytes} "
              f"bytes, HBM); arrays differing from the plain version: "
              f"{differ or 0}")
        del rows, raw, got, want, o, k
        if differ or launches != 1:
            raise AssertionError(f"derive at {label}'s shape: arrays "
                                 f"differ {differ}, launches {launches}")
    return out


def keck20_tsv(workdir):
    """The benchmark's keck20 cohort at its configuration's size
    (portbench/gen.py, seed AIRR_SEED) written as a TSV; its path."""
    from portbench import gen

    with open(os.path.join(HERE, "portbench", "configs", "keck20.json")) as f:
        cfg = json.load(f)
    sets = gen.make_sets(cfg, AIRR_SEED)
    path = os.path.join(workdir, "keck20.tsv")
    gen.write_tsv(sets["cohort"], cfg["sets"]["cohort"]["columns"], path)
    return path


def with_ignored_rows(src, dst):
    """src's TSV with rows that -u and -e ignore: a stop codon in every
    37th junction, two in every 1,009th, every 101st junction empty."""
    with open(src) as f, open(dst, "w") as g:
        g.write(f.readline())
        for i, line in enumerate(f):
            head, _, seq = line.rstrip("\n").rpartition("\t")
            if i % 101 == 0:
                seq = ""
            elif i % 1009 == 0:
                seq = seq[:2] + "*" + seq[2:] + "*"
            elif i % 37 == 0:
                seq = seq[:3] + "*" + seq[3:]
            g.write(f"{head}\t{seq}\n")
    return dst


def airr_device_ms(fn, reps=5, warm=1):
    """Mean device milliseconds a call of fn() spends in the parse
    kernels (AIRR_KERNELS), from torch.profiler's CUDA activity; None
    when it records none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and any(k in e.name for k in AIRR_KERNELS))
    return us / reps / 1e3 if us else None


def same_seqdb(a, b):
    """The differences between two SeqDBs, field by field ([] if none)."""
    bad = []
    for k in ("seqs", "lengths", "counts", "rep_no", "v_no", "j_no",
              "row_hash"):
        x, y = getattr(a, k), getattr(b, k)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            bad.append(k)
    for k in ("repertoire_ids", "residues_count", "total_dup_count",
              "shortest", "longest", "ignored_unknown", "ignored_empty", "n"):
        if getattr(a, k) != getattr(b, k):
            bad.append(k)
    if (a.genes.v_names, a.genes.j_names) != (b.genes.v_names,
                                              b.genes.j_names):
        bad.append("genes")
    for k in ("_blob", "_off", "_has"):
        x = np.asarray(getattr(a.sequence_ids, k))
        y = np.asarray(getattr(b.sequence_ids, k))
        if x.dtype != y.dtype or not np.array_equal(x, y):
            bad.append(f"sequence_ids.{k}")
    return bad


def phase_airr_parse(workdir, dev, card_name):
    """Phase 26 (see the module's docstring)."""
    import torch

    from compairr_tpu_torch.config import Options
    from compairr_tpu_torch.core.db import GeneTables
    from compairr_tpu_torch.io import airr, card
    from compairr_tpu_torch.ops import kernels as K
    from compairr_tpu_torch.utils.progress import NullLogger

    ensure_native()
    path = keck20_tsv(workdir)
    cols, off = card._header(path, Options(), False)
    n_bytes = os.path.getsize(path) - off
    spec = K.AirrSpec(cols=cols, nucleotides=False, ignore_counts=False,
                      ignore_genes=False, require_sid=False,
                      def_off=n_bytes + (-n_bytes % 16), def_len=1)
    host = card._upload(torch, path, off, n_bytes, b"1", torch.device("cpu"))
    body = card._upload(torch, path, off, n_bytes, b"1", dev)
    if not torch.equal(body.cpu(), host):
        raise AssertionError("the uploaded body differs from the file")

    def parse(b):
        scan = K.airr_scan(b, n_bytes, spec)
        ids = K.airr_ids(scan, [np.arange(len(f), dtype=np.int32)
                                for f in scan["firsts"]])
        seqs = K.airr_pack(b, scan, scan["longest"], 20)
        off = torch.from_numpy(np.concatenate(scan["tok_off"])).to(b.device)
        ln = torch.from_numpy(np.concatenate(scan["tok_len"])).to(b.device)
        names = K.airr_gather(b, off, ln)
        return scan, ids, seqs, names

    K.reset_launches()
    scan, ids, seqs, names = parse(body)
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.LAUNCHES.items() if k.startswith("airr")}
    t0 = time.perf_counter()
    p_scan, p_ids, p_seqs, p_names = parse(host)
    plain_ms = (time.perf_counter() - t0) * 1e3
    bad = [k for k in ("lines", "n", "flagged", "collisions", "ignored",
                       "ignored_unknown", "ignored_empty", "longest",
                       "shortest", "total_dup", "residues")
           if scan[k] != p_scan[k]]
    bad += [k for k in ("starts", "lengths", "counts", "row_hash", "seq_off")
            if not torch.equal(scan[k].cpu(), p_scan[k])]
    bad += [k for k in ("firsts", "tok_off", "tok_len")
            if not all(np.array_equal(x, y)
                       for x, y in zip(scan[k], p_scan[k]))]
    for k, x, y in (("ids", ids, p_ids), ("seqs", seqs, p_seqs),
                    ("names", names[0], p_names[0]),
                    ("name_offsets", names[1], p_names[1])):
        if not torch.equal(x.cpu(), y):
            bad.append(k)
    seq_blob = K.airr_gather(body, scan["seq_off"], scan["lengths"])
    p_seq_blob = K.airr_gather(host, p_scan["seq_off"], p_scan["lengths"])
    if not all(torch.equal(x.cpu(), y) for x, y in zip(seq_blob, p_seq_blob)):
        bad.append("sequence gather")
    n = scan["n"]
    print(f"  {n_bytes} body bytes, {n} rows, lmax {scan['longest']}, "
          f"tokens {[len(f) for f in scan['firsts']]}; launches {launches}; "
          f"plain {plain_ms:.1f} ms")
    if bad or n != AIRR_ROWS or scan["flagged"]:
        raise AssertionError(f"airr_parse differs from plain in {bad} "
                             f"(rows {n}, flagged {scan['flagged']})")
    # an airr_gather call launches its offsets scan and its copy
    need = {"airr_lines": 2, "airr_verify": 1, "airr_ids": 1, "airr_pack": 1,
            "airr_compact": 0, "airr_gather": 2}
    if any(launches[k] != v for k, v in need.items()) or (
            launches["airr_rows"] < 1):
        raise AssertionError(f"airr_parse launches {launches}")
    ms = airr_device_ms(lambda: parse(body))
    written = sum(t.numel() * t.element_size()
                  for t in (seqs, ids, scan["lengths"], scan["counts"],
                            scan["row_hash"]))
    peak_bw = PEAKS.get(card_name, (None, None))[1]
    bound_ms = (n_bytes + written) / peak_bw * 1e3 if peak_bw else None
    print(f"  kernels {fmt_ms(ms)} a parse; bound {fmt_ms(bound_ms)} "
          f"({n_bytes} bytes read, {written} written, HBM)")
    del body, host, scan, ids, seqs, names, p_scan, p_ids, p_seqs, p_names
    del seq_blob, p_seq_blob

    walls, diffs = {}, {}
    ignored = with_ignored_rows(path, os.path.join(workdir, "keck20_ue.tsv"))
    for label, f, opt in (("clean", path, Options()),
                          ("-u -e", ignored,
                           Options(ignore_unknown=True, ignore_empty=True))):
        got = want = None
        for rep in range(3):
            t0 = time.perf_counter()
            got, why = card.read_db_card(f, opt, GeneTables(), NullLogger(),
                                         False, "1", dev)
            walls.setdefault((label, "card"), []).append(
                time.perf_counter() - t0)
            if why is not None:
                raise AssertionError(f"{label}: the card route left: {why}")
            with patched(card, "card_device", lambda *a: None):
                t0 = time.perf_counter()
                want = airr.read_db(f, opt, GeneTables(), NullLogger(),
                                    False, "1")
                walls.setdefault((label, "host"), []).append(
                    time.perf_counter() - t0)
        diffs[label] = same_seqdb(got, want)
        print(f"  read_db {label}: {got.n} rows, ignored "
              f"{got.ignored_unknown}/{got.ignored_empty}; card "
              f"{[round(w, 4) for w in walls[(label, 'card')]]} s, host "
              f"{[round(w, 4) for w in walls[(label, 'host')]]} s; "
              f"differs in {diffs[label]}")
    if any(diffs.values()):
        raise AssertionError(f"card route differs from native: {diffs}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "HBM bytes", "launches": launches, "rows": n,
            "body_bytes": n_bytes, "written_bytes": written,
            "walls_s": {f"{a} {b}": w for (a, b), w in walls.items()}}


def main(argv) -> int:
    import torch

    only = None  # --phases N,M: phases 1, 2 and these alone
    # --cold-tiles: phase 21 also times fresh CLI processes on one card
    # against all (phase_cold_tiles), which TILES_PER_DEVICE_MIN rests on
    cold_tiles = "--cold-tiles" in argv
    argv = [a for a in argv if a != "--cold-tiles"]
    if argv:
        if len(argv) != 2 or argv[0] != "--phases":
            print("usage: chip_smoke.py [--phases N[,N...]] [--cold-tiles]",
                  file=sys.stderr)
            return 2
        only = {"1", "2", *argv[1].split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    report = {"phases": {}}
    failed = []

    def phase(name, fn):
        if only is not None and name.split()[0] not in only:
            return None
        t0 = time.perf_counter()
        print(f"== {name}", flush=True)
        try:
            out = fn()
            ok = True
        except Exception as e:  # a failed phase is reported, then fails the run
            import traceback

            traceback.print_exc()
            failed.append(name)
            out, ok = repr(e), False
        report["phases"][name] = {
            "ok": ok, "seconds": time.perf_counter() - t0,
        }
        print(f"   {name}: {'ok' if ok else 'FAILED'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        return out if ok else None

    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    card = card_line()

    def p1():
        print(f"  nvidia-smi: {card}")
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"device 0: {name}, count {torch.cuda.device_count()}")
        return {"card": card, "name": name}

    report["card"] = phase("1 card", p1)

    def p2():
        native = ensure_native()
        t0 = time.perf_counter()
        # one nvcc for each source, all started together
        with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
            paths = list(pool.map(lambda n: K.build(n, verbose=True),
                                  KERNEL_SOURCES))
        secs = time.perf_counter() - t0
        print(f"  built {', '.join(paths)} in {secs:.1f} s "
              f"(native helpers: {'yes' if native else 'no'})")
        for n in KERNEL_SOURCES:
            K.load_library(n)
        return {"build_s": secs, "native": native}

    report["build"] = phase("2 build", p2)
    if failed:
        print(json.dumps(report))
        return 1

    t0 = time.perf_counter()
    d1, d2 = workload(N_ROWS)
    p = prepare(d1, d2, dev)
    torch.cuda.synchronize()
    print(f"workload: {N_ROWS} x {N_ROWS} rows, {len(p['work'])} tiles of "
          f"{TILE}, lpad {p['lpad']}, r1p {p['r1p']}, r2p {p['r2p']} "
          f"({time.perf_counter() - t0:.1f} s to make and upload)")

    report["kernel_vs_plain"] = phase(
        "3 kernel vs plain",
        lambda: {"max_abs_err": phase_kernel_vs_plain(p, CHECK_TILES)},
    )

    def p4():
        spec = E.MatchSpec(differences=DIFFERENCES, indels=False,
                           ignore_genes=False)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        m = E.dense_matrix(d1, d2, spec, SCORE_PRODUCT, False,
                           tile_m=TILE, tile_n=TILE, device=DEVICE)
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        total = float(m.sum())
        print(f"  dense_matrix: sum {total:.0f} (want {KERNEL_CHECKSUM}), "
              f"launches {launches}, {wall:.2f} s end to end")
        if total != KERNEL_CHECKSUM:
            raise AssertionError(f"matrix sum {total} != {KERNEL_CHECKSUM}")
        if launches["dense_match"] < 1:
            raise AssertionError("dense_matrix did not launch dense_match")
        t0 = time.perf_counter()
        host, npairs = host_matrix(d1, d2)
        print(f"  host route: {npairs} pairs, sum {host.sum():.0f} "
              f"({time.perf_counter() - t0:.1f} s)")
        if not np.array_equal(m, host):
            raise AssertionError("dense matrix differs from the host route")

        ms = cuda_ms(lambda: run_kernel(p, K.SC_PRODUCT), reps=20)
        dev_ms = kernel_ms(lambda: run_kernel(p, K.SC_PRODUCT),
                           "dense_match_kernel")
        k = run_kernel(p, K.SC_PRODUCT)
        t0 = time.perf_counter()
        ref = run_plain(p, K.SC_PRODUCT)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = int((k - ref).abs().max())
        b = bound(p, name)
        tiles = len(p["work"])
        res = {
            "matrix_sum": total, "launches": launches["dense_match"],
            "end_to_end_s": wall, "ms": ms, "kernel_ms": dev_ms,
            "plain_ms": plain_ms, "full_width_max_abs_err": err,
            "tiles": tiles,
            "visited_pairs_per_s": tiles * TILE * TILE / (ms * 1e-3),
            "pairs_per_s": float(N_ROWS) * N_ROWS / (ms * 1e-3),
            **b,
        }
        print(f"  kernel {ms:.4f} ms a launch (CUDA events, 20 launches; "
              f"the kernel alone {fmt_ms(dev_ms)}, torch.profiler), plain "
              f"{plain_ms:.1f} ms, kernel vs plain max abs err {err}")
        print(f"  visited pairs/s {res['visited_pairs_per_s']:.4g}, "
              f"pairs/s {res['pairs_per_s']:.4g}")
        print(f"  bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
              f"({b['bytes']} bytes -> {b['bytes_ms']:.4f} ms; "
              f"{b['equal_key_pairs']} equal-key pairs, {b['ops']:.4g} ops "
              f"-> {b['ops_ms']:.4f} ms); v3's one-hot formulation "
              f"{b['v3_formulation_ops']:.4g} int8 ops -> "
              f"{b['v3_formulation_ms']:.4f} ms")
        if err != 0:
            raise AssertionError("full-width kernel differs from plain")
        return res

    report["full_width"] = phase("4 full width", p4)

    workdir = tempfile.TemporaryDirectory()
    cli_inputs = {}

    def p5():
        cli_inputs.update(cli_files(workdir.name, 30_000))
        launches = phase_cli(workdir.name, cli_inputs, {})
        if min(launches.values()) < 1:
            raise AssertionError(f"a dense CLI run launched no kernel: "
                                 f"{launches}")
        return launches

    report["cli"] = phase("5 CLI end to end", p5)

    # the tile route's data: the dense phase's sets as they are, a copy
    # of set 2 with indel near-duplicates of set 1 rows, and a copy of
    # set 1 with substitution and indel near-duplicates of its own rows
    t0 = time.perf_counter()
    d2i = with_planted(d1, d2, INDEL_FRAC, INDEL_SEED, (1, 2))
    d1s = with_planted(d1, d1, SELF_FRAC, SELF_SEED, (0, 1, 2))
    spec_i = E.MatchSpec(differences=1, indels=True, ignore_genes=False)
    spec_self = E.MatchSpec(differences=1, indels=True, ignore_genes=False,
                            exclude_self=True)
    spec_d2 = E.MatchSpec(differences=DIFFERENCES, indels=False,
                          ignore_genes=False)
    print(f"tile data: {time.perf_counter() - t0:.1f} s to plant")
    kept = {}
    # the tile route's -g runs (phase 19) and the pairs of their 1M runs,
    # which phase 20 holds dense_indel and dense_general to
    G_TILE_RUNS = {
        "-d 1 -i": (E.MatchSpec(differences=1, indels=True,
                                ignore_genes=True), None),
        "-d 2, COMPAIRR_PIGEONHOLE=0": (
            E.MatchSpec(differences=DIFFERENCES, indels=False,
                        ignore_genes=True), "0"),
    }
    g_pairs = {}

    def p6():
        # the route's own tile, and the other one
        other = OTHER_TILE[E._pair_plan(d1, d2i, spec_i, "cuda")[0]]
        cases = [
            ("two sets -d 1 -i", (d1, d2i, spec_i), {}, {}),
            ("self -d 1 -i", (d1s, d1s, spec_self), {},
             {"xselfs": (True, False)}),
            ("two sets -d 2", (d1, d2, spec_d2), {}, {"ds": (1, 2, 3)}),
            (f"two sets -d 1 -i, tile {other}", (d1, d2i, spec_i),
             {"tile": other}, {}),
            ("nucleotides, lpad 48", (*nt_pair(20_000, 16), spec_i), {}, {}),
        ]
        res = {"count_max_abs_err": 0, "pairs_differing": 0, "cases": {}}
        for label, (a, b, spec), tkw, ckw in cases:
            tp = tile_inputs(a, b, spec, dev, **tkw)
            worst, bad, tiles, matched = compare_tile_kernels(tp, label, **ckw)
            res["count_max_abs_err"] = max(res["count_max_abs_err"], worst)
            res["pairs_differing"] += bad
            res["cases"][label] = {
                "tiles": tp["tiles"], "tile": tp["tile"], "lpad": tp["lpad"],
                "tiles_compared": tiles, "matches": matched,
                "count_max_abs_err": worst, "pairs_differing": bad,
            }
            print(f"  {label}: tile {tp['tile']}, lpad {tp['lpad']}, "
                  f"{tp['tiles']} worklist tiles, {tiles} compared, "
                  f"{matched} matches")
            if label == "two sets -d 1 -i":
                kept["main"] = tp
            if matched == 0:
                raise AssertionError(f"{label}: no match, nothing compared")
        if res["count_max_abs_err"] or res["pairs_differing"]:
            raise AssertionError(f"tile kernels differ from plain: {res}")
        return res

    report["tile_kernels_vs_plain"] = phase("6 tile kernels vs plain", p6)

    def tile_run(a, b, spec, host_env, label):
        """find_pairs on the card against the host route: the tile
        route's launches, pair count and wall."""
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        got = E.find_pairs(a, b, spec, device=DEVICE)
        wall = time.perf_counter() - t0
        launches = {k: K.LAUNCHES[k] for k in ("count_tiles", "extract_tiles")}
        route = E.LAST_ROUTE
        t0 = time.perf_counter()
        with env(**host_env):
            want = E.find_pairs(a, b, spec)
        host_s = time.perf_counter() - t0
        n = len(got[0])
        indel = int((a.lengths[got[0]] != b.lengths[got[1]]).sum())
        same = pairs_equal(got, want)
        print(f"  {label}: {n} pairs ({indel} indel pairs), route {route}, "
              f"launches {launches}, {wall:.2f} s; host route "
              f"({E.LAST_ROUTE}) {len(want[0])} pairs in {host_s:.2f} s; "
              f"pairs and distances equal: {same}")
        if not same:
            raise AssertionError(f"{label}: pairs differ from the host route")
        if route != "tiles" or min(launches.values()) < 1:
            raise AssertionError(f"{label}: route {route}, launches {launches}")
        if indel == 0:
            raise AssertionError(f"{label}: no indel pair found")
        return {"pairs": n, "indel_pairs": indel, "launches": launches,
                "wall_s": wall, "host_s": host_s}

    def p7():
        res = tile_run(d1, d2i, spec_i, {"COMPAIRR_PIGEONHOLE": "all"},
                       "two sets -d 1 -i")
        if res["pairs"] <= MIN_INDEL_PAIRS:
            raise AssertionError(f"{res['pairs']} pairs, want more than "
                                 f"{MIN_INDEL_PAIRS}")
        return res

    report["tiles_full_width"] = phase("7 tiles full width -d 1 -i", p7)

    def p8():
        res = tile_run(d1s, d1s, spec_i, {"COMPAIRR_PIGEONHOLE": "all"},
                       "self -d 1 -i")
        if res["pairs"] <= d1s.n:
            raise AssertionError("the self-comparison found only its "
                                 "diagonal")
        return res

    report["tiles_self"] = phase("8 tiles self-comparison -d 1 -i", p8)

    def p9():
        from compairr_tpu_torch.core.score import pair_scores

        with env(COMPAIRR_PIGEONHOLE="0"):
            torch.cuda.synchronize()
            K.reset_launches()
            i1, i2, _ = E.find_pairs(d1, d2, spec_d2, device=DEVICE,
                                     want_dist=False)
            launches = {k: K.LAUNCHES[k]
                        for k in ("count_tiles", "extract_tiles")}
        route = E.LAST_ROUTE
        m = np.zeros((d1.repertoire_count, d2.repertoire_count))
        np.add.at(m, (d1.rep_no[i1], d2.rep_no[i2]),
                  pair_scores(d1.counts[i1], d2.counts[i2], SCORE_PRODUCT,
                              False))
        dense = E.dense_matrix(d1, d2, spec_d2, SCORE_PRODUCT, False,
                               tile_m=TILE, tile_n=TILE, device=DEVICE)
        same = np.array_equal(m, dense)
        print(f"  -d 2, COMPAIRR_PIGEONHOLE=0: route {route}, {len(i1)} "
              f"pairs, launches {launches}, matrix sum {m.sum():.0f} (want "
              f"{KERNEL_CHECKSUM}), equal to dense_matrix's: {same}")
        if m.sum() != KERNEL_CHECKSUM or not same:
            raise AssertionError("the tile route's matrix differs")
        if route != "tiles" or min(launches.values()) < 1:
            raise AssertionError(f"route {route}, launches {launches}")
        return {"pairs": len(i1), "matrix_sum": float(m.sum()),
                "launches": launches}

    report["tiles_vs_dense"] = phase("9 tile route vs dense engine", p9)

    def p10():
        tp = kept.get("main") or tile_inputs(d1, d2i, spec_i, dev)
        a, b = tp["a"], tp["b"]
        count_ms = count_plain_ms = 0.0
        filtered = []
        for work, cls in tp["streams"]:
            wd = K.upload_worklist(work, dev)
            kw = tile_kw(tp, cls)
            ms = cuda_ms(lambda: K.count_tiles(a, b, wd, **kw), reps=10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            K.count_tiles_plain(a, b, wd, **kw)
            torch.cuda.synchronize()
            pms = (time.perf_counter() - t0) * 1e3
            counts = K.count_tiles(a, b, wd, **kw).cpu().numpy()
            filtered.append((work, counts, cls))
            count_ms += ms
            count_plain_ms += pms
            print(f"  count_tiles class {cls}: {len(work)} tiles, "
                  f"{ms:.4f} ms (CUDA events, 10 launches), plain "
                  f"{pms:.1f} ms")
        total = sum(int(c.sum()) for _, c, _ in filtered)
        extract_ms = extract_plain_ms = 0.0
        matched = []
        for work, counts, cls in filtered:
            if not counts.any():
                continue
            mw, offs, n = matched_offsets(work, counts, dev)
            kw = dict(tile_kw(tp, cls), offsets=offs, total=n)
            ms = cuda_ms(lambda: K.extract_tiles(a, b, mw, **kw), reps=5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            K.extract_tiles_plain(a, b, mw, **kw)
            torch.cuda.synchronize()
            pms = (time.perf_counter() - t0) * 1e3
            extract_ms += ms
            extract_plain_ms += pms
            matched.append((work[counts > 0], cls))
            print(f"  extract_tiles class {cls}: {len(offs)} matched tiles, "
                  f"{n} pairs, {ms:.4f} ms (CUDA events, 5 calls, the "
                  f"error flag's read included), plain {pms:.1f} ms")
        cb = tile_bound(tp, tp["streams"],
                        4 * sum(len(w) for w, _ in tp["streams"]), name)
        eb = tile_bound(tp, matched,
                        8 * total + 8 * sum(len(w) for w, _ in matched),
                        name)
        cf, ef = tile_floor(tp, cb, name), tile_floor(tp, eb, name)
        _, wall, split = timed(
            lambda: E.find_pairs(d1, d2i, spec_i, device=DEVICE))
        for label, ms, pms, bd, fl in (
            ("count_tiles", count_ms, count_plain_ms, cb, cf),
            ("extract_tiles", extract_ms, extract_plain_ms, eb, ef),
        ):
            print(f"  {label}: {ms:.4f} ms a find_pairs call, plain "
                  f"{pms:.1f} ms, design floor {fl['floor_ms']:.6f} ms, "
                  f"bound {bd['bound_ms']:.6f} ms by "
                  f"{bd['bound_by']} ({bd['bytes']} bytes -> "
                  f"{bd['bytes_ms']:.6f} ms; {bd['equal_key_pairs']} "
                  f"equal-key and {bd['key_distance_1_pairs']} key-distance-1 "
                  f"pairs, {bd['ops']} ops -> {bd['ops_ms']:.6f} ms)")
        print(f"  find_pairs end to end {wall:.6f} s, by phase (s): {split}")
        return {
            "tiles": tp["tiles"], "streams": [
                (len(w), c) for w, c in tp["streams"]],
            "count_ms": count_ms, "count_plain_ms": count_plain_ms,
            "count_bound": cb, "count_floor": cf, "extract_ms": extract_ms,
            "extract_plain_ms": extract_plain_ms, "extract_bound": eb,
            "extract_floor": ef,
            "extract_launches": len(matched), "matches": total,
            "find_pairs_s": wall, "find_pairs_phases_s": split,
        }

    report["tile_timing"] = phase("10 tile kernel timing", p10)

    def p11():
        if not cli_inputs:
            cli_inputs.update(cli_files(workdir.name, 30_000))
        return phase_cli_tiles(workdir.name, cli_inputs)

    report["cli_tiles"] = phase("11 CLI tile route", p11)

    def p12():
        start = start_walls()
        res = phase_route_sweep(workdir.name)
        res["start"] = start
        # what a fresh process would pay for the card against the most
        # the tile route saved in the sweep (host - best tile)
        saved = {
            (label, n): min(r["host"]["wall_s"]) - min(
                min(r[t]["wall_s"]) for t in ("tile 128", "tile 512"))
            for label, by_n in res["find_pairs"].items()
            for n, r in by_n.items() if "host" in r}
        (label, n), most = max(saved.items(), key=lambda kv: kv[1])
        print(f"  a fresh process: the tile route's start-up "
              f"{min(x['startup_s'] for x in start):.6f}-"
              f"{max(x['startup_s'] for x in start):.6f} s, against the most "
              f"it saved in this sweep, {most:.6f} s (find_pairs {label}, "
              f"{n} rows a set): card_route keeps substitution runs on the "
              "host")
        res["prefetch"] = phase_prefetch(workdir.name, d1, d2i)
        return res

    report["routing"] = phase("12 routing choices A/B", p12)

    # the dense engine's other two kernels: the indel workload at the
    # engine's default tile (128), the kernel workload at tile 768 and
    # the -g cut
    joins = {}
    g_cut = [subset(x, np.arange(G_ROWS)) for x in (d1, d2)]
    # the cut with 1 % near-duplicates of its set 1 rows planted into its
    # set 2 (substitutions and indels), for phase 13's -g checks
    g_planted = [g_cut[0], with_planted(*g_cut, 0.01, SIDE_SEED, (0, 1, 2))]

    def p13():
        s1, s2 = side_sets(d1, d2)
        w1, w2 = wide_keys(s1), wide_keys(s2)
        pl = [(K.SC_MIN, "min (= Jaccard)"), (K.SC_MAX, "max")]

        def rows(a, b, indels, wide=True, tile=E.TILE_M, by_vjl=True):
            return prepare(a, b, dev, tile, indels=indels, wide=wide,
                           by_vjl=by_vjl)

        joins["indel"] = rows(d1, d2i, True, wide=False)
        joins["general"] = rows(d1, d2, False, tile=TILE)
        big = [with_counts(x, lambda c: c + (1 << 16)) for x in (s1, s2)]
        huge = [with_counts(x, lambda c: c << 32) for x in (s1, s2)]
        cases = [
            ("indel workload -d 1 -i", joins["indel"],
             [("dense_indel product", K.SC_PRODUCT, 1, False),
              ("dense_indel mean", K.SC_SUM, 1, False)]),
            ("indel workload -d 1 -i, wide rows", rows(d1, d2i, True),
             [(f"dense_general {n}", m, 1, False) for m, n in pl]),
            ("kernel workload -d 2, tile 768", joins["general"],
             [*((f"dense_general {n}", m, DIFFERENCES, False) for m, n in pl),
              ("dense_general ratio", K.SC_RATIO, DIFFERENCES, True)]),
            ("keys >= 2^31", rows(w1, w2, True),
             [("dense_general product -d 1 -i", K.SC_PRODUCT, 1, False)]),
            ("keys >= 2^31, -d 2", rows(w1, w2, False),
             [("dense_general product", K.SC_PRODUCT, DIFFERENCES, False)]),
            ("counts >= 2^16", rows(*big, True),
             [("dense_general product", K.SC_PRODUCT, 1, False)]),
            ("counts x 2^32 (float64 sums)", rows(*huge, True),
             [("dense_general product", K.SC_PRODUCT, 1, True)]),
            (f"-g, {G_ROWS} rows a set, -d 1 -i",
             rows(*g_planted, True, wide=False, by_vjl=False),
             [("dense_indel product", K.SC_PRODUCT, 1, False),
              ("dense_indel mean", K.SC_SUM, 1, False)]),
            (f"-g, {G_ROWS} rows a set, -d 1 -i, wide rows",
             rows(*g_planted, True, by_vjl=False),
             [("dense_general min", K.SC_MIN, 1, False)]),
            (f"-g, {G_ROWS} rows a set, -d 2, tile 768",
             rows(*g_planted, False, tile=TILE, by_vjl=False),
             [("dense_general min", K.SC_MIN, DIFFERENCES, False),
              ("dense_general ratio", K.SC_RATIO, DIFFERENCES, True)]),
        ]
        res = {"cases": {}, "indel_max_abs_err": 0.0,
               "general_max_abs_err": 0.0, "ratio_max_rel_err": 0.0}
        for label, jp, cs in cases:
            worst, rel, total = compare_join(jp, label, cs)
            key = ("indel_max_abs_err" if not jp["wide"]
                   else "general_max_abs_err")
            res[key] = max(res[key], worst)
            res["ratio_max_rel_err"] = max(res["ratio_max_rel_err"], rel)
            res["cases"][label] = {
                "tiles": len(jp["work"]), "tile": jp["tile"],
                "max_abs_err": worst, "max_rel_err": rel, "total": total,
            }
        return res

    report["join_kernels_vs_plain"] = phase(
        "13 dense indel/general kernels vs plain", p13)

    def dense_run(a, b, spec, score_int, kernel, tile=None):
        """dense_matrix on the card with every count set to 0 just
        before: (matrix, wall seconds, launches); the kernel must have
        launched once and no other dense kernel."""
        tkw = {} if tile is None else {"tile_m": tile, "tile_n": tile}
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        m = E.dense_matrix(a, b, spec, score_int, False, device=DEVICE, **tkw)
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        dense = {k: launches[k] for k in
                 ("dense_match", "dense_indel", "dense_general")}
        if dense[kernel] != 1 or sum(dense.values()) != 1:
            raise AssertionError(f"{kernel} expected once: {dense}")
        return m, wall, launches

    def p14():
        from compairr_tpu_torch.constants import SCORE_MIN

        pairs = E.find_pairs(d1, d2i, spec_i, device=DEVICE, want_dist=False)
        res = {"pairs": len(pairs[0])}
        for score, score_int, kernel in (
            ("product", SCORE_PRODUCT, "dense_indel"),
            ("min", SCORE_MIN, "dense_general"),
        ):
            m, wall, launches = dense_run(d1, d2i, spec_i, score_int, kernel)
            want = pairs_matrix(d1, d2i, pairs, score_int)
            same = np.array_equal(m, want)
            print(f"  -d 1 -i, {score}: {kernel}, matrix sum "
                  f"{m.sum():.0f}, the tile route's {len(pairs[0])} pairs "
                  f"sum {want.sum():.0f}, equal cell for cell: {same}; "
                  f"{wall:.6f} s end to end")
            if not same:
                raise AssertionError(f"-d 1 -i {kernel}: matrix differs from "
                                     "the tile route's pairs")
            res[kernel] = {"matrix_sum": float(m.sum()), "wall_s": wall,
                           "launches": launches[kernel]}
        return res

    report["dense_indel_full_width"] = phase(
        "14 dense -d 1 -i full width", p14)

    def p15():
        from compairr_tpu_torch.constants import SCORE_MIN, SCORE_RATIO

        pairs = E.find_pairs(d1, d2, spec_d2)  # the host route
        res = {"pairs": len(pairs[0])}
        for score, score_int in (("min", SCORE_MIN), ("ratio", SCORE_RATIO)):
            m, wall, launches = dense_run(d1, d2, spec_d2, score_int,
                                          "dense_general", tile=TILE)
            want = pairs_matrix(d1, d2, pairs, score_int)
            nz = want != 0
            rel = float((np.abs(m - want)[nz] / want[nz]).max())
            ok = (np.array_equal(m, want) if score_int == SCORE_MIN
                  else rel <= RATIO_RTOL and not m[~nz].any())
            print(f"  -d 2, {score}: matrix sum {m.sum()}, host "
                  f"route's {len(pairs[0])} pairs sum {want.sum()}, max rel "
                  f"diff {rel}, {'equal' if ok else 'DIFFERENT'}; "
                  f"{wall:.6f} s end to end")
            if not ok:
                raise AssertionError(f"-d 2 {score}: dense matrix differs "
                                     "from the host route")
            res[score] = {
                "matrix_sum": float(m.sum()), "max_rel_diff": rel,
                "wall_s": wall, "launches": launches["dense_general"]}
        return res

    report["dense_general_full_width"] = phase(
        "15 dense general full width", p15)

    def p16():
        if not cli_inputs:
            cli_inputs.update(cli_files(workdir.name, 30_000))
        return phase_cli_join(workdir.name, cli_inputs)

    report["cli_join"] = phase("16 CLI dense indel/general", p16)

    def p17():
        from compairr_tpu_torch.constants import SCORE_MIN

        res = {}
        for kernel, jp, (a, b, spec, score_int, tile, mode, d) in (
            ("dense_indel", joins.get("indel"),
             (d1, d2i, spec_i, SCORE_PRODUCT, None, K.SC_PRODUCT, 1)),
            ("dense_general", joins.get("general"),
             (d1, d2, spec_d2, SCORE_MIN, TILE, K.SC_MIN, DIFFERENCES)),
        ):
            if jp is None:
                jp = (prepare(d1, d2i, dev, E.TILE_M, indels=True)
                      if kernel == "dense_indel"
                      else prepare(d1, d2, dev, TILE, wide=True))
            ms = cuda_ms(lambda: run_join(jp, mode, d), reps=20)
            dev_ms = kernel_ms(lambda: run_join(jp, mode, d),
                               "dense_join_kernel")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_join(jp, mode, d, plain=True)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            walls = [dense_run(a, b, spec, score_int, kernel, tile)[1]
                     for _ in range(3)]
            bd = dense_bound(*jp["bound"], name)
            fl = tile_floor(jp, bd, name)
            res[kernel] = {"ms": ms, "kernel_ms": dev_ms,
                           "plain_ms": plain_ms,
                           "tiles": len(jp["work"]), "tile": jp["tile"],
                           "dense_matrix_wall_s": walls, **bd,
                           "floor": fl}
            print(f"  {kernel}: {ms:.4f} ms a launch (CUDA events, 20 "
                  f"launches; the kernel alone {fmt_ms(dev_ms)}, "
                  "torch.profiler), "
                  f"{len(jp['work'])} tiles of {jp['tile']}, "
                  f"plain {plain_ms:.1f} ms; design floor "
                  f"{fl['floor_ms']:.6f} ms; bound {bd['bound_ms']:.6f} ms "
                  f"by {bd['bound_by']} ({bd['bytes']} bytes -> "
                  f"{bd['bytes_ms']:.6f} ms; {bd['equal_key_pairs']} "
                  f"equal-key and {bd['key_distance_1_pairs']} "
                  f"key-distance-1 pairs, {bd['ops']:.4g} ops -> "
                  f"{bd['ops_ms']:.6f} ms); dense_matrix walls (s) {walls}")
        res["derive"] = derive_timing(d1, d2i)
        res["-g"] = g_join_timing(g_cut)
        return res

    def derive_timing(a, b):
        """The indel workload's derive as dense_matrix runs it for
        dense_indel, both sets: device_args_raw without planes (the int8
        rows alone) and with them (planes and rplanes besides), in
        AB_ORDER twice after one warm call each: seconds, the card
        synchronised before and after; then derive_shape_timing at the
        benchmark cells' shapes."""
        lpad = E._round_up(int(max(a.longest, b.longest)), 8)
        packed = [E.pack_keys(x, E.TILE_M, True) for x in (a, b)]

        def derive(planes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x, (o, k, n) in zip((a, b), packed):
                K.device_args_raw(x, o, n, lpad, k, dev, indels=True,
                                  planes=planes)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        derive(True)
        derive(False)
        walls = {"planes": [], "rows only": []}
        for planes in AB_ORDER * 2:
            walls["planes" if planes else "rows only"].append(derive(planes))
        print(f"  derive of the indel workload's two sets (device_args_raw, "
              f"indels, {a.n} + {b.n} rows): walls (s) {walls}; planes add "
              f"{np.mean(walls['planes']) - np.mean(walls['rows only']):.6f}"
              " s on average")
        return {"indel_workload": walls,
                "cells": derive_shape_timing(dev, name)}

    def g_join_timing(cut):
        """dense_indel and dense_general under -g at 1M x 1M rows a set
        (keys by length alone), timing only (CUDA events, G_JOIN_REPS
        launches after a warm one): -d 1 -i product at tiles 128 and 768,
        -d 2 min at 128 and 768, -d 2 ratio (float64) at 768; with the
        bound and design floor of each, and the plain version (and the
        kernel) on the same run over the -g cut."""
        runs = (
            ("dense_indel", E.TILE_M, "-d 1 -i product", K.SC_PRODUCT, 1,
             False),
            ("dense_indel", TILE, "-d 1 -i product", K.SC_PRODUCT, 1, False),
            ("dense_general", E.TILE_M, "-d 2 min", K.SC_MIN, DIFFERENCES,
             False),
            ("dense_general", TILE, "-d 2 min", K.SC_MIN, DIFFERENCES,
             False),
            ("dense_general", TILE, "-d 2 ratio", K.SC_RATIO, DIFFERENCES,
             True),
        )
        out = {}
        q = None
        for kernel, tile, what, mode, d, fo in runs:
            kw = dict(indels=kernel == "dense_indel",
                      wide=kernel == "dense_general", by_vjl=False)
            if q is None or (q["tile"], q["indels"], q["wide"]) != (
                    tile, kw["indels"], kw["wide"]):
                q = None
                q = prepare(d1, d2, dev, tile, d, **kw)
            ms = cuda_ms(lambda: run_join(q, mode, d, fo), reps=G_JOIN_REPS,
                         warm=1)
            bd = dense_bound(*q["bound"], name)
            fl = tile_floor(q, bd, name)
            qc = prepare(*cut, dev, tile, d, **kw)
            cut_ms = cuda_ms(lambda: run_join(qc, mode, d, fo), reps=1,
                             warm=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_join(qc, mode, d, fo, plain=True)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            del qc
            label = f"-g {what}, tile {tile}"
            out[label] = {"kernel": kernel, "tiles": len(q["work"]),
                          "tile": tile, "ms": ms, "cut_ms": cut_ms,
                          "cut_plain_ms": plain_ms, **bd, "floor": fl}
            print(f"  {kernel} {label}, {N_ROWS} rows a set: "
                  f"{len(q['work'])} tiles, {ms:.4f} ms a launch (CUDA "
                  f"events, {G_JOIN_REPS} launches after a warm one); design "
                  f"floor {fl['floor_ms']:.6f} ms; bound "
                  f"{bd['bound_ms']:.6f} ms by {bd['bound_by']} "
                  f"({bd['equal_key_pairs']} equal-key and "
                  f"{bd['key_distance_1_pairs']} key-distance-1 pairs, "
                  f"{bd['ops']:.4g} ops -> {bd['ops_ms']:.6f} ms); the "
                  f"{G_ROWS}-row cut: kernel {cut_ms:.4f} ms, plain "
                  f"{plain_ms:.1f} ms")
        return out

    report["join_timing"] = phase("17 dense indel/general timing", p17)

    def p18():
        from compairr_tpu_torch import cli

        res = {}
        # (a) the kernel against its plain version on every tile
        both = [("product", K.SC_PRODUCT), ("-f", K.SC_ONE)]
        c64 = [with_counts(x, lambda c: np.minimum(c, 64)) for x in (d1, d2)]
        worst = 0
        for label, mk, modes in (
            ("kernel workload", lambda: p, both),
            ("kernel workload, counts <= 64", lambda: prepare(*c64, dev),
             [("min", K.SC_MIN), ("max", K.SC_MAX)]),
            ("CLI workload", lambda: prepare(*cli_sets(30_000), dev), both),
            (f"-g, {G_ROWS} rows a set",
             lambda: prepare(*g_cut, dev, by_vjl=False), both),
            ("nucleotides, lpad 48", lambda: prepare(*nt_pair(20_000, 16), dev),
             both),
        ):
            worst = max(worst, compare_onehot(mk(), label, modes))
        res["max_abs_err"] = worst

        # (b) the matrix through dense_onehot under COMPAIRR_V3=0
        sums = {}
        for tag, genes in (("kernel workload", False), ("-g", True)):
            spec = E.MatchSpec(differences=DIFFERENCES, indels=False,
                               ignore_genes=genes)
            with env(COMPAIRR_V3="0"):
                torch.cuda.synchronize()
                K.reset_launches()
                t0 = time.perf_counter()
                m = E.dense_matrix(d1, d2, spec, SCORE_PRODUCT, False,
                                   tile_m=TILE, tile_n=TILE, device=DEVICE)
                wall = time.perf_counter() - t0
                launches = dict(K.LAUNCHES)
            with env(COMPAIRR_V3=None):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = E.dense_matrix(d1, d2, spec, SCORE_PRODUCT, False,
                                     tile_m=TILE, tile_n=TILE, device=DEVICE)
                ref_wall = time.perf_counter() - t0
            same = np.array_equal(m, ref)
            print(f"  dense_matrix {tag}, COMPAIRR_V3=0: sum {m.sum():.0f}, "
                  f"launches {launches}, {wall:.6f} s end to end; equal to "
                  f"dense_match's matrix (sum {ref.sum():.0f}, {ref_wall:.6f} "
                  f"s end to end): {same}")
            if not same:
                raise AssertionError(f"{tag}: dense_onehot's matrix differs")
            if launches["dense_onehot"] < 1 or launches["dense_match"]:
                raise AssertionError(f"{tag}: launches {launches}")
            sums[tag] = {"matrix_sum": float(m.sum()), "wall_s": wall,
                         "dense_match_wall_s": ref_wall,
                         "launches": launches["dense_onehot"]}
        if sums["kernel workload"]["matrix_sum"] != KERNEL_CHECKSUM:
            raise AssertionError("dense_onehot's matrix sum is not "
                                 f"{KERNEL_CHECKSUM}")
        res["matrix"] = sums

        # (c) dense_onehot against dense_match, in turns, on one card: a
        # call (CUDA events over back-to-back wrapper calls) and the
        # kernel alone (torch.profiler), the 1M -g runs with few launches
        res["timing"] = {}
        turns = ("dense_onehot", "dense_match", "dense_match", "dense_onehot")
        for tag, mk, plain, reps in (
            ("kernel workload, tile 768", lambda: p, True, 10),
            ("kernel workload, tile 128", lambda: prepare(d1, d2, dev, 128),
             True, 10),
            ("-g, tile 768", lambda: prepare(d1, d2, dev, by_vjl=False),
             False, G_ONEHOT_REPS),
            ("-g, tile 128",
             lambda: prepare(d1, d2, dev, E.TILE_M, by_vjl=False), False,
             G_ONEHOT_REPS),
            (f"-g, {G_ROWS} rows a set, tile 768",
             lambda: prepare(*g_cut, dev, by_vjl=False), True, 10),
            (f"-g, {G_ROWS} rows a set, tile 128",
             lambda: prepare(*g_cut, dev, E.TILE_M, by_vjl=False), True, 10),
        ):
            q = mk()
            fns = {"dense_onehot": lambda: run_onehot(q, K.SC_PRODUCT),
                   "dense_match": lambda: run_kernel(q, K.SC_PRODUCT)}
            warm = 1 if reps < 10 else 2
            walls = {k: [] for k in turns}
            for kname in turns:
                walls[kname].append(cuda_ms(fns[kname], reps=reps, warm=warm))
            ms = {k: float(np.mean(v)) for k, v in walls.items()}
            dev_ms = {k: kernel_ms(fns[k], f"{k}_kernel", reps=reps,
                                   warm=warm) for k in ms}
            plain_ms = {}
            plains = {"dense_onehot": lambda: run_onehot(q, K.SC_PRODUCT,
                                                         plain=True),
                      "dense_match": lambda: run_plain(q, K.SC_PRODUCT)}
            for kname in ms if plain else ():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plains[kname]()
                torch.cuda.synchronize()
                plain_ms[kname] = (time.perf_counter() - t0) * 1e3
            bd = dense_bound(*q["bound"], name)
            fl = match_floor(q, name)
            sk = skip_floor(q, name)
            ops = onehot_ops(q)
            yard = int_mm_yardstick(sk["skip_ops"] / 2, q["lpad"], dev)
            row = {"tiles": len(q["work"]), "tile": q["tile"], "ms": ms,
                   "kernel_ms": dev_ms, "ms_halves": walls,
                   "plain_ms": plain_ms, **bd, **fl, **sk,
                   "formulation_ops": ops,
                   "formulation_ms": ops / PEAKS[name][0] * 1e3,
                   "int_mm": yard}
            print(f"  {tag}: {len(q['work'])} worklist tiles; "
                  + ", ".join(f"{k} {v:.4f} ms a call, "
                              f"{fmt_ms(dev_ms[k])} the kernel alone"
                              for k, v in ms.items())
                  + f" (CUDA events, 2 x {reps} calls each, in turns: "
                  f"{walls}; torch.profiler), 1 launch a dense_matrix call; "
                  "plain versions "
                  + (", ".join(f"{k} {v:.1f} ms" for k, v in plain_ms.items())
                     or "not timed")
                  + f"; bound {bd['bound_ms']:.6f} ms by {bd['bound_by']} "
                  f"({bd['bytes']} bytes -> {bd['bytes_ms']:.6f} ms; "
                  f"{bd['equal_key_pairs']} equal-key pairs, "
                  f"{bd['ops']:.4g} ops -> {bd['ops_ms']:.6f} ms); "
                  f"dense_match's design floor {fl['floor_ops']:.4g} "
                  f"integer ops -> {fl['floor_ms']:.4f} ms; dense_onehot's "
                  f"formulation {ops:.4g} int8 tensor-core ops -> "
                  f"{row['formulation_ms']:.4f} ms at peak; its skip floor: "
                  f"{sk['sub_blocks_meeting']} of {sk['sub_blocks']} "
                  f"{ONEHOT_SLICE} x {ONEHOT_CHUNK} sub-blocks meet "
                  f"({sk['sub_blocks_meeting'] / sk['sub_blocks']:.4f}), "
                  f"{sk['skip_ops']:.4g} ops -> {sk['skip_floor_ms']:.4f} ms; "
                  f"yardstick (not called by the port) torch._int_mm "
                  f"{yard['shape']} {yard['ms']:.4f} ms "
                  f"({yard['tops']:.1f} TOP/s), x{yard['scale']:.4g} "
                  f"-> {yard['ms_scaled']:.4f} ms for the skip floor's ops")
            res["timing"][tag] = row
            del q

        # (d) the CLI under COMPAIRR_ENGINE=dense COMPAIRR_V3=0
        if not cli_inputs:
            cli_inputs.update(cli_files(workdir.name, 30_000))
        a, b = cli_inputs["a"], cli_inputs["b"]
        flags = ["-m", "-d", "2"]
        host = module_run(flags, (a, b), os.path.join(workdir.name,
                                                      "v3_0.host"), {})
        out = os.path.join(workdir.name, "v3_0.dense")
        with env(COMPAIRR_ENGINE="dense", COMPAIRR_V3="0",
                 COMPAIRR_DEVICE=None):
            K.reset_launches()
            rc = cli.main([*flags, a, b, "-o", out, "-l",
                           os.path.join(workdir.name, "v3_0.log")])
            launches = {k: K.LAUNCHES[k] for k in ("dense_match",
                                                   "dense_onehot")}
        with open(out, "rb") as f:
            dense = f.read()
        print(f"  CLI -m -d 2, COMPAIRR_ENGINE=dense COMPAIRR_V3=0: "
              f"{'byte-equal to' if dense == host else 'DIFFERS from'} the "
              f"host route ({len(host)} bytes), launches {launches}")
        if rc != 0 or dense != host or host.count(b"\n") < 2:
            raise AssertionError("CLI under COMPAIRR_V3=0 differs")
        if launches["dense_onehot"] < 1 or launches["dense_match"]:
            raise AssertionError(f"CLI under COMPAIRR_V3=0: {launches}")
        res["cli"] = launches
        return res

    report["onehot"] = phase("18 dense onehot", p18)
    workdir.cleanup()

    def p19():
        res = {}
        own_pairs = {}
        cut = [subset(x, np.arange(G_ROWS)) for x in (d1, d2i)]
        for rows, (a, b) in ((G_ROWS, cut), (N_ROWS, (d1, d2i))):
            for tag, (spec, pigeonhole) in G_TILE_RUNS.items():
                label = f"-g {tag}, {rows} rows a set"
                with env(COMPAIRR_PIGEONHOLE=pigeonhole):
                    res[label], pairs = tile_route_timing(a, b, spec, label)
                own_pairs[label] = pairs
                if rows == N_ROWS:
                    g_pairs[tag] = pairs
        # the -d 1 -i runs again at the other tile (the routing sweep's
        # 128 against 512 under -g), each with the same pairs
        for rows, (a, b) in ((G_ROWS, cut), (N_ROWS, (d1, d2i))):
            own = res[f"-g -d 1 -i, {rows} rows a set"]
            other = OTHER_TILE[own["tile"]]
            label = f"-g -d 1 -i, {rows} rows a set, tile {other}"
            with forced_tile(other):
                res[label], pairs = tile_route_timing(
                    a, b, G_TILE_RUNS["-d 1 -i"][0], label)
            if not pairs_equal((*pairs, None), (
                    *own_pairs[f"-g -d 1 -i, {rows} rows a set"], None)):
                raise AssertionError(f"{label}: other pairs than at tile "
                                     f"{own['tile']}")
            print(f"  -g -d 1 -i, {rows} rows a set: find_pairs "
                  f"{own['find_pairs_s']:.6f} s at tile {own['tile']}, "
                  f"{res[label]['find_pairs_s']:.6f} s at {other}")
        return res

    report["tiles_g"] = phase("19 tile route under -g (timing)", p19)

    def p20():
        from compairr_tpu_torch.constants import SCORE_MIN

        res = {}
        for tag, score, score_int, kernel in (
            ("-d 1 -i", "product", SCORE_PRODUCT, "dense_indel"),
            ("-d 2, COMPAIRR_PIGEONHOLE=0", "min", SCORE_MIN,
             "dense_general"),
        ):
            spec, pigeonhole = G_TILE_RUNS[tag]
            pairs = g_pairs.get(tag)
            if pairs is None:  # phase 19 did not run: the tile route now
                with env(COMPAIRR_PIGEONHOLE=pigeonhole):
                    pairs = E.find_pairs(d1, d2i, spec, device=DEVICE,
                                         want_dist=False)[:2]
                if E.LAST_ROUTE != "tiles":
                    raise AssertionError(f"-g {tag}: route {E.LAST_ROUTE}")
            m, wall, launches = dense_run(d1, d2i, spec, score_int, kernel)
            want = pairs_matrix(d1, d2i, pairs, score_int)
            same = np.array_equal(m, want)
            indel = int((d1.lengths[pairs[0]] != d2i.lengths[pairs[1]]).sum())
            print(f"  -g {tag.split(',')[0]}, {score}, {N_ROWS} rows a set: "
                  f"{kernel}, matrix sum {m.sum():.0f}, the tile route's "
                  f"{len(pairs[0])} pairs ({indel} indel pairs) sum "
                  f"{want.sum():.0f}, equal cell for cell: {same}; "
                  f"dense_matrix {wall:.6f} s end to end")
            if not same or want.sum() == 0:
                raise AssertionError(f"-g {tag} {kernel}: matrix differs from "
                                     "the tile route's pairs")
            if spec.indels and indel == 0:
                raise AssertionError(f"-g {tag}: no indel pair compared")
            res[tag] = {"kernel": kernel, "pairs": len(pairs[0]),
                        "indel_pairs": indel, "matrix_sum": float(m.sum()),
                        "wall_s": wall, "launches": launches[kernel]}
        return res

    report["join_g"] = phase("20 dense indel/general under -g vs tile route",
                             p20)

    def p21():
        from compairr_tpu_torch.constants import SCORE_RATIO
        from compairr_tpu_torch.graft_entry import dryrun_multichip
        from compairr_tpu_torch.parallel import mesh, worker

        from compairr_tpu_torch.utils.device import local_devices

        local = local_devices(DEVICE)  # one card: every shard on cuda:0

        def devs(n):
            return [local[i % len(local)] for i in range(n)]

        spec_d2 = E.MatchSpec(differences=DIFFERENCES, indels=False,
                              ignore_genes=False)
        res = {"walls_s": {}, "stats": {}}

        def multi(a, b, spec, score, kernel, n, ring=False, **tkw):
            """One run over n shards (devs(n)) with every count set to 0
            just before: (matrix, wall, launches of kernel, LAST_STATS);
            no other kernel may launch, and each shard with work (each
            step of a shard, on the ring) launches `kernel` once."""
            run = mesh.dense_matrix_ring if ring else mesh.dense_matrix_sharded
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
            m = run(a, b, spec, score, False, devices=devs(n), **tkw)
            wall = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
            stats = dict(mesh.LAST_STATS)
            others = {k: v for k, v in launches.items() if k != kernel and v}
            want = (None if ring
                    else sum(1 for t in stats["real_tiles"] if t))
            if others or launches[kernel] < 1 or (
                    want is not None and launches[kernel] != want):
                raise AssertionError(f"{n} shards: launches {launches}, "
                                     f"{want} shards with work")
            return m, wall, launches[kernel], stats

        def check(label, m, want, rtol=0.0):
            same = (np.array_equal(m, want) if rtol == 0
                    else np.allclose(m, want, rtol=rtol, atol=0))
            if not same or want.sum() == 0:
                raise AssertionError(f"{label}: differs from one device's")

        tkw = {"tile_m": TILE, "tile_n": TILE}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single = E.dense_matrix(d1, d2, spec_d2, SCORE_PRODUCT, False,
                                device=DEVICE, **tkw)
        res["walls_s"]["dense_matrix"] = [time.perf_counter() - t0]
        if single.sum() != KERNEL_CHECKSUM:
            raise AssertionError(f"single sum {single.sum()}")
        for turn in range(2):  # in turns: 1, 2, 4 shards, twice
            for n in (1, 2, 4):
                m, wall, launches, stats = multi(d1, d2, spec_d2,
                                                 SCORE_PRODUCT,
                                                 "dense_match", n, **tkw)
                check(f"dense_match, {n} shards", m, single)
                res["walls_s"].setdefault(f"sharded {n}", []).append(wall)
                res["stats"][f"sharded {n}"] = stats
                res.setdefault("launches", {})[f"dense_match {n}"] = launches
        for n in (1, 2, 4):
            st = res["stats"][f"sharded {n}"]
            print(f"  kernel workload, dense_matrix_sharded over {n} shards "
                  f"on {sorted(set(map(str, devs(n))))}: sum "
                  f"{KERNEL_CHECKSUM}, equal to dense_matrix; "
                  f"walls {res['walls_s'][f'sharded {n}']} s (dense_matrix "
                  f"{res['walls_s']['dense_matrix'][0]:.6f} s); tiles "
                  f"{st['real_tiles']}, pad_fraction {st['pad_fraction']:.6f}"
                  f", pack {st['pack_s']:.6f} s, shard {st['shard_s']:.6f} s,"
                  f" put {st['put_s']:.6f} s, compute {st['compute_s']:.6f} "
                  f"s, allreduce_s {st['allreduce_s']:.6f}, backend "
                  f"{st['backend']}")
        # -g: keys by length alone, a worklist long enough to split; and
        # the default device choice (devices=None: rank_devices(), no
        # more shards than DENSE_TILES_PER_SHARD_MIN tiles each), as the
        # CLI's dense engine takes it
        spec_g = E.MatchSpec(differences=DIFFERENCES, indels=False,
                             ignore_genes=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single_g = E.dense_matrix(d1, d2, spec_g, SCORE_PRODUCT, False,
                                  device=DEVICE, **tkw)
        res["walls_s"]["dense_matrix -g"] = [time.perf_counter() - t0]
        for turn in range(2):
            for n in (1, 2, 4):
                m, wall, _, stats = multi(d1, d2, spec_g, SCORE_PRODUCT,
                                          "dense_match", n, **tkw)
                check(f"-g dense_match, {n} shards", m, single_g)
                res["walls_s"].setdefault(f"sharded {n} -g", []).append(wall)
                res["stats"][f"sharded {n} -g"] = stats
        for n in (1, 2, 4):
            st = res["stats"][f"sharded {n} -g"]
            print(f"  -g workload, dense_matrix_sharded over {n} shards on "
                  f"{sorted(set(map(str, devs(n))))}: equal to dense_matrix;"
                  f" walls {res['walls_s'][f'sharded {n} -g']} s "
                  f"(dense_matrix {res['walls_s']['dense_matrix -g'][0]:.6f}"
                  f" s); tiles {st['real_tiles']}, put {st['put_s']:.6f} s, "
                  f"compute {st['compute_s']:.6f} s")
        for label, spec, want in (("kernel", spec_d2, single),
                                  ("-g", spec_g, single_g)):
            t0 = time.perf_counter()
            m = mesh.dense_matrix_sharded(d1, d2, spec, SCORE_PRODUCT, False,
                                          **tkw)
            wall = time.perf_counter() - t0
            check(f"{label} workload, default devices", m, want)
            st = dict(mesh.LAST_STATS)
            res["stats"][f"default {label}"] = dict(st, wall_s=wall)
            print(f"  {label} workload, default devices ({len(local)} "
                  f"card(s), {sum(st['real_tiles'])} tiles, at least "
                  f"{mesh.DENSE_TILES_PER_SHARD_MIN} a shard): "
                  f"{st['devices']} shard(s), equal; {wall:.6f} s")

        # a one-shot process on one card and on every card, as the CLI
        # runs: the other cards' first use is part of the wall
        if len(local) > 1:
            for label, want in (("kernel", single), ("-g", single_g)):
                for n in (1, len(local), 1, len(local)):
                    cold = cold_wall(label, n)
                    if cold["sum"] != want.sum():
                        raise AssertionError(f"cold {label} {n}: {cold}")
                    res.setdefault("cold", {}).setdefault(
                        f"{label} {n}", []).append(cold)
                print(f"  {label} workload, a fresh process a run (walls, "
                      f"s): one card "
                      f"{[c['wall_s'] for c in res['cold'][f'{label} 1']]}"
                      f", {len(local)} cards "
                      f"{[c['wall_s'] for c in res['cold'][f'{label} {len(local)}']]}"
                      f" ({res['cold'][f'{label} {len(local)}'][0]['shards']}"
                      f" shard(s))")

        shard_ms = launch_ms(
            lambda: mesh.dense_matrix_sharded(d1, d2, spec_d2, SCORE_PRODUCT,
                                              False, devices=devs(4),
                                              **tkw),
            "dense_match_kernel")
        res["shard_kernel_ms"] = shard_ms
        print(f"  each shard's dense_match kernel, 4 shards (torch.profiler):"
              f" {[round(x, 4) for x in shard_ms]} ms")

        with env(COMPAIRR_V3="0"):
            for n in (2, 4):
                m, wall, launches, stats = multi(d1, d2, spec_d2,
                                                 SCORE_PRODUCT,
                                                 "dense_onehot", n, **tkw)
                check(f"dense_onehot, {n} shards", m, single)
                res["walls_s"][f"sharded {n}, COMPAIRR_V3=0"] = [wall]
                print(f"  COMPAIRR_V3=0 over {n} shards: sum "
                      f"{m.sum():.0f}, equal; {launches} dense_onehot "
                      f"launches, {wall:.6f} s")

        m, wall, launches, stats = multi(d1, d2, spec_d2, SCORE_PRODUCT,
                                         "dense_match", 4, ring=True, **tkw)
        check("ring, 4 shards", m, single)
        res["walls_s"]["ring 4"] = [wall]
        res["stats"]["ring 4"] = stats
        print(f"  dense_matrix_ring over 4 shards: sum {m.sum():.0f}, equal; "
              f"{launches} dense_match launches, {wall:.6f} s (hand-offs "
              f"{stats['handoff_s']:.6f} s)")

        for score, kernel, rtol in ((SCORE_PRODUCT, "dense_indel", 0.0),
                                    (SCORE_RATIO, "dense_general", 1e-12)):
            want = E.dense_matrix(d1, d2i, spec_i, score, False,
                                  device=DEVICE)
            m, wall, launches, stats = multi(d1, d2i, spec_i, score, kernel,
                                             4)
            check(f"{kernel}, 4 shards", m, want, rtol)
            err = float(np.max(np.abs(m - want) / np.maximum(np.abs(want),
                                                              1e-300)))
            res[f"indel workload {kernel}"] = {
                "wall_s": wall, "launches": launches, "max_rel_err": err,
                "pad_fraction": stats["pad_fraction"]}
            print(f"  indel workload -d 1 -i, {kernel} over 4 shards: sum "
                  f"{m.sum()}, largest relative difference {err:.3g} "
                  f"(limit {rtol}); {launches} launches, {wall:.6f} s")

        # the split itself, at the smallest threshold that splits this
        # worklist (TILES_PER_DEVICE_MIN is far above its tiles a card)
        with patched(E, "TILES_PER_DEVICE_MIN", TILES_PER_DEVICE_SPLIT):
            want_launches, sizes = count_spans(d1, d2i, spec_i, 4)
            one = E.find_pairs(d1, d2i, spec_i, devices=devs(1),
                               want_dist=False)
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
            got = E.find_pairs(d1, d2i, spec_i, devices=devs(4),
                               want_dist=False)
            wall = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
        if E.LAST_ROUTE != "tiles" or not pairs_equal(got, one):
            raise AssertionError("find_pairs over 4 devices differs")
        if launches["count_tiles"] != want_launches:
            raise AssertionError(f"count_tiles launches {launches}, want "
                                 f"{want_launches} (streams {sizes})")
        res["tile_split"] = {"pairs": len(one[0]), "wall_s": wall,
                             "launches": launches, "streams": sizes}
        print(f"  find_pairs -d 1 -i over 4 devices: {len(one[0])} pairs, "
              f"equal to one device's; count_tiles {launches['count_tiles']}"
              f" launches (streams {sizes}), extract_tiles "
              f"{launches['extract_tiles']}; {wall:.6f} s")

        # the tile route's CLI runs in a fresh process a run: one card
        # against every card, split at TILES_PER_DEVICE_SPLIT tiles a
        # card (the split the parent's threshold took) and at
        # engine.TILES_PER_DEVICE_MIN, in turns; each the same bytes
        if len(local) > 1 and cold_tiles:
            res["cold_tiles"] = phase_cold_tiles(d1, d2i, len(local))

        out_dir = os.path.join(HERE, "chiprun_out", "ranks")
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.perf_counter()
        ranks = worker.launch(nproc=2, local_devices=2, device="cuda",
                              timeout=600, case="chip_smoke:kernel_case",
                              out_dir=out_dir)
        res["ranks_wall_s"] = time.perf_counter() - t0
        for r, (sh, ri) in ranks.items():
            check(f"rank {r} sharded", sh, single)
            check(f"rank {r} ring", ri, single)
            with open(os.path.join(out_dir, f"stats_{r}.json")) as f:
                st = json.load(f)
            res["stats"][f"rank {r}"] = st
            print(f"  rank {r} of 2 ({st['sharded']['backend']}, 2 shards "
                  f"each, {len(local)} card(s)): sharded sum {sh.sum():.0f} in "
                  f"{st['sharded']['wall_s']:.6f} s (allreduce_s "
                  f"{st['sharded']['allreduce_s']:.6f}, pad_fraction "
                  f"{st['sharded']['pad_fraction']:.6f}), ring sum "
                  f"{ri.sum():.0f} in {st['ring']['wall_s']:.6f} s "
                  f"(hand-offs {st['ring']['handoff_s']:.6f} s); both "
                  f"equal to one device's")
        dryrun_multichip(4, device="cuda")
        return res

    report["multi_device"] = phase("21 multi-device", p21)

    def p22():
        from compairr_tpu_torch.graft_entry import _entry_dbs, entry

        res = {}
        # entry()'s own sets hold no pair within d=2, so its sums are all
        # zero; the planted sets must give a nonzero sum
        for planted in (False, True):
            step, args = entry(DEVICE, planted=planted)
            torch.cuda.synchronize()
            K.reset_launches()
            out = step(*args)
            torch.cuda.synchronize()
            launches = dict(K.LAUNCHES)
            d1, d2 = _entry_dbs(planted)
            plan = E.dense_plan(d1, d2, E.MatchSpec(2, False, False),
                                SCORE_PRODUCT, False)
            want = E.dense_span(
                plan,
                E.dense_side(plan, d1, plan.order_a, plan.key_a, plan.npad_a,
                             dev),
                E.dense_side(plan, d2, plan.order_b, plan.key_b, plan.npad_b,
                             dev),
                plan.work)
            equal = torch.equal(out, want)
            print(f"  entry(planted={planted}): {plan.kind} over "
                  f"{len(plan.work)} tiles, {tuple(out.shape)} {out.dtype} "
                  f"sums, total {int(out.sum())}; launches {launches}; equal "
                  f"to dense_span: {equal}")
            if out.shape[0] < 4 or out.shape[1] < 4 or not equal:
                raise AssertionError("entry() differs from dense_span")
            if planted and int(out.sum()) <= 0:
                raise AssertionError("entry(planted=True) matched no pair")
            if launches["dense_match"] != 1:
                raise AssertionError(f"entry() launches {launches}")
            res["planted" if planted else "entry"] = {
                "shape": list(out.shape), "sum": int(out.sum()),
                "launches": launches["dense_match"]}
        return res

    report["entry"] = phase("22 entry", p22)

    def p23():
        from compairr_tpu_torch import bench

        n = bench.HEADLINE_ROWS
        res = {}
        t0 = time.perf_counter()
        hd = bench._headline_db(n)
        res["dataset_s"] = time.perf_counter() - t0
        print(f"  dataset: {n} rows, {hd.repertoire_count} repertoires, "
              f"lmax {hd.longest}, {res['dataset_s']:.1f} s to make")

        def route(label, **kv):
            with env(**kv):
                K.reset_launches()
                (wall, total, npairs, m), secs, split = timed(
                    lambda: bench._headline(n, hd))
                launches = dict(K.LAUNCHES)
            r = {"best_wall_s": wall, "section_s": secs, "checksum": total,
                 "matched_pairs": npairs, "route": E.LAST_ROUTE,
                 "tile": E.LAST_TILE, "launches": launches, "phases": split}
            res[label] = r
            print(f"  {label} route ({E.LAST_ROUTE}): {npairs} pairs, "
                  f"checksum {total:.0f} (want {HEADLINE_PAIRS}, "
                  f"{HEADLINE_CHECKSUM}); best of the bench's runs "
                  f"{wall:.6f} s, section {secs:.6f} s; launches "
                  f"{launches}")
            for rep, parts in split[-2:]:
                print(f"    {rep}: {parts}")
            if npairs != HEADLINE_PAIRS or total != HEADLINE_CHECKSUM:
                raise AssertionError(f"{label} headline: {npairs} pairs, "
                                     f"checksum {total}")
            return m

        # the default routing (card_route: the host pigeonhole), against
        # the tile route forced
        host = route("host", COMPAIRR_PIGEONHOLE=None)
        tiles = route("tile", COMPAIRR_PIGEONHOLE="0")
        tl, tile = res["tile"]["launches"], res["tile"]["tile"]
        print(f"    tile route: {tile}-row tiles; count_tiles "
              f"{tl['count_tiles']}, extract_tiles {tl['extract_tiles']} "
              "launches over the bench's runs")
        if res["host"]["route"] != "pigeonhole" or any(
                res["host"]["launches"].values()):
            raise AssertionError(f"default route: {res['host']['route']}, "
                                 f"launches {res['host']['launches']}")
        if res["tile"]["route"] != "tiles" or tile != 512 or min(
                tl["count_tiles"], tl["extract_tiles"]) < 1:
            raise AssertionError(f"tile route: {res['tile']}")
        if not np.array_equal(tiles, host):
            raise AssertionError("tile route matrix differs from the host's")

        spec = E.MatchSpec(differences=2, indels=False, ignore_genes=False)
        for t in (E.TILE_M, TILE):
            K.reset_launches()
            m, secs, split = timed(lambda: E.dense_matrix(
                hd, hd, spec, SCORE_PRODUCT, False, tile_m=t, tile_n=t,
                device=DEVICE))
            launches = dict(K.LAUNCHES)
            run, plan, a, _ = bench.prepared_dense(hd, hd, t, dev)
            ms = cuda_ms(run, reps=3, warm=1)
            bd = dense_bound(plan, a, a, name)
            r = {"wall_s": secs, "sum": float(m.sum()), "launches": launches,
                 "tiles": len(plan.work), "kernel": plan.kind, "ms": ms,
                 "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
                 "phases": split}
            res[f"dense {t}"] = r
            del run, plan, a
            print(f"  dense_matrix at tile {t}: sum {m.sum():.0f}, "
                  f"{r['tiles']} tiles, {secs:.6f} s, launches {launches}; "
                  f"{r['kernel']} {ms:.4f} ms a call (CUDA events), bound "
                  f"{bd['bound_ms']:.6f} ms by {bd['bound_by']} "
                  f"({bd['equal_key_pairs']} equal-key pairs, "
                  f"{bd['ops']:.6g} ops)")
            for rep, parts in split:
                print(f"    {rep}: {parts}")
            if m.sum() != HEADLINE_CHECKSUM or not np.array_equal(m, host):
                raise AssertionError(f"dense tile {t}: sum {m.sum()}, not "
                                     "equal to the host route's matrix")
            if launches["dense_match"] != 1:
                raise AssertionError(f"dense tile {t}: launches {launches}")
        return res

    report["headline"] = phase("23 headline", p23)

    def p24():
        from compairr_tpu_torch import bench

        K.reset_launches()
        km = bench._kernel_metrics(TILE, dev)
        launches = dict(K.LAUNCHES)
        print(f"  {json.dumps(km)}")
        print(f"  launches {launches}")
        if km["kernel_checksum"] != KERNEL_CHECKSUM:
            raise AssertionError(f"kernel_checksum {km['kernel_checksum']}")
        if km["kernel_wall_s"] < km["kernel_bound_s"]:
            raise AssertionError("kernel_wall_s below kernel_bound_s: a "
                                 "count or a clock is at fault")
        if launches["dense_match"] < 1:
            raise AssertionError(f"kernel section launches {launches}")
        return dict(km, launches=launches["dense_match"])

    report["kernel_section"] = phase("24 bench kernel section", p24)

    def p25():
        from compairr_tpu_torch.scripts import weak_scaling

        K.reset_launches()
        out = weak_scaling.main(["--per-device", str(WS_ROWS),
                                 "--devices", "4"])
        launches = dict(K.LAUNCHES)
        c1 = out["results"][0]["compute_s"]
        print(f"  launches {launches}; one shard's compute_s {c1:.6f} s "
              f"(at least {WS_MIN_COMPUTE_S})")
        if launches["dense_match"] < 1 or c1 < WS_MIN_COMPUTE_S:
            raise AssertionError("weak scaling: no launch, or one shard's "
                                 "compute below 10 launch costs")
        return dict(out, launches=launches["dense_match"])

    report["weak_scaling"] = phase("25 weak scaling", p25)

    def p26():
        with tempfile.TemporaryDirectory() as workdir:
            return phase_airr_parse(workdir, dev, name)

    report["airr_parse"] = phase("26 airr parse", p26)

    out_dir = os.path.join(HERE, "chiprun_out")
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    except OSError as e:
        print(f"chip_smoke: could not write {out_dir}: {e}", file=sys.stderr)

    if failed:
        print(f"chip_smoke: FAILED phases: {failed}", file=sys.stderr)
        return 1
    if only is not None:
        print(card)
        print(f"chip_smoke: phases {sorted(only, key=int)} passed; the "
              "kernels line needs every phase")
        return 0
    fw = report["full_width"]
    tv, kv = report["tile_timing"], report["tile_kernels_vs_plain"]
    tl = report["tiles_full_width"]["launches"]
    kernels = [{
        "name": "dense_match",
        "route": "cuda",
        "source": "compairr_tpu_torch/csrc/dense_match.cu",
        "replaces": "compairr_tpu/ops/pallas_kernels.py:970",
        "launches": fw["launches"],
        "max_abs_err": max(report["kernel_vs_plain"]["max_abs_err"],
                           fw["full_width_max_abs_err"]),
        "ms": fw["ms"],
        "plain_ms": fw["plain_ms"],
        "bound_ms": fw["bound_ms"],
        "bound_by": fw["bound_by"],
        "library_ms": None,
    }]
    # max_abs_err: the largest count difference for count_tiles, the
    # pairs differing from the plain version's or repeated for
    # extract_tiles
    for kname, line, err, key in (
        ("count_tiles", 1513, kv["count_max_abs_err"], "count"),
        ("extract_tiles", 1683, kv["pairs_differing"], "extract"),
    ):
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "compairr_tpu_torch/csrc/tile_match.cu",
            "replaces": f"compairr_tpu/ops/pallas_kernels.py:{line}",
            "launches": tl[kname],
            "max_abs_err": err,
            "ms": tv[f"{key}_ms"],
            "plain_ms": tv[f"{key}_plain_ms"],
            "bound_ms": tv[f"{key}_bound"]["bound_ms"],
            "bound_by": tv[f"{key}_bound"]["bound_by"],
            "library_ms": None,
        })
    jv, jt = report["join_kernels_vs_plain"], report["join_timing"]
    for kname, line, launches, err in (
        ("dense_indel", 1147,
         report["dense_indel_full_width"]["dense_indel"]["launches"],
         jv["indel_max_abs_err"]),
        ("dense_general", 411,
         report["dense_general_full_width"]["min"]["launches"],
         jv["general_max_abs_err"]),
    ):
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "compairr_tpu_torch/csrc/dense_general.cu",
            "replaces": f"compairr_tpu/ops/pallas_kernels.py:{line}",
            "launches": launches,
            "max_abs_err": err,
            "ms": jt[kname]["ms"],
            "plain_ms": jt[kname]["plain_ms"],
            "bound_ms": jt[kname]["bound_ms"],
            "bound_by": jt[kname]["bound_by"],
            "library_ms": None,
        })
    oh = report["onehot"]
    oh_t = oh["timing"]["kernel workload, tile 768"]
    oh_g = oh["timing"]["-g, tile 768"]
    kernels.append({
        "name": "dense_onehot",
        "route": "cuda",
        "source": "compairr_tpu_torch/csrc/dense_onehot.cu",
        "replaces": "compairr_tpu/ops/pallas_kernels.py:793",
        "launches": oh["matrix"]["kernel workload"]["launches"],
        "max_abs_err": oh["max_abs_err"],
        "ms": oh_t["ms"]["dense_onehot"],
        "plain_ms": oh_t["plain_ms"]["dense_onehot"],
        "bound_ms": oh_t["bound_ms"],
        "bound_by": oh_t["bound_by"],
        "library_ms": None,
        "kernel_ms": oh_t["kernel_ms"]["dense_onehot"],
        "g_ms": oh_g["ms"]["dense_onehot"],
    })
    # max_abs_err: 0, every array equal to the plain version's
    ap = report["airr_parse"]
    kernels.append({
        "name": "airr_parse",
        "route": "cuda",
        "source": "compairr_tpu_torch/csrc/airr_parse.cu",
        "replaces": None,
        "launches": sum(ap["launches"].values()),
        "max_abs_err": 0,
        "ms": ap["ms"],
        "plain_ms": ap["plain_ms"],
        "bound_ms": ap["bound_ms"],
        "bound_by": ap["bound_by"],
        "library_ms": None,
    })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
