#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (compairr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from compairr_tpu_torch/csrc, then:

  1. prints the card (nvidia-smi name and power limit, torch's name);
  2. builds the kernel with nvcc and prints the build seconds;
  3. holds each kernel against its plain PyTorch version on the card at
     full width (tile 768, lpad 24, r1p 64, r2p 128): the first
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
  6. prints one JSON line per kernel measured, the card line, and as
     its last line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is present or
any phase fails. Writes every measurement to
chiprun_out/chip_smoke.json as well.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from compairr_tpu_torch.constants import (  # noqa: E402
    AA_CHARS,
    SCORE_PRODUCT,
)
from compairr_tpu_torch.core.db import GeneTables, SeqDB  # noqa: E402

# the JAX package's dense-kernel benchmark workload and its result
N_ROWS = 1_000_000
N_REPS, N_V, N_J = 60, 48, 13
SEEDS = (11, 12, 13)
TILE = 768
DIFFERENCES = 2
KERNEL_CHECKSUM = 24_865_230
CHECK_TILES = 384  # worklist tiles of phase 3

AA_LEN_MEAN, AA_LEN_STD = 14.5, 1.8
LEN_LO, LEN_HI = 9, 22

# published dense peaks of the card, for the bound: int8 tensor-core
# op/s and device memory byte/s (NVIDIA's H100 SXM data sheet, at its
# full 700 W power limit), by the name torch gives the card
PEAKS = {"NVIDIA H100 80GB HBM3": (1979e12, 3.35e12)}


def synth_arrays(n, n_reps, n_v, n_j, seed):
    """Synthetic repertoire with a realistic CDR3 length distribution
    (the same RNG calls, in the same order, as the JAX package's
    benchmark generator)."""
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


def plant_near_dups(d_src, d_dst, frac, seed):
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


def workload(n):
    d1 = synth_arrays(n, N_REPS, N_V, N_J, SEEDS[0])
    d2 = synth_arrays(n, N_REPS, N_V, N_J, SEEDS[1])
    plant_near_dups(d1, d2, 0.01, SEEDS[2])
    return d1, d2


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


def prepare(d1, d2, dev, tile=TILE, differences=DIFFERENCES):
    """The dense engine's inputs on dev: derived rows of both sets and
    the column-major worklist, as engine.dense_matrix builds them."""
    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    lpad = E._round_up(int(max(d1.longest, d2.longest)), 8)
    oa, ka, na = E.pack_keys(d1, tile, True)
    ob, kb, nb = E.pack_keys(d2, tile, True)
    work = E.order_colmajor(
        E.worklist_from_keys(ka, d1.n, kb, d2.n, 0, tile, tile)
    )
    return {
        "a": K.device_args_raw(d1, oa, na, lpad, ka, dev),
        "b": K.device_args_raw(d2, ob, nb, lpad, kb, dev),
        "work": work,
        "work_dev": K.upload_worklist(work, dev),
        "keys": (ka[: d1.n], kb[: d2.n]),
        "lpad": lpad,
        "r1p": E._round_up(d1.repertoire_count, 8),
        "r2p": E._round_up(d2.repertoire_count, 128),
        "tile": tile,
        "differences": differences,
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


def equal_key_pairs(keys_a, keys_b):
    """Pairs with equal bucket keys over the two sets: the pairs the
    function has to compare (every other pair differs in V, J or
    length), which the worklist covers exactly once."""
    ua, ca = np.unique(keys_a, return_counts=True)
    ub, cb = np.unique(keys_b, return_counts=True)
    _, ia, ib = np.intersect1d(ua, ub, return_indices=True)
    return int((ca[ia].astype(np.int64) * cb[ib]).sum())


def touched_rows(starts, tile, npad):
    """Rows of one side that the worklist's tiles cover (each distinct
    tile start once, clipped at the side's npad rows)."""
    s = np.unique(starts[starts >= 0]).astype(np.int64)
    return int((np.minimum(s + tile, npad) - s).sum())


def bound(p, card_name):
    """Least time the card could take for the dense_match call: the
    larger of its bytes over the memory rate and its operations over
    the int8 peak. Bytes: each row a worklist tile covers read once
    (its residues and its key, repertoire and count words; the pad rows
    past the last tile are never read), the worklist read once, the
    matrix written once. Operations: what this data needs, one byte
    compare and one add per residue of every equal-key pair (the other
    pairs of the worklist differ in key and need no residue work)."""
    if card_name not in PEAKS:
        raise ValueError(f"no published peaks for {card_name!r}")
    peak_ops, peak_bw = PEAKS[card_name]
    n_bytes = 0
    for side, col in ((p["a"], 0), (p["b"], 1)):
        row_bytes = sum(
            t[0].numel() * t.element_size() for t in side.values()
        )
        n_bytes += row_bytes * touched_rows(
            p["work"][:, col], p["tile"], side["seqs"].shape[0]
        )
    n_bytes += p["work"].nbytes + p["r1p"] * p["r2p"] * 8
    pairs = equal_key_pairs(*p["keys"])
    ops = 2.0 * pairs * p["lpad"]
    bytes_ms = n_bytes / peak_bw * 1e3
    ops_ms = ops / peak_ops * 1e3
    # the TPU kernel's own formulation (an int8 one-hot product over
    # every pair of every visited tile plus the two chain products,
    # 21 residue classes a position), for comparison
    t = p["tile"]
    v3_ops = len(p["work"]) * (
        2.0 * t * t * 21 * p["lpad"] + 2.0 * p["r1p"] * t * t
        + 2.0 * p["r1p"] * t * p["r2p"]
    )
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": n_bytes,
        "bytes_ms": bytes_ms,
        "equal_key_pairs": pairs,
        "ops": ops,
        "ops_ms": ops_ms,
        "v3_formulation_ops": v3_ops,
        "v3_formulation_ms": v3_ops / peak_ops * 1e3,
        "peak_int8_ops": peak_ops,
        "peak_bytes_per_s": peak_bw,
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


def write_tsv(db, path):
    """An AIRR TSV holding db's rows."""
    letters = np.frombuffer(AA_CHARS.encode(), dtype=np.uint8)
    with open(path, "w") as f:
        f.write("repertoire_id\tsequence_id\tduplicate_count\tv_call\t"
                "j_call\tjunction_aa\n")
        for i in range(db.n):
            s = letters[db.seqs[i, : db.lengths[i]]].tobytes().decode()
            f.write(
                f"{db.repertoire_ids[db.rep_no[i]]}\tS{i}\t{db.counts[i]}\t"
                f"{db.genes.v_names[db.v_no[i]]}\t"
                f"{db.genes.j_names[db.j_no[i]]}\t{s}\n"
            )


CLI_RUNS = (
    ("d2", ["-m", "-d", "2"]),
    ("d2_f", ["-m", "-d", "2", "-f"]),
    ("d0_mh", ["-m", "-d", "0", "-s", "MH"]),
)


def phase_cli(workdir, n, device_env):
    """CLI end to end: each dense run in this process (so its launches
    count) and as `python -m compairr_tpu_torch`, against the host
    route run as `python -m compairr_tpu_torch`. Returns the launches
    of each in-process dense run."""
    from compairr_tpu_torch import cli
    from compairr_tpu_torch.ops import kernels as K

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
    a, b = os.path.join(workdir, "a.tsv"), os.path.join(workdir, "b.tsv")
    write_tsv(d1, a)
    write_tsv(d2, b)

    def module_run(flags, out, env_extra):
        env = dict(os.environ)
        env.pop("COMPAIRR_ENGINE", None)
        env.update(env_extra)
        proc = subprocess.run(
            [sys.executable, "-m", "compairr_tpu_torch", *flags, a, b,
             "-o", out],
            cwd=HERE, env=env, capture_output=True, text=True,
            timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"{flags}: {proc.stderr[-3000:]}")
        with open(out, "rb") as f:
            return f.read()

    launches = {}
    saved = {k: os.environ.get(k) for k in ("COMPAIRR_ENGINE",
                                            *device_env)}
    for tag, flags in CLI_RUNS:
        host = module_run(flags, os.path.join(workdir, f"{tag}.host"), {})
        out = os.path.join(workdir, f"{tag}.dense")
        os.environ.update({"COMPAIRR_ENGINE": "dense", **device_env})
        try:
            K.reset_launches()
            rc = cli.main([*flags, a, b, "-o", out, "-l",
                           os.path.join(workdir, f"{tag}.log")])
            launches[tag] = K.LAUNCHES["dense_match"]
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
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
    mod = module_run(flags, os.path.join(workdir, f"{tag}.module"),
                     {"COMPAIRR_ENGINE": "dense", **device_env})
    with open(os.path.join(workdir, f"{tag}.host"), "rb") as f:
        if mod != f.read():
            raise AssertionError("python -m compairr_tpu_torch with "
                                 "COMPAIRR_ENGINE=dense differs")
    print(f"  python -m compairr_tpu_torch {' '.join(flags)} "
          "(COMPAIRR_ENGINE=dense): byte-equal")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    report = {"phases": {}}
    failed = []

    def phase(name, fn):
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

    dev = torch.device("cuda")
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
        path = K.build("dense_match", verbose=True)
        secs = time.perf_counter() - t0
        print(f"  built {path} in {secs:.1f} s "
              f"(native helpers: {'yes' if native else 'no'})")
        K.load_library("dense_match")
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
                           tile_m=TILE, tile_n=TILE, device="cuda")
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
            "end_to_end_s": wall, "ms": ms, "plain_ms": plain_ms,
            "full_width_max_abs_err": err, "tiles": tiles,
            "visited_pairs_per_s": tiles * TILE * TILE / (ms * 1e-3),
            "pairs_per_s": float(N_ROWS) * N_ROWS / (ms * 1e-3),
            **b,
        }
        print(f"  kernel {ms:.4f} ms a launch (CUDA events, 20 launches), "
              f"plain {plain_ms:.1f} ms, kernel vs plain max abs err {err}")
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

    def p5():
        with tempfile.TemporaryDirectory() as wd:
            launches = phase_cli(wd, 30_000, {})
        if min(launches.values()) < 1:
            raise AssertionError(f"a dense CLI run launched no kernel: "
                                 f"{launches}")
        return launches

    report["cli"] = phase("5 CLI end to end", p5)

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
    fw = report["full_width"]
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
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
