"""The card route of read_db: an AIRR TSV tokenised on the card.

The header is read on the host, as native/airr_parser.cpp reads it
(comment lines skipped, later duplicate columns winning). The body goes
to the card in chunks of STAGE_BYTES through two pinned staging
buffers, each chunk's upload overlapping the next chunk's read, into one
device buffer; the kernels of csrc/airr_parse.cu (ops/kernels.py
airr_scan, airr_ids, airr_pack, airr_gather) tokenise and encode it
there, and exactly the arrays the native parser returns come back,
rows ignored under -u and -e left out and counted as it counts them.
The repertoire ids are numbered in first-appearance order and the V and
J names interned through GeneTables in that order, as _read_db_native
does. The route's device buffers are freed before it returns.

A file goes back to the host parser whole when any row would be an
error (fallback "flagged_row"): the job then ends with the host
parser's message and line number, and no result. Two different tokens
that share a key are hashed again from another basis
(kernels.AIRR_KEY_MASKS); a file whose tokens still share one after the
last try goes back too (fallback "collision"), so that no id rests on a
hash.

card_device() is the rule that takes the route, and job_on_card() the
modes' call that lets a fresh process take it. This module imports no
torch at import: it reads whether the process has imported it.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

import numpy as np

from ..core.db import LazyStrList, SeqDB
from ..utils import trace
from .airr import _KNOWN_COLUMNS, _log_read_summary

# CARD_PARSE_MIN_BYTES: the smallest file the card route takes where the
# process has already started CUDA; CARD_PARSE_MIN_BYTES_COLD where it
# has imported torch and not started CUDA, so that the route pays the
# card's start. A process that has not imported torch parses on the host:
# a host-only run never imports torch for its parse, and a CLI job whose
# match runs on a device imports it before its first parse
# (job_on_card). Measured on one
# NVIDIA H100 80GB HBM3 (700 W) against the native parser on one thread,
# on cuts of a keck20 cohort file (medians of 7): the card route costs
# about 3 ms at any size, and the two meet near 280 KB (262 KB: 2.97 ms
# on the card, 2.84 on the host; 524 KB: 3.28 and 4.97; 16 MB: 11.7 and
# 109). In fresh processes with torch imported, the card's start adds
# 0.1 to 0.5 s, and the routes met between 32 MB (0.41 s on the card
# against 0.34 s) and 64 MB (0.63 against 0.73 s; means of two).
CARD_PARSE_MIN_BYTES = 5 << 16
CARD_PARSE_MIN_BYTES_COLD = 48 << 20
STAGE_BYTES = 8 << 20  # a staging buffer: a chunk of the body

_STAGING: list = []  # the process's two pinned buffers, made at first use
_STAGING_LOCK = threading.Lock()


def job_on_card(on_card: bool) -> None:
    """A mode's call before its first read_db: where the job's match
    takes a device route, import torch now, which that route imports
    anyway, so that card_device sees it and the job's parse may take the
    card route in a fresh process. A job on a host route imports
    nothing."""
    if on_card:
        import torch  # noqa: F401


def card_device(filename: Optional[str], opt, shard):
    """The CUDA device read_db parses filename on, or None for the host
    parser: torch imported (by the caller, or by job_on_card for a CLI
    job on a device route), CUDA present and not declined
    (COMPAIRR_DEVICE=cpu), a
    readable regular file (the host parser reports any other), an
    unsharded read, no -k columns, COMPAIRR_NATIVE_IO
    not 0, and the file at least the crossover for the state of CUDA in
    the process."""
    torch = sys.modules.get("torch")
    if (torch is None or not filename or filename == "-"
            or os.environ.get("COMPAIRR_NATIVE_IO", "1") == "0"
            or (shard is not None and tuple(shard) != (0, 1))
            or opt.keep_columns_names or not os.path.isfile(filename)
            or not os.access(filename, os.R_OK)):
        return None
    choice = torch.device(os.environ.get("COMPAIRR_DEVICE", "cuda"))
    if choice.type != "cuda" or not torch.cuda.is_available():
        return None
    least = (CARD_PARSE_MIN_BYTES if torch.cuda.is_initialized()
             else CARD_PARSE_MIN_BYTES_COLD)
    if os.path.getsize(filename) < least:
        return None
    if choice.index is not None:
        return choice
    return torch.device("cuda", torch.cuda.current_device())


def _header(filename: str, opt, require_sequence_id: bool):
    """(columns, body offset): the 1-based column of each of
    kernels.AIRR_FIELDS (0 where absent) and the first byte after the
    header line; None where the file has no header line or lacks an
    essential column (the host parser then gives its result or its
    message)."""
    cols: dict = {}
    off = 0
    with open(filename, "rb") as f:
        for raw in f:
            off += len(raw)
            line = raw[:-1] if raw.endswith(b"\n") else raw
            if line.endswith(b"\r"):
                line = line[:-1]
            if line[:1] in (b"#", b"@"):
                continue
            for no, tok in enumerate(line.split(b"\t"), start=1):
                name = tok.decode("latin-1")
                if name in _KNOWN_COLUMNS:
                    cols[name] = no
            break
        else:
            return None
    need = [opt.seq_header]
    if require_sequence_id:
        need.append("sequence_id")
    if not opt.ignore_counts:
        need.append("duplicate_count")
    if not opt.ignore_genes:
        need += ["v_call", "j_call"]
    if not all(cols.get(name) for name in need):
        return None
    return (cols[opt.seq_header], cols.get("repertoire_id", 0),
            cols.get("sequence_id", 0), cols.get("duplicate_count", 0),
            cols.get("v_call", 0), cols.get("j_call", 0)), off


def _staging(torch) -> list:
    if not _STAGING:
        _STAGING.extend(torch.empty(STAGE_BYTES, dtype=torch.uint8,
                                    pin_memory=True) for _ in range(2))
    return _STAGING


def _upload(torch, filename: str, body_off: int, n_bytes: int, tail: bytes,
            device):
    """The device buffer: the file's n_bytes from body_off, zeros to a
    16-byte multiple, then tail. Chunks go through the pinned staging
    buffers, each one's upload overlapping the next one's read."""
    pad = -n_bytes % 16
    if device.type == "cpu":  # the plain version's input: one read
        with open(filename, "rb") as f:
            f.seek(body_off)
            data = f.read(n_bytes) + bytes(pad) + tail
        return torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())
    buf = torch.empty(n_bytes + pad + len(tail), dtype=torch.uint8,
                      device=device)
    stream = torch.cuda.current_stream(device)
    with _STAGING_LOCK, open(filename, "rb", buffering=0) as f:
        stage = _staging(torch)
        done = [torch.cuda.Event(), torch.cuda.Event()]
        f.seek(body_off)
        pos = k = 0
        while pos < n_bytes:
            i = k & 1
            if k >= 2:
                done[i].synchronize()
            view = memoryview(stage[i].numpy())[:min(STAGE_BYTES,
                                                     n_bytes - pos)]
            got = 0
            while got < len(view):
                step = f.readinto(view[got:])
                if not step:
                    raise OSError(f"{filename} ended while read")
                got += step
            buf[pos:pos + got].copy_(stage[i][:got], non_blocking=True)
            done[i].record(stream)
            pos += got
            k += 1
        for ev in done[:min(k, 2)]:
            ev.synchronize()  # the staging buffers are free for the next file
    extra = np.frombuffer(bytes(pad) + tail, dtype=np.uint8)
    buf[n_bytes:].copy_(torch.from_numpy(extra.copy()))
    return buf


def read_db_card(filename: str, opt, genes, logger,
                 require_sequence_id: bool, default_repertoire_id: str,
                 device):
    """(SeqDB, None) read on the card, as _read_db_native reads it, with
    its log; or (None, reason) where the file leaves the card route
    before the log is written: "header" (no header line, or an
    essential column missing), "flagged_row" (a row that is an error)
    or "collision" (token keys shared after every try). Laps io.read,
    io.scan and io.fetch; counts upload_bytes and d2h_bytes."""
    import torch

    from ..ops import kernels as K

    began = time.monotonic()
    t0 = time.perf_counter_ns()
    head = _header(filename, opt, require_sequence_id)
    filesize = os.path.getsize(filename)
    if head is None or head[1] >= filesize:
        return None, "header"
    cols, body_off = head
    n_bytes = filesize - body_off
    tail = default_repertoire_id.encode("latin-1")
    body = _upload(torch, filename, body_off, n_bytes, tail, device)
    spec = K.AirrSpec(cols=cols, nucleotides=opt.nucleotides,
                      ignore_counts=opt.ignore_counts,
                      ignore_genes=opt.ignore_genes,
                      require_sid=require_sequence_id,
                      def_off=n_bytes + (-n_bytes % 16), def_len=len(tail),
                      ignore_unknown=opt.ignore_unknown,
                      ignore_empty=opt.ignore_empty)
    trace.count("upload_bytes", body.numel())
    t1 = time.perf_counter_ns()
    trace.record("io.read", t0, t1)

    scan = K.airr_scan(body, n_bytes, spec)
    if scan["flagged"]:
        return None, "flagged_row"
    if scan["collisions"]:
        return None, "collision"
    names = _names(torch, K, body, scan)
    ids = [np.arange(len(names[0]), dtype=np.int32),
           np.asarray([genes.intern_v(x) for x in names[1]], np.int32),
           np.asarray([genes.intern_j(x) for x in names[2]], np.int32)]
    ids_dev = K.airr_ids(scan, ids)
    n = scan["n"]
    pad = 4 if opt.nucleotides else 20
    seqs_dev = K.airr_pack(body, scan, scan["longest"], pad)
    sid = None
    if spec.col("sid"):
        sid = K.airr_gather(body, scan["sid_off"], scan["sid_len"])
    t2 = time.perf_counter_ns()
    trace.record("io.scan", t1, t2)

    arrays = {
        "seqs": seqs_dev, "lengths": scan["lengths"],
        "counts": scan["counts"], "row_hash": scan["row_hash"],
        "ids": ids_dev,
    }
    if sid is not None:
        arrays["sid_blob"], arrays["sid_off"] = sid
    host = {k: v.cpu().numpy() for k, v in arrays.items()}
    trace.count("d2h_bytes", sum(v.nbytes for v in host.values()))
    if "sid_off" in host:
        off = host["sid_off"]
        has = (np.diff(off) > 0).astype(np.uint8)
        if off[-1] < 1 << 32:
            off = off.astype(np.uint32)
        sequence_ids = LazyStrList(host["sid_blob"], off, has)
    else:
        sequence_ids = LazyStrList(np.zeros(0, np.uint8),
                                   np.zeros(n + 1, np.uint32),
                                   np.zeros(n, np.uint8))
    logger.progress_init("Reading sequences:", filesize, since=began)
    logger.progress_update(filesize)
    logger.progress_done()
    shortest = scan["shortest"] if n else 0
    _log_read_summary(logger, n, len(names[0]), scan["residues"],
                      shortest, scan["longest"], scan["total_dup"],
                      scan["ignored_unknown"], scan["ignored_empty"])
    logger.progress_init("Indexing:         ", n)
    logger.progress_update(n)
    logger.progress_done()
    db = SeqDB(
        nucleotides=opt.nucleotides, seqs=host["seqs"],
        lengths=host["lengths"], counts=host["counts"],
        rep_no=host["ids"][0], v_no=host["ids"][1], j_no=host["ids"][2],
        sequence_ids=sequence_ids, keep=[None] * n,
        repertoire_ids=names[0], genes=genes,
        ignored_unknown=scan["ignored_unknown"],
        ignored_empty=scan["ignored_empty"], residues_count=scan["residues"],
        total_dup_count=scan["total_dup"], shortest=shortest,
        longest=scan["longest"], row_hash=host["row_hash"].view(np.uint64),
    )
    trace.record("io.fetch", t2, time.perf_counter_ns())
    return db, None


def _names(torch, K, body, scan) -> list:
    """The distinct repertoire, V and J tokens, each kind's in
    first-appearance order, as str (latin-1)."""
    off = np.concatenate(scan["tok_off"]).astype(np.int64)
    length = np.concatenate(scan["tok_len"]).astype(np.int32)
    dev = body.device
    blob, offsets = K.airr_gather(body, torch.from_numpy(off).to(dev),
                                  torch.from_numpy(length).to(dev))
    blob, offsets = blob.cpu().numpy(), offsets.cpu().numpy()
    trace.count("d2h_bytes", blob.nbytes + offsets.nbytes)
    names = [bytes(blob[a:b]).decode("latin-1")
             for a, b in zip(offsets[:-1], offsets[1:])]
    ends = np.cumsum([0] + [len(f) for f in scan["firsts"]])
    return [names[a:b] for a, b in zip(ends[:-1], ends[1:])]
