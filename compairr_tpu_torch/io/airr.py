"""AIRR Rearrangement TSV reader.

Replicates the reference's streaming parser semantics
(CompAIRR src/db.cc:172-900): header column discovery,
per-line validation with byte-identical error and warning messages,
residue encoding, repertoire-id interning (per file) and V/J gene
interning (shared across files), the -u/-e/-f/-g/--cdr3/-n behaviours,
and the post-read statistics block.

The hot loop uses bytes.translate for residue encoding (a C-level table
lookup per line); a native C++ parser for very large files plugs in
behind the same interface (see io/native.py).
"""

from __future__ import annotations

import os
import stat as statmod
import sys
from typing import IO, Optional

import numpy as np

from ..config import Options
from ..constants import MAP_AA, MAP_NT
from ..core.db import GeneTables, LazyStrList, SeqDB
from ..utils.progress import Logger, fatal

_BAD = 0xFF  # translate-table marker for unmapped symbols


def _build_translate_table(code_map: np.ndarray) -> bytes:
    out = bytearray([_BAD] * 256)
    for b in range(256):
        code = int(code_map[b])
        if code >= 0:
            out[b] = code
    return bytes(out)


_TRANS_AA = _build_translate_table(MAP_AA)
_TRANS_NT = _build_translate_table(MAP_NT)

# AIRR columns the tool recognises (db.cc:182-219)
_KNOWN_COLUMNS = (
    "repertoire_id",
    "sequence_id",
    "duplicate_count",
    "v_call",
    "j_call",
    "junction",
    "junction_aa",
    "cdr3",
    "cdr3_aa",
)


class _Header:
    """1-based column numbers; 0 = column absent (db.cc:159-168)."""

    def __init__(self):
        for name in _KNOWN_COLUMNS:
            setattr(self, "col_" + name, 0)
        self.keep_columns_no: list[int] = []


def _die(logger: Logger, msg: str) -> None:
    """Data errors are written to the log destination then exit(1),
    exactly like the reference (e.g. db.cc:451-467)."""
    logger.write(msg)
    logger.flush()
    raise SystemExit(1)


def _parse_header(
    line: str,
    hdr: _Header,
    opt: Options,
    require_sequence_id: bool,
    logger: Logger,
) -> None:
    tokens = line.split("\t")
    keep_names = list(opt.keep_columns_names)
    hdr.keep_columns_no = [0] * len(keep_names)
    for i, token in enumerate(tokens, start=1):
        if token in _KNOWN_COLUMNS:
            attr = "col_" + token
            setattr(hdr, attr, i)
        for k, name in enumerate(keep_names):
            if token == name:
                hdr.keep_columns_no[k] = i

    missing: list[str] = []
    if require_sequence_id and not hdr.col_sequence_id:
        missing.append("sequence_id")
    if (not opt.ignore_counts) and not hdr.col_duplicate_count:
        missing.append("duplicate_count")
    if not opt.ignore_genes:
        if not hdr.col_v_call:
            missing.append("v_call")
        if not hdr.col_j_call:
            missing.append("j_call")
    if opt.cdr3:
        if opt.nucleotides:
            if not hdr.col_cdr3:
                missing.append("cdr3")
        else:
            if not hdr.col_cdr3_aa:
                missing.append("cdr3_aa")
    else:
        if opt.nucleotides:
            if not hdr.col_junction:
                missing.append("junction")
        else:
            if not hdr.col_junction_aa:
                missing.append("junction_aa")

    if missing:
        _die(
            logger,
            "\nMissing essential column(s) in header of AIRR TSV input file:"
            + "".join(" " + m for m in missing)
            + "\n",
        )

    if any(no < 1 for no in hdr.keep_columns_no):
        logger.write("\nWarning: missing column(s) to keep in header:")
        for k, no in enumerate(hdr.keep_columns_no):
            if no < 1:
                logger.write(" " + keep_names[k])
        logger.write("\n")


def _parse_count(token: str) -> Optional[int]:
    """strtol-style parse; returns None when illegal or < 1
    (db.cc:545-559). strtol skips leading whitespace only."""
    s = token.lstrip(" \t\n\r\v\f")
    if not s:
        return None
    body = s[1:] if s[0] in "+-" else s
    if not body or not body.isdigit():
        return None
    value = int(s)
    if value < 1:
        return None
    return value


def read_db(
    filename: Optional[str],
    opt: Options,
    genes: GeneTables,
    logger: Logger,
    require_sequence_id: bool,
    default_repertoire_id: str,
    shard: Optional[tuple[int, int]] = None,
) -> SeqDB:
    """Read one AIRR TSV file into a SeqDB (db.cc:708-901).

    Uses the native C++ parser (native/libairr_parser.so) when built
    and the input is a regular file; falls back to the pure-Python
    streaming parser otherwise. Both are semantics-identical.

    shard=(k, n) reads only the k-th of n deterministic line-aligned
    byte chunks — the per-host input sharding of a multi-host run
    (requires the native parser).
    """
    if (
        filename
        and filename != "-"
        and os.path.isfile(filename)
        and os.environ.get("COMPAIRR_NATIVE_IO", "1") != "0"
    ):
        from .native import load_library

        lib = load_library()
        if lib is not None:
            return _read_db_native(
                lib,
                filename,
                opt,
                genes,
                logger,
                require_sequence_id,
                default_repertoire_id,
                shard=shard,
            )
    if shard is not None and shard[1] > 1:
        fatal(
            "Sharded input reading requires the native parser "
            "(build with `make -C native`) and a regular input file."
        )

    if filename is None or filename == "-":
        fp: IO[bytes] = sys.stdin.buffer
        close = False
    else:
        try:
            fp = open(filename, "rb")
        except OSError:
            _die(
                logger,
                f"\nError: Unable to open input data file ({filename}).\n",
            )
        close = True

    try:
        st = os.fstat(fp.fileno())
        is_regular = statmod.S_ISREG(st.st_mode)
    except (OSError, ValueError):
        is_regular = False
    filesize = st.st_size if is_regular else 0
    if not is_regular:
        logger.write("Waiting for data from standard input...\n")

    trans = _TRANS_NT if opt.nucleotides else _TRANS_AA
    pad = 4 if opt.nucleotides else 20
    use_cdr3 = opt.cdr3
    use_nt = opt.nucleotides
    ignore_unknown = opt.ignore_unknown
    ignore_empty = opt.ignore_empty
    ignore_counts = opt.ignore_counts
    ignore_genes = opt.ignore_genes
    keep_count = len(opt.keep_columns_names)

    hdr = _Header()
    state = 0

    seq_buffers: list[bytes] = []
    lengths: list[int] = []
    counts: list[int] = []
    rep_nos: list[int] = []
    v_nos: list[int] = []
    j_nos: list[int] = []
    sequence_ids: list[Optional[str]] = []
    keeps: list[Optional[str]] = []

    rep_names: list[str] = []
    rep_map: dict[str, int] = {}

    ignored_unknown = 0
    ignored_empty = 0
    residues_count = 0
    total_dup = 0
    shortest = 1 << 31
    longest = 0

    logger.progress_init("Reading sequences:", filesize)

    fileread = 0
    lineno = 0
    got_any = False

    for raw in fp:
        got_any = True
        fileread += len(raw)
        lineno += 1
        # latin-1 is byte-transparent: every input byte round-trips, so
        # non-ASCII content behaves exactly like the reference's raw
        # byte handling (outputs are written latin-1 as well).
        line = raw.decode("latin-1")
        if line.endswith("\n"):
            line = line[:-1]
        if line.endswith("\r"):
            line = line[:-1]

        if state == 0:
            if line[:1] in ("#", "@"):
                if is_regular:
                    logger.progress_update(fileread)
                continue
            _parse_header(line, hdr, opt, require_sequence_id, logger)
            state = 1
            if is_regular:
                logger.progress_update(fileread)
            continue

        tokens = line.split("\t")
        ntok = len(tokens)

        def tok(col: int) -> Optional[str]:
            return tokens[col - 1] if 1 <= col <= ntok else None

        # choose the sequence field (db.cc:384-398)
        if use_cdr3:
            raw_seq = tok(hdr.col_cdr3) if use_nt else tok(hdr.col_cdr3_aa)
        else:
            raw_seq = (
                tok(hdr.col_junction) if use_nt else tok(hdr.col_junction_aa)
            )
        raw_seq_str = raw_seq if raw_seq is not None else ""

        # scan & encode (db.cc:408-469)
        seq_bytes = raw_seq_str.encode("latin-1")
        encoded = seq_bytes.translate(trans)
        ignore_seq = False
        if _BAD in encoded:
            # slow path: find offending characters in order
            good = bytearray()
            for ch, enc in zip(seq_bytes, encoded):
                if enc != _BAD:
                    good.append(enc)
                elif 32 <= ch <= 126:
                    if ignore_unknown:
                        ignore_seq = True
                        ignored_unknown += 1
                    else:
                        _die(
                            logger,
                            f"\n\nError: Illegal character '{chr(ch)}' in "
                            f"sequence on line {lineno}. Use -u to ignore.\n",
                        )
                else:
                    _die(
                        logger,
                        f"\n\nError: Illegal character (ascii no {ch}) in "
                        f"sequence on line {lineno}\n",
                    )
            encoded = bytes(good)

        seqlen = len(encoded)
        if seqlen == 0:
            if ignore_empty:
                ignore_seq = True
                ignored_empty += 1
            else:
                _die(
                    logger,
                    f"\n\nError: Empty sequence in sequence on line "
                    f"{lineno}. Use -e to ignore.\n",
                )

        if ignore_seq:
            if is_regular:
                logger.progress_update(fileread)
            continue

        residues_count += seqlen
        if seqlen > longest:
            longest = seqlen
        if seqlen < shortest:
            shortest = seqlen

        # repertoire_id (db.cc:503-520)
        repertoire_id = tok(hdr.col_repertoire_id)
        if repertoire_id is None:
            repertoire_id = default_repertoire_id
        rep_no = rep_map.get(repertoire_id)
        if rep_no is None:
            rep_no = len(rep_names)
            rep_names.append(repertoire_id)
            rep_map[repertoire_id] = rep_no

        # sequence_id (db.cc:523-540)
        sequence_id = tok(hdr.col_sequence_id)
        if sequence_id:
            sid: Optional[str] = sequence_id
        elif require_sequence_id:
            _die(
                logger,
                f"\n\nError: missing or empty sequence_id value on line "
                f"{lineno}\n",
            )
        else:
            sid = None

        # duplicate_count (db.cc:543-573)
        duplicate_count = tok(hdr.col_duplicate_count)
        if duplicate_count:
            value = _parse_count(duplicate_count)
            if value is None:
                _die(
                    logger,
                    f"\n\nError: Illegal duplicate_count on line "
                    f"{lineno}: {duplicate_count}\n",
                )
            count = value
        elif ignore_counts:
            count = 1
        else:
            _die(
                logger,
                f"\n\nError: missing or empty duplicate_count on line "
                f"{lineno}\n",
            )
        total_dup += count

        # v_call / j_call (db.cc:576-631)
        v_call = tok(hdr.col_v_call)
        if not ignore_genes and not v_call:
            _die(
                logger,
                f"\n\nError: missing or empty v_call value on line "
                f"{lineno}\n",
            )
        j_call = tok(hdr.col_j_call)
        if not ignore_genes and not j_call:
            _die(
                logger,
                f"\n\nError: missing or empty j_call value on line "
                f"{lineno}\n",
            )
        v_no = genes.intern_v(v_call if v_call is not None else "")
        j_no = genes.intern_j(j_call if j_call is not None else "")

        # the raw sequence field must have been present (db.cc:634-668)
        if not raw_seq:
            _die(
                logger,
                f"\n\nError: missing or empty {opt.seq_header} value on "
                f"line {lineno}\n",
            )

        # keep columns (db.cc:671-701)
        if keep_count > 0:
            parts = []
            for no in hdr.keep_columns_no:
                val = tok(no) if no >= 1 else None
                parts.append(val if val is not None else "")
            keep: Optional[str] = "\t".join(parts)
        else:
            keep = None

        seq_buffers.append(encoded)
        lengths.append(seqlen)
        counts.append(count)
        rep_nos.append(rep_no)
        v_nos.append(v_no)
        j_nos.append(j_no)
        sequence_ids.append(sid)
        keeps.append(keep)

        if is_regular:
            logger.progress_update(fileread)

    if not got_any:
        fatal("Unable to read from the input file")

    logger.progress_done()
    if close:
        fp.close()

    n = len(seq_buffers)

    _log_read_summary(
        logger, n, len(rep_names), residues_count, shortest, longest,
        total_dup, ignored_unknown, ignored_empty,
    )

    # pack into fixed-width tensors ("Indexing" phase, db.cc:891-900)
    logger.progress_init("Indexing:         ", n)
    lmax = longest if n else 0
    flat = np.frombuffer(b"".join(seq_buffers), dtype=np.int8)
    seqs = _pack_residues(
        flat, np.asarray(lengths, dtype=np.int32), lmax, pad
    )
    if n:
        logger.progress_update(n)
    logger.progress_done()

    return SeqDB(
        nucleotides=opt.nucleotides,
        seqs=seqs,
        lengths=np.asarray(lengths, dtype=np.int32),
        counts=np.asarray(counts, dtype=np.int64),
        rep_no=np.asarray(rep_nos, dtype=np.int32),
        v_no=np.asarray(v_nos, dtype=np.int32),
        j_no=np.asarray(j_nos, dtype=np.int32),
        sequence_ids=sequence_ids,
        keep=keeps,
        repertoire_ids=rep_names,
        genes=genes,
        ignored_unknown=ignored_unknown,
        ignored_empty=ignored_empty,
        residues_count=residues_count,
        total_dup_count=total_dup,
        shortest=shortest if n else 0,
        longest=longest,
    )


def _log_read_summary(
    logger: Logger,
    n: int,
    n_reps: int,
    residues: int,
    shortest: int,
    longest: int,
    total_dup: int,
    ignored_unknown: int,
    ignored_empty: int,
) -> None:
    if ignored_unknown > 0:
        logger.write(
            f"{ignored_unknown} sequences with unknown symbols ignored.\n"
        )
    if ignored_empty > 0:
        logger.write(f"{ignored_empty} empty sequences ignored.\n")
    if n > 0:
        logger.write(
            "Repertoires:       %d\n"
            "Sequences:         %d\n"
            "Residues:          %d\n"
            "Shortest:          %d\n"
            "Longest:           %d\n"
            "Average length:    %.1f\n"
            "Total dupl. count: %d\n"
            % (n_reps, n, residues, shortest, longest,
               1.0 * residues / n, total_dup)
        )
    else:
        logger.write(
            "Repertoires:       %d\n"
            "Sequences:         %d\n"
            "Residues:          %d\n"
            "Shortest:          -\n"
            "Longest:           -\n"
            "Average length:    -\n"
            "Total dupl. count: %d\n"
            % (n_reps, n, residues, total_dup)
        )


def _pack_residues(
    flat: np.ndarray, lens: np.ndarray, lmax: int, pad: int
) -> np.ndarray:
    """Ragged-to-padded residue packing (the "Indexing" phase,
    db.cc:891-900). A flat boolean-mask scatter: orders of magnitude
    faster than 2-D fancy indexing in numpy."""
    n = len(lens)
    seqs = np.full((n, lmax), pad, dtype=np.int8)
    if n:
        mask = np.arange(lmax)[None, :] < lens[:, None]
        seqs.reshape(-1)[mask.reshape(-1)] = flat
    return seqs


# error kinds of the native parser (native/airr_parser.cpp)
_ERR_OPEN = 1
_ERR_MISSING_COLUMNS = 2
_ERR_ILLEGAL_CHAR = 3
_ERR_ILLEGAL_CHAR_NONPRINT = 4
_ERR_EMPTY_SEQ = 5
_ERR_MISSING_SEQUENCE_ID = 6
_ERR_BAD_DUP_COUNT = 7
_ERR_MISSING_DUP_COUNT = 8
_ERR_MISSING_V = 9
_ERR_MISSING_J = 10
_ERR_MISSING_SEQ_VALUE = 11
_ERR_READ = 12


def _native_error(res, opt: Options, filename: str, logger: Logger) -> None:
    """Render a native-parser error with the exact reference message."""
    st = res.status
    ln = res.err_lineno
    if st == _ERR_OPEN:
        _die(
            logger,
            f"\nError: Unable to open input data file ({filename}).\n",
        )
    if st == _ERR_MISSING_COLUMNS:
        mask = res.missing_cols
        names = []
        if mask & 1:
            names.append("sequence_id")
        if mask & 2:
            names.append("duplicate_count")
        if mask & 4:
            names.append("v_call")
        if mask & 8:
            names.append("j_call")
        if mask & 16:
            names.append(opt.seq_header)
        _die(
            logger,
            "\nMissing essential column(s) in header of AIRR TSV input "
            "file:" + "".join(" " + m for m in names) + "\n",
        )
    if st == _ERR_ILLEGAL_CHAR:
        _die(
            logger,
            f"\n\nError: Illegal character '{chr(res.err_char)}' in "
            f"sequence on line {ln}. Use -u to ignore.\n",
        )
    if st == _ERR_ILLEGAL_CHAR_NONPRINT:
        _die(
            logger,
            f"\n\nError: Illegal character (ascii no {res.err_char}) in "
            f"sequence on line {ln}\n",
        )
    if st == _ERR_EMPTY_SEQ:
        _die(
            logger,
            f"\n\nError: Empty sequence in sequence on line {ln}. "
            "Use -e to ignore.\n",
        )
    if st == _ERR_MISSING_SEQUENCE_ID:
        _die(
            logger,
            f"\n\nError: missing or empty sequence_id value on line {ln}\n",
        )
    if st == _ERR_BAD_DUP_COUNT:
        _die(
            logger,
            f"\n\nError: Illegal duplicate_count on line {ln}: "
            f"{res.err_detail}\n",
        )
    if st == _ERR_MISSING_DUP_COUNT:
        _die(
            logger,
            f"\n\nError: missing or empty duplicate_count on line {ln}\n",
        )
    if st == _ERR_MISSING_V:
        _die(
            logger,
            f"\n\nError: missing or empty v_call value on line {ln}\n",
        )
    if st == _ERR_MISSING_J:
        _die(
            logger,
            f"\n\nError: missing or empty j_call value on line {ln}\n",
        )
    if st == _ERR_MISSING_SEQ_VALUE:
        _die(
            logger,
            f"\n\nError: missing or empty {opt.seq_header} value on "
            f"line {ln}\n",
        )
    if st == _ERR_READ:
        fatal("Unable to read from the input file")
    raise AssertionError(f"unknown native parser status {st}")


def _read_db_native(
    lib,
    filename: str,
    opt: Options,
    genes: GeneTables,
    logger: Logger,
    require_sequence_id: bool,
    default_repertoire_id: str,
    shard: Optional[tuple[int, int]] = None,
) -> SeqDB:
    from .native import NativeSession

    # one C++ session per GeneTables: V/J interning is shared across
    # both input files (db.cc:119-125)
    session = getattr(genes, "_native_session", None)
    if session is None:
        session = NativeSession(lib)
        genes._native_session = session

    filesize = os.path.getsize(filename)
    logger.progress_init("Reading sequences:", filesize)
    res = session.parse(
        filename,
        nucleotides=opt.nucleotides,
        cdr3=opt.cdr3,
        ignore_counts=opt.ignore_counts,
        ignore_genes=opt.ignore_genes,
        ignore_unknown=opt.ignore_unknown,
        ignore_empty=opt.ignore_empty,
        require_sequence_id=require_sequence_id,
        default_repertoire_id=default_repertoire_id,
        keep_names=opt.keep_columns_names,
        threads=opt.threads,
        shard=shard if shard is not None else (0, 1),
        # interactive redraws during the (blocking) native parse;
        # file-mode logs emit only the final 100% line either way
        progress=None if logger.to_file else logger.progress_update,
        # merge writes the padded [n, lmax] matrix directly, fusing
        # the packing pass into the parse
        pack_padded=True,
    )
    if res.status != 0:
        _native_error(res, opt, filename, logger)
    logger.progress_update(filesize)

    data = res.arrays()
    n = data["n"]

    # keep-column warning (db.cc:283-295)
    if opt.keep_columns_names and data["keep_missing"].any():
        logger.write("\nWarning: missing column(s) to keep in header:")
        for k, name in enumerate(opt.keep_columns_names):
            if data["keep_missing"][k]:
                logger.write(" " + name)
        logger.write("\n")

    logger.progress_done()

    # remap session gene numbering into the shared GeneTables (robust
    # even if a Python-path parse populated the tables first)
    v_names, j_names = res.gene_names()
    v_remap = np.asarray(
        [genes.intern_v(name) for name in v_names], dtype=np.int32
    )
    j_remap = np.asarray(
        [genes.intern_j(name) for name in j_names], dtype=np.int32
    )
    if n:
        data["v_no"] = v_remap[data["v_no"]]
        data["j_no"] = j_remap[data["j_no"]]

    residues_count = int(data["lengths"].sum())
    _log_read_summary(
        logger,
        n,
        len(data["repertoires"]),
        residues_count,
        data["shortest"],
        data["longest"],
        data["total_dup"],
        data["ignored_unknown"],
        data["ignored_empty"],
    )

    logger.progress_init("Indexing:         ", n)
    pad = 4 if opt.nucleotides else 20
    lmax = data["longest"] if n else 0
    if data.get("packed_lmax", -1) >= 0 and n:
        # the merge already emitted the padded [n, lmax] matrix
        # (fused pack); view it in place — the _keepalive pins the
        # native buffer, and drop_residues must NOT run
        seqs = data["residues"].reshape(n, data["packed_lmax"])
        data["residues"] = None
    else:
        from .native import pack_rows_native

        seqs = pack_rows_native(
            data["residues"], data["lengths"], lmax, pad
        )
        if seqs is None:
            seqs = _pack_residues(
                data["residues"], data["lengths"], lmax, pad
            )
        # the packed matrix now owns the residues; drop the parser's
        # flat arena (it would otherwise double-store every residue —
        # ~350 MB at Keck scale) after discarding the numpy view into it
        data["residues"] = None
        res.drop_residues()
    if n:
        logger.progress_update(n)
    logger.progress_done()

    sequence_ids = LazyStrList(
        data["sid_blob"], data["sid_off"], data["has_sid"]
    )
    if opt.keep_columns_names:
        keeps = LazyStrList(data["keep_blob"], data["keep_off"])
    else:
        keeps = [None] * n

    return SeqDB(
        nucleotides=opt.nucleotides,
        seqs=seqs,
        lengths=data["lengths"],
        counts=data["counts"],
        rep_no=data["rep_no"],
        v_no=data["v_no"],
        j_no=data["j_no"],
        sequence_ids=sequence_ids,
        keep=keeps,
        repertoire_ids=data["repertoires"],
        genes=genes,
        ignored_unknown=data["ignored_unknown"],
        ignored_empty=data["ignored_empty"],
        residues_count=residues_count,
        total_dup_count=data["total_dup"],
        shortest=data["shortest"],
        longest=data["longest"],
        native_keepalive=data["_keepalive"],
        row_hash=data["row_hash"],
    )
