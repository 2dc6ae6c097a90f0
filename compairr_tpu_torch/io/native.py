"""ctypes bindings for the native AIRR TSV parser.

Loads native/libairr_parser.so when present (build with
`make -C native`); io/airr.py transparently falls back to the pure
Python parser otherwise. Both produce identical SeqDBs — see
tests/test_native_parser.py.
"""

from __future__ import annotations

import ctypes as ct
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(root, "native", "libairr_parser.so")


def load_library():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    try:
        lib = ct.CDLL(path)
    except OSError:
        return None

    lib.airr_session_new.restype = ct.c_void_p
    lib.airr_session_free.argtypes = [ct.c_void_p]
    lib.airr_parse.restype = ct.c_void_p
    lib.airr_parse.argtypes = [
        ct.c_void_p,
        ct.c_char_p,
        ct.c_int,
        ct.c_int,
        ct.c_int,
        ct.c_int,
        ct.c_int,
        ct.c_int,
        ct.c_int,
        ct.c_char_p,
        ct.POINTER(ct.c_char_p),
        ct.c_int,
        ct.c_int,  # n_threads
        ct.c_int,  # range_k
        ct.c_int,  # range_n
        ct.c_int,  # pack_padded
    ]
    if hasattr(lib, "airr_packed_lmax"):
        lib.airr_packed_lmax.restype = ct.c_int64
        lib.airr_packed_lmax.argtypes = [ct.c_void_p]
    if hasattr(lib, "airr_parse_progress"):
        lib.airr_parse_progress.restype = ct.c_int64
        lib.airr_parse_progress.argtypes = []
    if hasattr(lib, "group_progress"):
        lib.group_progress.restype = ct.c_int64
        lib.group_progress.argtypes = []
        lib.group_progress_reset.restype = None
        lib.group_progress_reset.argtypes = []
    if hasattr(lib, "airr_drop_residues"):
        lib.airr_drop_residues.argtypes = [ct.c_void_p]
        lib.airr_drop_residues.restype = None
    if hasattr(lib, "airr_drop_row_hash"):
        lib.airr_drop_row_hash.argtypes = [ct.c_void_p]
        lib.airr_drop_row_hash.restype = None
    for name, restype in [
        ("airr_status", ct.c_int32),
        ("airr_err_lineno", ct.c_int64),
        ("airr_err_char", ct.c_int32),
        ("airr_missing_cols", ct.c_int32),
        ("airr_n", ct.c_int64),
        ("airr_residues_size", ct.c_int64),
        ("airr_ignored_unknown", ct.c_int64),
        ("airr_ignored_empty", ct.c_int64),
        ("airr_total_dup", ct.c_int64),
        ("airr_shortest", ct.c_int32),
        ("airr_longest", ct.c_int32),
        ("airr_rep_count", ct.c_int32),
    ]:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = [ct.c_void_p]
    for name in [
        "airr_err_detail",
        "airr_residues",
        "airr_sequence_id_blob",
        "airr_keep_blob",
    ]:
        fn = getattr(lib, name)
        fn.restype = ct.c_void_p
        fn.argtypes = [ct.c_void_p]
    for name in [
        "airr_lengths",
        "airr_rep_no",
        "airr_v_no",
        "airr_j_no",
    ]:
        fn = getattr(lib, name)
        fn.restype = ct.POINTER(ct.c_int32)
        fn.argtypes = [ct.c_void_p]
    if hasattr(lib, "airr_row_hash"):
        lib.airr_row_hash.restype = ct.POINTER(ct.c_uint64)
        lib.airr_row_hash.argtypes = [ct.c_void_p]
    for name in [
        "airr_counts",
        "airr_sequence_id_offsets",
        "airr_keep_offsets",
    ]:
        fn = getattr(lib, name)
        fn.restype = ct.POINTER(ct.c_int64)
        fn.argtypes = [ct.c_void_p]
    for name in [
        "airr_sequence_id_offsets32",
        "airr_keep_offsets32",
    ]:
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype = ct.POINTER(ct.c_uint32)
            fn.argtypes = [ct.c_void_p]
    for name in ["airr_has_sequence_id", "airr_keep_missing"]:
        fn = getattr(lib, name)
        fn.restype = ct.POINTER(ct.c_uint8)
        fn.argtypes = [ct.c_void_p]
    lib.airr_rep_name.restype = ct.c_char_p
    lib.airr_rep_name.argtypes = [ct.c_void_p, ct.c_int32]
    for name in ["airr_v_count", "airr_j_count"]:
        fn = getattr(lib, name)
        fn.restype = ct.c_int32
        fn.argtypes = [ct.c_void_p]
    for name in ["airr_v_name", "airr_j_name"]:
        fn = getattr(lib, name)
        fn.restype = ct.c_char_p
        fn.argtypes = [ct.c_void_p, ct.c_int32]
    lib.airr_result_free.argtypes = [ct.c_void_p]

    for name in ("write_matrix_tsv", "write_threecol_tsv"):
        if not hasattr(lib, name):
            break
    else:
        lib.write_matrix_tsv.restype = ct.c_int
        lib.write_matrix_tsv.argtypes = [
            ct.c_int,
            ct.POINTER(ct.c_double),
            ct.c_int64,
            ct.c_int64,
            ct.POINTER(ct.c_char_p),
            ct.c_char_p,
        ]
        lib.write_threecol_tsv.restype = ct.c_int
        lib.write_threecol_tsv.argtypes = [
            ct.c_int,
            ct.POINTER(ct.c_double),
            ct.c_int64,
            ct.c_int64,
            ct.POINTER(ct.c_char_p),
            ct.POINTER(ct.c_char_p),
            ct.c_char_p,
        ]

    if hasattr(lib, "write_dedup_tsv"):
        lib.write_dedup_tsv.restype = ct.c_int
        lib.write_dedup_tsv.argtypes = [
            ct.c_int,
            ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64),
            ct.c_int64,
            ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_char_p),
            ct.POINTER(ct.c_char_p),
            ct.POINTER(ct.c_char_p),
            ct.POINTER(ct.c_int8),
            ct.c_int64,
            ct.POINTER(ct.c_int32),
            ct.c_char_p,
            ct.c_int,
        ]

    if hasattr(lib, "pack_rows"):
        lib.pack_rows.restype = None
        lib.pack_rows.argtypes = [
            ct.POINTER(ct.c_int8),
            ct.POINTER(ct.c_int32),
            ct.c_int64,
            ct.c_int64,
            ct.c_int8,
            ct.POINTER(ct.c_int8),
        ]
    if hasattr(lib, "pack5_rows"):
        lib.pack5_rows.restype = None
        lib.pack5_rows.argtypes = [
            ct.POINTER(ct.c_int8),
            ct.c_int64,
            ct.c_int64,
            ct.c_int64,
            ct.c_int64,
            ct.c_int64,
            ct.c_int8,
            ct.POINTER(ct.c_int32),
        ]
    if hasattr(lib, "group_rows"):
        lib.group_rows.restype = ct.c_int64
        lib.group_rows.argtypes = [
            ct.POINTER(ct.c_int8),
            ct.c_int64,
            ct.c_int64,
            ct.POINTER(ct.c_int32),
            ct.c_int32,
            ct.POINTER(ct.c_int64),
        ]
    if hasattr(lib, "group_pieces"):
        lib.group_pieces.restype = ct.c_int64
        lib.group_pieces.argtypes = [
            ct.POINTER(ct.c_int8),
            ct.c_int64,
            ct.c_int64,
            ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32),
            ct.c_int32,
            ct.c_int32,
            ct.c_int32,
            ct.POINTER(ct.c_int64),
        ]
    if hasattr(lib, "group_rows_pre"):
        lib.group_rows_pre.restype = ct.c_int64
        lib.group_rows_pre.argtypes = [
            ct.POINTER(ct.c_int8),
            ct.c_int64,
            ct.c_int64,
            ct.POINTER(ct.c_int32),
            ct.c_int32,
            ct.POINTER(ct.c_uint64),
            ct.POINTER(ct.c_int64),
        ]
    if hasattr(lib, "group_rows_pre_mt"):
        lib.group_rows_pre_mt.restype = ct.c_int64
        lib.group_rows_pre_mt.argtypes = [
            ct.POINTER(ct.c_int8),
            ct.c_int64,
            ct.c_int64,
            ct.POINTER(ct.c_int32),
            ct.c_int32,
            ct.POINTER(ct.c_uint64),
            ct.c_int32,
            ct.POINTER(ct.c_int64),
        ]
    if hasattr(lib, "variant_join"):
        lib.variant_join.restype = ct.c_int64
        lib.variant_join.argtypes = [
            ct.POINTER(ct.c_int8),
            ct.c_int64,
            ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int8),
            ct.c_int64,
            ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32),  # big_rep (may be null)
            ct.POINTER(ct.c_uint64),
            ct.c_int32,
            ct.c_int64,
            ct.c_int32,
            ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64),
            ct.c_int64,
            ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64),
        ]
    if hasattr(lib, "group_pieces_mt"):
        lib.group_pieces_mt.restype = ct.c_int64
        lib.group_pieces_mt.argtypes = [
            ct.POINTER(ct.c_int8),
            ct.c_int64,
            ct.c_int64,
            ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32),
            ct.c_int32,
            ct.c_int32,
            ct.c_int32,
            ct.c_int32,
            ct.POINTER(ct.c_int64),
        ]

    if hasattr(lib, "write_cluster_tsv"):
        lib.write_cluster_tsv.restype = ct.c_int
        lib.write_cluster_tsv.argtypes = [
            ct.c_int,
            ct.POINTER(ct.c_int64),
            ct.c_int64,
            ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_char_p),
            ct.POINTER(ct.c_char_p),
            ct.POINTER(ct.c_char_p),
            ct.POINTER(ct.c_int8),
            ct.c_int64,
            ct.POINTER(ct.c_int32),
            ct.c_char_p,
            ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_uint8),
            ct.POINTER(ct.c_uint8),
        ]

    if hasattr(lib, "cluster_bfs"):
        lib.cluster_bfs.restype = ct.c_int64
        lib.cluster_bfs.argtypes = [
            ct.c_int64,
            ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64),
        ]

    _LIB = lib
    return lib


def cluster_bfs_native(adj_start, dst, clusterid, nxt):
    """Native single-linkage BFS (cluster.cc:279-417 semantics).
    Mutates clusterid/nxt in place; returns (seeds, sizes) or None
    when the native library is unavailable."""
    if os.environ.get("COMPAIRR_NATIVE_IO") == "0":
        return None
    lib = load_library()
    if lib is None or not hasattr(lib, "cluster_bfs"):
        return None
    n = len(clusterid)
    seeds = np.empty(n, dtype=np.int64)
    sizes = np.empty(n, dtype=np.int64)
    p = lambda x: x.ctypes.data_as(ct.POINTER(ct.c_int64))
    adj_start = np.ascontiguousarray(adj_start, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    if len(dst) == 0:
        dst = np.zeros(1, dtype=np.int64)
    k = lib.cluster_bfs(
        n, p(adj_start), p(dst), p(clusterid), p(nxt), p(seeds), p(sizes)
    )
    return seeds[:k], sizes[:k]


def write_dedup_native(outfile, db, first, merged,
                       include_genes: bool) -> bool:
    """Stream deduplicate output rows through the native writer
    (CompAIRR src/dedup.cc:27-57 semantics). Returns False when
    unavailable — modes/dedup.py falls back to the Python loop."""
    if os.environ.get("COMPAIRR_NATIVE_IO") == "0":
        return False
    lib = load_library()
    if lib is None or not hasattr(lib, "write_dedup_tsv"):
        return False
    try:
        outfile.flush()
        fd = outfile.fileno()
    except (AttributeError, OSError, ValueError):
        return False
    from ..constants import AA_CHARS, NT_CHARS

    alphabet = (NT_CHARS if db.nucleotides else AA_CHARS) + "?"
    seqs = np.ascontiguousarray(db.seqs, dtype=np.int8)
    first = np.ascontiguousarray(first, dtype=np.int64)
    merged = np.ascontiguousarray(merged, dtype=np.int64)
    rep_no = np.ascontiguousarray(db.rep_no, dtype=np.int32)
    v_no = np.ascontiguousarray(db.v_no, dtype=np.int32)
    j_no = np.ascontiguousarray(db.j_no, dtype=np.int32)
    lengths = np.ascontiguousarray(db.lengths, dtype=np.int32)
    p64 = lambda x: x.ctypes.data_as(ct.POINTER(ct.c_int64))
    p32 = lambda x: x.ctypes.data_as(ct.POINTER(ct.c_int32))
    rc = lib.write_dedup_tsv(
        fd,
        p64(first),
        p64(merged),
        len(first),
        p32(rep_no),
        p32(v_no),
        p32(j_no),
        _label_array(db.repertoire_ids),
        _label_array(db.genes.v_names),
        _label_array(db.genes.j_names),
        seqs.ctypes.data_as(ct.POINTER(ct.c_int8)),
        seqs.shape[1],
        p32(lengths),
        alphabet.encode("latin-1"),
        int(include_genes),
    )
    return rc == 0


def _label_array(labels):
    arr = (ct.c_char_p * max(len(labels), 1))()
    for i, s in enumerate(labels):
        arr[i] = s.encode("latin-1")
    return arr


def write_matrix_native(outfile, values, row_labels, header) -> bool:
    """Stream a post-processed float64 matrix through the native
    writer (exact fprintf %.10lg semantics,
    CompAIRR src/overlap.cc:991-1039). Returns False when the
    native library or a file descriptor is unavailable — callers fall
    back to the Python writer."""
    if os.environ.get("COMPAIRR_NATIVE_IO") == "0":
        return False
    lib = load_library()
    if lib is None or not hasattr(lib, "write_matrix_tsv"):
        return False
    try:
        outfile.flush()
        fd = outfile.fileno()
    except (AttributeError, OSError, ValueError):
        return False
    values = np.ascontiguousarray(values, dtype=np.float64)
    rc = lib.write_matrix_tsv(
        fd,
        values.ctypes.data_as(ct.POINTER(ct.c_double)),
        values.shape[0],
        values.shape[1],
        _label_array(row_labels),
        header.encode("latin-1") if header is not None else None,
    )
    return rc == 0


def write_threecol_native(
    outfile, values, row_labels, col_labels, header
) -> bool:
    """3-column layout twin of write_matrix_native
    (overlap.cc:948-989)."""
    if os.environ.get("COMPAIRR_NATIVE_IO") == "0":
        return False
    lib = load_library()
    if lib is None or not hasattr(lib, "write_threecol_tsv"):
        return False
    try:
        outfile.flush()
        fd = outfile.fileno()
    except (AttributeError, OSError, ValueError):
        return False
    values = np.ascontiguousarray(values, dtype=np.float64)
    rc = lib.write_threecol_tsv(
        fd,
        values.ctypes.data_as(ct.POINTER(ct.c_double)),
        values.shape[0],
        values.shape[1],
        _label_array(row_labels),
        _label_array(col_labels),
        header.encode("latin-1") if header is not None else None,
    )
    return rc == 0


def _np_from(ptr, count, dtype, copy=True):
    if count == 0:
        return np.zeros(0, dtype=dtype)
    buf = ct.cast(
        ptr, ct.POINTER(ct.c_char * (count * np.dtype(dtype).itemsize))
    ).contents
    arr = np.frombuffer(buf, dtype=dtype)
    return arr.copy() if copy else arr


class NativeSession:
    """Wraps the C++ session holding the shared V/J gene interning."""

    def __init__(self, lib):
        self.lib = lib
        self.handle = lib.airr_session_new()

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.airr_session_free(self.handle)
            self.handle = None

    def parse(
        self,
        filename: str,
        *,
        nucleotides: bool,
        cdr3: bool,
        ignore_counts: bool,
        ignore_genes: bool,
        ignore_unknown: bool,
        ignore_empty: bool,
        require_sequence_id: bool,
        default_repertoire_id: str,
        keep_names: tuple,
        threads: int = 1,
        shard: tuple = (0, 1),
        progress=None,
        pack_padded: bool = False,
    ):
        lib = self.lib
        n_keep = len(keep_names)
        keep_arr = (ct.c_char_p * max(n_keep, 1))()
        for i, name in enumerate(keep_names):
            keep_arr[i] = name.encode("latin-1")

        # interactive progress: ctypes releases the GIL for the
        # blocking C parse, so a poller thread reads the library's
        # atomic byte counter (~20 Hz -> a couple hundred redraws for
        # a multi-second parse, matching the reference's granularity,
        # util.cc:28). Skipped when no callback is given (-l file mode
        # suppresses interim redraws anyway).
        poller = None
        stop = None
        if progress is not None and hasattr(lib, "airr_parse_progress"):
            import threading

            # reset BEFORE the poller starts: its first poll can win
            # the race against airr_parse's own reset and would then
            # report the previous file's byte count
            if hasattr(lib, "airr_parse_progress_reset"):
                lib.airr_parse_progress_reset()
            stop = threading.Event()

            def _poll():
                while not stop.wait(0.05):
                    progress(int(lib.airr_parse_progress()))

            poller = threading.Thread(target=_poll, daemon=True)
            poller.start()
        try:
            handle = lib.airr_parse(
                self.handle,
                filename.encode(),
                int(nucleotides),
                int(cdr3),
                int(ignore_counts),
                int(ignore_genes),
                int(ignore_unknown),
                int(ignore_empty),
                int(require_sequence_id),
                default_repertoire_id.encode("latin-1"),
                keep_arr,
                n_keep,
                int(threads),
                int(shard[0]),
                int(shard[1]),
                int(pack_padded),
            )
        finally:
            if poller is not None:
                stop.set()
                poller.join()
        return NativeResult(lib, handle, self, n_keep)


class NativeResult:
    def __init__(self, lib, handle, session, n_keep):
        self.lib = lib
        self.handle = handle
        self.session = session
        self.n_keep = n_keep

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.airr_result_free(self.handle)
            self.handle = None

    def drop_residues(self) -> None:
        """Free the flat residue arena once the packed [n, lmax] matrix
        has adopted it (callers must discard every numpy view into the
        arena first)."""
        if hasattr(self.lib, "airr_drop_residues"):
            self.lib.airr_drop_residues(self.handle)

    def drop_row_hash(self) -> None:
        """Free the row-hash arena (callers must discard every numpy
        view into it first)."""
        if hasattr(self.lib, "airr_drop_row_hash"):
            self.lib.airr_drop_row_hash(self.handle)

    @property
    def status(self) -> int:
        return self.lib.airr_status(self.handle)

    @property
    def err_lineno(self) -> int:
        return self.lib.airr_err_lineno(self.handle)

    @property
    def err_char(self) -> int:
        return self.lib.airr_err_char(self.handle)

    @property
    def err_detail(self) -> str:
        p = self.lib.airr_err_detail(self.handle)
        return ct.cast(p, ct.c_char_p).value.decode("latin-1")

    @property
    def missing_cols(self) -> int:
        return self.lib.airr_missing_cols(self.handle)

    def arrays(self):
        # zero-copy views into the C++ result arenas; the returned dict
        # pins this NativeResult (see _keepalive) so airr_result_free
        # only runs once every view is unreachable
        lib, h = self.lib, self.handle
        n = lib.airr_n(h)
        res_size = lib.airr_residues_size(h)
        residues = _np_from(lib.airr_residues(h), res_size, np.int8,
                            copy=False)
        packed_lmax = (
            int(lib.airr_packed_lmax(h))
            if hasattr(lib, "airr_packed_lmax")
            else -1
        )
        lengths = _np_from(lib.airr_lengths(h), n, np.int32, copy=False)
        counts = _np_from(lib.airr_counts(h), n, np.int64, copy=False)
        rep_no = _np_from(lib.airr_rep_no(h), n, np.int32, copy=False)
        v_no = _np_from(lib.airr_v_no(h), n, np.int32, copy=False)
        j_no = _np_from(lib.airr_j_no(h), n, np.int32, copy=False)
        row_hash = (
            _np_from(lib.airr_row_hash(h), n, np.uint64, copy=False)
            if hasattr(lib, "airr_row_hash")
            else None
        )
        has_sid = _np_from(lib.airr_has_sequence_id(h), n, np.uint8,
                           copy=False)

        def offsets_of(get64, get32):
            p64 = get64(h)
            if p64:
                return _np_from(p64, n + 1, np.int64, copy=False)
            return _np_from(get32(h), n + 1, np.uint32, copy=False)

        sid_off = offsets_of(
            lib.airr_sequence_id_offsets,
            getattr(lib, "airr_sequence_id_offsets32", None),
        )
        sid_blob = _np_from(
            lib.airr_sequence_id_blob(h), int(sid_off[-1]) if n else 0,
            np.uint8, copy=False,
        )
        if self.n_keep:
            keep_off = offsets_of(
                lib.airr_keep_offsets,
                getattr(lib, "airr_keep_offsets32", None),
            )
            keep_blob = _np_from(
                lib.airr_keep_blob(h), int(keep_off[-1]) if n else 0,
                np.uint8, copy=False,
            )
            keep_missing = _np_from(
                lib.airr_keep_missing(h), self.n_keep, np.uint8
            )
        else:
            keep_off, keep_blob, keep_missing = None, b"", np.zeros(0)
        reps = [
            lib.airr_rep_name(h, i).decode("latin-1")
            for i in range(lib.airr_rep_count(h))
        ]
        return dict(
            _keepalive=self,
            row_hash=row_hash,
            n=int(n),
            residues=residues,
            packed_lmax=packed_lmax,
            lengths=lengths,
            counts=counts,
            rep_no=rep_no,
            v_no=v_no,
            j_no=j_no,
            has_sid=has_sid,
            sid_off=sid_off,
            sid_blob=sid_blob,
            keep_off=keep_off,
            keep_blob=keep_blob,
            keep_missing=keep_missing,
            repertoires=reps,
            ignored_unknown=int(lib.airr_ignored_unknown(h)),
            ignored_empty=int(lib.airr_ignored_empty(h)),
            total_dup=int(lib.airr_total_dup(h)),
            shortest=int(lib.airr_shortest(h)),
            longest=int(lib.airr_longest(h)),
        )

    def gene_names(self):
        lib = self.lib
        s = self.session.handle
        v = [
            lib.airr_v_name(s, i).decode("latin-1")
            for i in range(lib.airr_v_count(s))
        ]
        j = [
            lib.airr_j_name(s, i).decode("latin-1")
            for i in range(lib.airr_j_count(s))
        ]
        return v, j


def pack_rows_native(flat, lens, lmax: int, pad: int):
    """Ragged-to-padded packing via native/pack_group.cpp.
    Returns the packed [n, lmax] int8 array, or None when the native
    library is unavailable (io/airr.py falls back to numpy)."""
    if os.environ.get("COMPAIRR_NATIVE_IO") == "0":
        return None
    lib = load_library()
    if lib is None or not hasattr(lib, "pack_rows"):
        return None
    flat = np.ascontiguousarray(flat, dtype=np.int8)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    n = len(lens)
    out = np.empty((n, lmax), dtype=np.int8)
    lib.pack_rows(
        flat.ctypes.data_as(ct.POINTER(ct.c_int8)),
        lens.ctypes.data_as(ct.POINTER(ct.c_int32)),
        n,
        lmax,
        pad,
        out.ctypes.data_as(ct.POINTER(ct.c_int8)),
    )
    return out


class group_progress_poll:
    """Interactive progress for the native grouping passes: ctypes
    releases the GIL for the blocking C call, so a daemon thread polls
    the library's atomic row counter (~20 Hz — a couple hundred
    redraws for a multi-second Keck grouping, the reference's
    granularity, CompAIRR src/util.cc:28) and forwards it to
    `progress` (typically logger.progress_update). A no-op when
    `progress` is None or the library lacks the counter."""

    def __init__(self, lib, progress):
        self.lib = lib
        self.progress = (
            progress
            if progress is not None
            and lib is not None
            and hasattr(lib, "group_progress")
            else None
        )
        self._stop = None
        self._thread = None

    def __enter__(self):
        if self.progress is None:
            return self
        import threading

        self.lib.group_progress_reset()
        self._stop = threading.Event()

        def _poll():
            while not self._stop.wait(0.05):
                self.progress(int(self.lib.group_progress()))

        self._thread = threading.Thread(target=_poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
        return False


def group_rows_native(seqs, meta, prehash=None, progress=None):
    """Exact-duplicate grouping (first-occurrence numbering) via the
    native open-addressing table. seqs is [n, row_bytes] int8, meta
    [n, m] int32 (may have m == 0); prehash optionally carries the
    parser's per-row content hashes. `progress` (rows-done callback)
    drives interactive redraws during the GIL-released call. Returns
    (group_ids, n_groups) or None when the native library is
    unavailable."""
    if os.environ.get("COMPAIRR_NATIVE_IO") == "0":
        return None
    lib = load_library()
    if lib is None or not hasattr(lib, "group_rows_pre"):
        return None
    seqs = np.ascontiguousarray(seqs, dtype=np.int8)
    meta = np.ascontiguousarray(meta, dtype=np.int32)
    n = seqs.shape[0]
    out = np.empty(n, dtype=np.int64)
    m = 0 if meta.size == 0 else meta.shape[1]
    mp = (
        meta.ctypes.data_as(ct.POINTER(ct.c_int32))
        if m
        else ct.cast(None, ct.POINTER(ct.c_int32))
    )
    if prehash is not None:
        prehash = np.ascontiguousarray(prehash, dtype=np.uint64)
        hp = prehash.ctypes.data_as(ct.POINTER(ct.c_uint64))
    else:
        hp = ct.cast(None, ct.POINTER(ct.c_uint64))
    threads = _grouping_threads()
    with group_progress_poll(lib, progress):
        if threads > 1 and hasattr(lib, "group_rows_pre_mt"):
            ng = lib.group_rows_pre_mt(
                seqs.ctypes.data_as(ct.POINTER(ct.c_int8)),
                n,
                seqs.shape[1],
                mp,
                m,
                hp,
                threads,
                out.ctypes.data_as(ct.POINTER(ct.c_int64)),
            )
        else:
            ng = lib.group_rows_pre(
                seqs.ctypes.data_as(ct.POINTER(ct.c_int8)),
                n,
                seqs.shape[1],
                mp,
                m,
                hp,
                out.ctypes.data_as(ct.POINTER(ct.c_int64)),
            )
    if ng < 0:
        return None
    return out, int(ng)


def _grouping_threads() -> int:
    """Worker count for the native grouping passes (-t/--threads)."""
    from ..config import runtime_threads

    return runtime_threads()


VARIANT_JOIN_MAX_PAIRS = 1 << 24


def variant_join_native(small_db, big_db, ignore_genes: bool):
    """Native asymmetric d=1 substitution join (pack_group.cpp
    variant_join): big-set table build (reusing parse-time row hashes)
    + on-the-fly variant probes. Both dbs must already share a padded
    width. Returns (i_small, i_big, big_groups, n_distinct) where
    n_distinct counts distinct (sequence, genes, repertoire) triples
    of the big set (its duplicate warning = n - n_distinct) and the
    pair lists may contain duplicates; or None when unavailable /
    overflown (callers use the numpy union-grouping fallback)."""
    if os.environ.get("COMPAIRR_NATIVE_IO") == "0":
        return None
    lib = load_library()
    if lib is None or not hasattr(lib, "variant_join"):
        return None
    if small_db.seqs.shape[1] != big_db.seqs.shape[1]:
        return None
    row_bytes = small_db.seqs.shape[1]
    if row_bytes == 0:
        return None

    def meta_of(db):
        if ignore_genes:
            return np.zeros((db.n, 0), dtype=np.int32)
        return np.ascontiguousarray(
            np.stack(
                [db.v_no.astype(np.int32), db.j_no.astype(np.int32)],
                axis=1,
            )
        )

    sm = meta_of(small_db)
    bm = meta_of(big_db)
    m = sm.shape[1]
    small_seqs = np.ascontiguousarray(small_db.seqs, dtype=np.int8)
    big_seqs = np.ascontiguousarray(big_db.seqs, dtype=np.int8)
    small_lens = np.ascontiguousarray(small_db.lengths, dtype=np.int32)
    big_lens = np.ascontiguousarray(big_db.lengths, dtype=np.int32)
    prehash = big_db.row_hash
    if prehash is not None:
        prehash = np.ascontiguousarray(prehash, dtype=np.uint64)
        hp = prehash.ctypes.data_as(ct.POINTER(ct.c_uint64))
    else:
        hp = ct.cast(None, ct.POINTER(ct.c_uint64))
    alphabet = 4 if small_db.nucleotides else 20
    big_rep = np.ascontiguousarray(big_db.rep_no, dtype=np.int32)
    groups = np.empty(big_db.n, dtype=np.int64)
    cap = VARIANT_JOIN_MAX_PAIRS
    pairs = np.empty((cap, 2), dtype=np.int64)
    ngroups = ct.c_int64(0)
    ngroupreps = ct.c_int64(0)
    i32p = lambda a: (
        a.ctypes.data_as(ct.POINTER(ct.c_int32))
        if a.size
        else ct.cast(None, ct.POINTER(ct.c_int32))
    )
    n = lib.variant_join(
        small_seqs.ctypes.data_as(ct.POINTER(ct.c_int8)),
        small_db.n,
        i32p(small_lens),
        i32p(sm),
        big_seqs.ctypes.data_as(ct.POINTER(ct.c_int8)),
        big_db.n,
        i32p(big_lens),
        i32p(bm),
        i32p(big_rep),
        hp,
        m,
        row_bytes,
        alphabet,
        groups.ctypes.data_as(ct.POINTER(ct.c_int64)),
        pairs.ctypes.data_as(ct.POINTER(ct.c_int64)),
        cap,
        ct.byref(ngroups),
        ct.byref(ngroupreps),
    )
    if n < 0:
        return None
    return (
        pairs[:n, 0].copy(),
        pairs[:n, 1].copy(),
        groups,
        int(ngroupreps.value),
    )


def write_cluster_native(outfile, db, order, sizes, seeds, nxt) -> bool:
    """Stream cluster output rows through the native writer
    (CompAIRR src/cluster.cc:427-455 semantics). Returns False
    when unavailable — modes/cluster.py falls back to the Python loop."""
    if os.environ.get("COMPAIRR_NATIVE_IO") == "0":
        return False
    lib = load_library()
    if lib is None or not hasattr(lib, "write_cluster_tsv"):
        return False
    from ..core.db import LazyStrList

    sid = db.sequence_ids
    if isinstance(sid, LazyStrList):
        sid_blob = sid._blob
        sid_off = np.ascontiguousarray(sid._off, dtype=np.int64)
        has = sid._has
        has_sid = (
            np.ascontiguousarray(has, dtype=np.uint8)
            if has is not None
            else None
        )
    else:
        # Python-parser path: materialise a blob (small inputs only
        # reach here in practice)
        parts = [
            (s if s is not None else "").encode("latin-1") for s in sid
        ]
        sid_off = np.zeros(len(parts) + 1, dtype=np.int64)
        np.cumsum([len(p) for p in parts], out=sid_off[1:])
        sid_blob = b"".join(parts)
        has_sid = None
    try:
        outfile.flush()
        fd = outfile.fileno()
    except (AttributeError, OSError, ValueError):
        return False
    from ..constants import AA_CHARS, NT_CHARS

    alphabet = (NT_CHARS if db.nucleotides else AA_CHARS) + "?"
    seqs = np.ascontiguousarray(db.seqs, dtype=np.int8)
    p64 = lambda x: x.ctypes.data_as(ct.POINTER(ct.c_int64))
    p32 = lambda x: x.ctypes.data_as(ct.POINTER(ct.c_int32))
    order = np.ascontiguousarray(order, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    seeds = np.ascontiguousarray(seeds, dtype=np.int64)
    nxt = np.ascontiguousarray(nxt, dtype=np.int64)
    counts = np.ascontiguousarray(db.counts, dtype=np.int64)
    rep_no = np.ascontiguousarray(db.rep_no, dtype=np.int32)
    v_no = np.ascontiguousarray(db.v_no, dtype=np.int32)
    j_no = np.ascontiguousarray(db.j_no, dtype=np.int32)
    lengths = np.ascontiguousarray(db.lengths, dtype=np.int32)
    rc = lib.write_cluster_tsv(
        fd,
        p64(order),
        len(order),
        p64(sizes),
        p64(seeds),
        p64(nxt),
        p32(rep_no),
        p32(v_no),
        p32(j_no),
        p64(counts),
        _label_array(db.repertoire_ids),
        _label_array(db.genes.v_names),
        _label_array(db.genes.j_names),
        seqs.ctypes.data_as(ct.POINTER(ct.c_int8)),
        seqs.shape[1],
        p32(lengths),
        alphabet.encode("ascii"),
        p64(sid_off),
        (
            sid_blob.ctypes.data_as(ct.POINTER(ct.c_uint8))
            if isinstance(sid_blob, np.ndarray)
            else ct.cast(ct.c_char_p(sid_blob), ct.POINTER(ct.c_uint8))
        ),
        (
            has_sid.ctypes.data_as(ct.POINTER(ct.c_uint8))
            if has_sid is not None
            else ct.cast(None, ct.POINTER(ct.c_uint8))
        ),
    )
    return rc == 0


def pack5_rows_native(seqs, n_rows_out: int, lpad: int, nw: int,
                      pad: int):
    """5-bit residue packing (host half of the device upload) via
    native/pack_group.cpp. seqs is the [n, w] int8 database; the
    result is [n_rows_out, nw] int32 with all-pad sentinel rows past
    n. Returns None when the native library is unavailable."""
    if os.environ.get("COMPAIRR_NATIVE_IO") == "0":
        return None
    lib = load_library()
    if lib is None or not hasattr(lib, "pack5_rows") or nw > 64:
        return None
    seqs = np.ascontiguousarray(seqs, dtype=np.int8)
    n, w = seqs.shape
    out = np.empty((n_rows_out, nw), dtype=np.int32)
    lib.pack5_rows(
        seqs.ctypes.data_as(ct.POINTER(ct.c_int8)),
        n,
        w,
        n_rows_out,
        lpad,
        nw,
        pad,
        out.ctypes.data_as(ct.POINTER(ct.c_int32)),
    )
    return out


def pack_keys_native(v_no, j_no, lengths, nj: int, by_vjl: bool):
    """Stable (v,j,length)-bucket sort order + sorted real keys via
    the native counting sort (pack_group.cpp pack_keys_vjl) — replaces
    numpy's key-build temporaries + radix argsort on the device-path
    critical wall. Returns (order int32[n], keys int64[n]) or None
    (missing library, COMPAIRR_NATIVE_IO=0, or out-of-range vj/len —
    callers keep the numpy path)."""
    if os.environ.get("COMPAIRR_NATIVE_IO") == "0":
        return None
    lib = load_library()
    if lib is None or not hasattr(lib, "pack_keys_vjl"):
        return None
    v = np.ascontiguousarray(v_no, dtype=np.int32)
    j = np.ascontiguousarray(j_no, dtype=np.int32)
    ln = np.ascontiguousarray(lengths, dtype=np.int32)
    n = len(ln)
    order = np.empty(n, dtype=np.int32)
    keys = np.empty(n, dtype=np.int64)
    rc = lib.pack_keys_vjl(
        v.ctypes.data_as(ct.POINTER(ct.c_int32)),
        j.ctypes.data_as(ct.POINTER(ct.c_int32)),
        ln.ctypes.data_as(ct.POINTER(ct.c_int32)),
        ct.c_int64(n),
        ct.c_int64(nj),
        ct.c_int(1 if by_vjl else 0),
        order.ctypes.data_as(ct.POINTER(ct.c_int32)),
        keys.ctypes.data_as(ct.POINTER(ct.c_int64)),
    )
    if rc != 0:
        return None
    return order, keys


def group_pieces_native(seqs, lengths, meta, piece: int, pieces: int,
                        progress=None):
    """Fused pigeonhole piece grouping (native/pack_group.cpp
    group_pieces): groups rows by their p-th length-proportional piece
    plus meta, reading the piece ranges in place. meta must include
    the length column. `progress` (rows-done callback) drives
    interactive redraws. Returns (group_ids, n_groups) or None."""
    if os.environ.get("COMPAIRR_NATIVE_IO") == "0":
        return None
    lib = load_library()
    if lib is None or not hasattr(lib, "group_pieces"):
        return None
    seqs = np.ascontiguousarray(seqs, dtype=np.int8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    meta = np.ascontiguousarray(meta, dtype=np.int32)
    n = seqs.shape[0]
    m = meta.shape[1]
    if m < 1:
        return None
    out = np.empty(n, dtype=np.int64)
    threads = _grouping_threads()
    with group_progress_poll(lib, progress):
        ng = _group_pieces_call(
            lib, seqs, lengths, meta, n, m, piece, pieces, threads, out
        )
    if ng < 0:
        return None
    return out, int(ng)


def _group_pieces_call(lib, seqs, lengths, meta, n, m, piece, pieces,
                       threads, out):
    if threads > 1 and hasattr(lib, "group_pieces_mt"):
        ng = lib.group_pieces_mt(
            seqs.ctypes.data_as(ct.POINTER(ct.c_int8)),
            n,
            seqs.shape[1],
            lengths.ctypes.data_as(ct.POINTER(ct.c_int32)),
            meta.ctypes.data_as(ct.POINTER(ct.c_int32)),
            m,
            piece,
            pieces,
            threads,
            out.ctypes.data_as(ct.POINTER(ct.c_int64)),
        )
    else:
        ng = lib.group_pieces(
            seqs.ctypes.data_as(ct.POINTER(ct.c_int8)),
            n,
            seqs.shape[1],
            lengths.ctypes.data_as(ct.POINTER(ct.c_int32)),
            meta.ctypes.data_as(ct.POINTER(ct.c_int32)),
            m,
            piece,
            pieces,
            out.ctypes.data_as(ct.POINTER(ct.c_int64)),
        )
    return ng
