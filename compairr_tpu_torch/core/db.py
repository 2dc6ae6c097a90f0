"""Sequence database: the in-memory, tensor-oriented dataset model.

The reference stores sequences packed end-to-end in a byte arena with a
per-sequence struct (seqinfo_s, CompAIRR src/db.cc:77-88). For a
device engine we instead keep fixed-width numpy tensors, ready to be
placed on device:

  seqs     int8  [N, Lmax]  residues encoded 0..A-1, padded with PAD
  lengths  int32 [N]
  counts   int64 [N]        duplicate_count
  rep_no   int32 [N]        repertoire index (per-db interning)
  v_no     int32 [N]        V gene index (interning shared across dbs,
  j_no     int32 [N]        like db.cc:121-125)

PAD is encoded as alphabet_size so a (A+1)-channel one-hot makes padding
match padding, which keeps the Hamming kernel a single dense matmul.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..constants import DECODE_AA, DECODE_NT


class LazyStrList:
    """Decode-on-demand view over a blob+offsets string table.

    Behaves like list[Optional[str]] for indexing. read_db returns
    millions of sequence_id/keep strings that most modes never touch
    (dedup/cluster/matrix output uses none or a handful); decoding them
    eagerly costs seconds at Keck scale.
    """

    __slots__ = ("_blob", "_off", "_has")

    def __init__(self, blob, off, has=None):
        self._blob = blob
        self._off = off
        self._has = has

    def __len__(self) -> int:
        return len(self._off) - 1

    def __getitem__(self, i):
        if self._has is not None and not self._has[i]:
            return None
        return bytes(
            self._blob[self._off[i]:self._off[i + 1]]
        ).decode("latin-1")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other):
        if isinstance(other, (list, tuple, LazyStrList)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other)
            )
        return NotImplemented


class GeneTables:
    """V/J gene interning shared by both input sets (db.cc:119-125)."""

    def __init__(self):
        self.v_names: list[str] = []
        self.v_map: dict[str, int] = {}
        self.j_names: list[str] = []
        self.j_map: dict[str, int] = {}

    def intern_v(self, name: str) -> int:
        no = self.v_map.get(name)
        if no is None:
            no = len(self.v_names)
            self.v_names.append(name)
            self.v_map[name] = no
        return no

    def intern_j(self, name: str) -> int:
        no = self.j_map.get(name)
        if no is None:
            no = len(self.j_names)
            self.j_names.append(name)
            self.j_map[name] = no
        return no


@dataclass
class SeqDB:
    nucleotides: bool
    seqs: np.ndarray  # int8 [N, Lmax] padded with PAD = alphabet_size
    lengths: np.ndarray  # int32 [N]
    counts: np.ndarray  # int64 [N]
    rep_no: np.ndarray  # int32 [N]
    v_no: np.ndarray  # int32 [N]
    j_no: np.ndarray  # int32 [N]
    sequence_ids: list[Optional[str]]
    keep: list[Optional[str]]
    repertoire_ids: list[str]
    genes: GeneTables
    ignored_unknown: int = 0
    ignored_empty: int = 0
    residues_count: int = 0
    total_dup_count: int = 0
    shortest: int = 0
    longest: int = 0
    # pins the native parse result while tensor fields are zero-copy
    # views into its arenas
    native_keepalive: Optional[object] = None
    # per-row content hash computed during the native parse (FNV-1a
    # over encoded residues); full-sequence groupings reuse it
    row_hash: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return int(self.seqs.shape[0])

    @property
    def repertoire_count(self) -> int:
        return len(self.repertoire_ids)

    def sequence_str(self, i: int) -> str:
        """Decode sequence i back to text (db.cc:1035-1049)."""
        table = DECODE_NT if self.nucleotides else DECODE_AA
        codes = self.seqs[i, : self.lengths[i]].astype(np.int64)
        return table[codes].tobytes().decode("ascii")

    def sequence_id_str(self, i: int) -> str:
        sid = self.sequence_ids[i]
        return sid if sid is not None else ""

    def keep_str(self, i: int) -> str:
        k = self.keep[i]
        return k if k is not None else ""

    def v_name(self, i: int) -> str:
        return self.genes.v_names[self.v_no[i]]

    def j_name(self, i: int) -> str:
        return self.genes.j_names[self.j_no[i]]

    def drop_row_hash(self) -> None:
        """Release the parse-time row hashes (192 MB at Keck scale):
        callers that know no remaining path reads them (approximate
        matching never does) discard the numpy view and then free the
        native arena behind it."""
        self.row_hash = None
        keep = self.native_keepalive
        if keep is not None and hasattr(keep, "drop_row_hash"):
            keep.drop_row_hash()

    def repad(self, lmax: int) -> None:
        """Grow the padded width to lmax (pad value = stored pad)."""
        n, cur = self.seqs.shape
        if cur >= lmax:
            return
        pad_val = self.pad_value
        grown = np.full((n, lmax), pad_val, dtype=np.int8)
        grown[:, :cur] = self.seqs
        self.seqs = grown

    @property
    def pad_value(self) -> int:
        return 4 if self.nucleotides else 20

    def repertoire_order(self) -> np.ndarray:
        """Repertoire indices sorted by id, bytewise like strcmp
        (overlap.cc:130-142)."""
        ids = [rid.encode() for rid in self.repertoire_ids]
        return np.array(
            sorted(range(len(ids)), key=lambda s: ids[s]), dtype=np.int32
        )


_ARRAY_FIELDS = {
    "seqs": np.int8,
    "lengths": np.int32,
    "counts": np.int64,
    "rep_no": np.int32,
    "v_no": np.int32,
    "j_no": np.int32,
}
_INT_FIELDS = (
    "ignored_unknown", "ignored_empty", "residues_count",
    "total_dup_count", "shortest", "longest",
)


def seqdb_from_arrays(obj, genes: Optional[GeneTables] = None) -> SeqDB:
    """This package's SeqDB from any object or dict carrying a SeqDB's
    fields (another implementation's SeqDB, a saved dict): the state
    carried across from a database read elsewhere. The numpy fields
    are copied, so the result owns its memory. `genes` shares one
    GeneTables between the two sets of a run (as read_db does); by
    default the source's gene names are interned anew, in order."""
    get = obj.get if isinstance(obj, dict) else (
        lambda k, d=None: getattr(obj, k, d)
    )
    if genes is None:
        src = get("genes")
        sget = src.get if isinstance(src, dict) else (
            lambda k, d=None: getattr(src, k, d)
        )
        genes = GeneTables()
        for name in sget("v_names", None) or ():
            genes.intern_v(name)
        for name in sget("j_names", None) or ():
            genes.intern_j(name)
    arrays = {
        k: np.array(get(k), dtype=t, copy=True)
        for k, t in _ARRAY_FIELDS.items()
    }
    n = arrays["seqs"].shape[0]
    row_hash = get("row_hash", None)
    return SeqDB(
        nucleotides=bool(get("nucleotides")),
        sequence_ids=list(get("sequence_ids", None) or [None] * n),
        keep=list(get("keep", None) or [None] * n),
        repertoire_ids=list(get("repertoire_ids")),
        genes=genes,
        row_hash=None if row_hash is None else np.array(row_hash),
        **arrays,
        **{k: int(get(k, 0)) for k in _INT_FIELDS},
    )


@dataclass
class RepertoireStats:
    """Per-repertoire size/count/sum-of-squares (overlap.cc:633-655)."""

    size: np.ndarray  # int64 [R] number of sequences
    count: np.ndarray  # int64 [R] sum of duplicate counts
    sq_count: np.ndarray  # float64 [R] sum of squared counts


def repertoire_stats(db: SeqDB) -> RepertoireStats:
    r = db.repertoire_count
    size = np.bincount(db.rep_no, minlength=r).astype(np.int64)
    count = np.bincount(db.rep_no, weights=db.counts, minlength=r).astype(
        np.int64
    )
    sq = np.bincount(
        db.rep_no, weights=(db.counts.astype(np.float64) ** 2), minlength=r
    )
    return RepertoireStats(size=size, count=count, sq_count=sq)
