"""Device layouts and the hand-written kernels of the device routes.

Port of the parts of compairr_tpu/ops/pallas_kernels.py that the dense
engine and the sparse tile route run:

  * the device derive (pallas_kernels.py:2049-2493): the parsed int8
    rows go up as they are, and derive_rows (the wrapper of
    csrc/derive_rows.cu, which replaces the XLA device code of the JAX
    package's device_rows_raw and device_args_raw, and its plain
    version derive_rows_plain) gathers them into key-sorted order,
    reverses them within their lengths and builds for every CUDA kernel
    but dense_onehot the residue bit planes (residue_planes: one int32
    word per 32 positions and residue bit); around it, torch ops gather
    the repertoire and count rows (device_args_raw, the dense engine's)
    or derive the original-index rows (device_rows_raw, the tile
    route's). No one-hot rows are derived: the kernels read residues or
    planes.
  * the kernel choice (_dense_kernel_kind, pallas_kernels.py:1424):
    the JAX package's v3 / v2 / v2c / v1 ladder without the TPU's
    memory gates.
  * dense_match: the wrapper of csrc/dense_match.cu, which replaces the
    v3 dense kernel (pallas_kernels.py:970), with its launch counter
    and its plain PyTorch version (dense_match_plain).
  * dense_onehot: the wrapper of csrc/dense_onehot.cu, which replaces
    the v2 dense kernel (pallas_kernels.py:793) with its design, an
    int8 one-hot product on the tensor cores, and its plain version.
  * dense_indel and dense_general: the wrappers of
    csrc/dense_general.cu, which replaces the v2c and v1 dense kernels
    (pallas_kernels.py:1147, :411), with their plain versions.
  * count_tiles and extract_tiles: the wrappers of csrc/tile_match.cu,
    which replaces the count and extract kernels
    (pallas_kernels.py:1513, :1683), with their plain versions.
  * airr_scan, airr_ids, airr_pack and airr_gather: the wrappers of
    csrc/airr_parse.cu, the AIRR TSV tokeniser of io/card.py's card
    route of read_db (it replaces no TPU kernel: the JAX package parses
    on the host), with their plain versions (airr_scan_plain).
  * the nvcc build of csrc/*.cu into build/ and the ctypes loader.

A wrapper takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (
    SCORE_JACCARD,
    SCORE_MAX,
    SCORE_MEAN,
    SCORE_MH,
    SCORE_MIN,
    SCORE_PRODUCT,
    SCORE_RATIO,
)
from ..utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# launches per kernel, counted by each wrapper where it launches its
# kernel and nowhere else (a run reads them to prove its path)
LAUNCHES = {"dense_match": 0, "dense_onehot": 0, "dense_indel": 0,
            "dense_general": 0, "count_tiles": 0, "extract_tiles": 0,
            "derive_rows": 0, "airr_lines": 0, "airr_rows": 0,
            "airr_verify": 0, "airr_compact": 0, "airr_ids": 0,
            "airr_pack": 0, "airr_gather": 0}
_LAUNCHES_LOCK = threading.Lock()  # a prefetch worker launches too


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count_launch(name: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


# --------------------------------------------------------------------
# device derive
# --------------------------------------------------------------------

_DERIVE_CHUNK = 1 << 21  # rows per reversal step: bounds int64 temporaries


def _canon_src(n: int) -> int:
    """Canonical raw-upload row count (see engine.canon_rows)."""
    from .engine import canon_rows

    return canon_rows(n, 1024)


def _shrink(x: np.ndarray, sentinel: int, m: int) -> np.ndarray:
    """Pad to m with sentinels and downcast to int16 when the values
    fit, halving the per-sequence scalar upload."""
    out = np.full(m, sentinel, dtype=np.int64)
    out[: len(x)] = x
    if out.min() >= -32768 and out.max() < 32768:
        return out.astype(np.int16)
    return out.astype(np.int32)


PLANE_BITS = 32  # residue positions per plane word (one chunk)
_PLANE_DERIVE_ELEMS = 1 << 24  # int32 bit temporaries per derive step
_SIGN_BIT = -(1 << 31)  # bit 31 of an int32 word


def plane_chunks(lpad: int) -> int:
    """C, the 32-position chunks of a residue row of width lpad."""
    return -(-lpad // PLANE_BITS)


def residue_planes(seqs: torch.Tensor, n_planes: int) -> torch.Tensor:
    """[npad, lpad] int8 residues -> int32 [npad, C, P] bit planes, on
    seqs' device (C = plane_chunks(lpad), P = n_planes): bit p of word
    [row, c, q] is bit q of the residue at position 32 c + p. Positions
    past lpad are 0. Every residue code is at most the pad code, so
    P = pad_value.bit_length() planes hold all of them (5 for amino
    acids, 3 for nucleotides), and two rows differ at a position exactly
    where some plane differs: popc(OR_q (A_q ^ B_q)) summed over the
    chunks is their Hamming distance. Bits 0 to 30 of a word are summed
    in int32 (below 2^31 in any order) and bit 31 is ORed in as the sign
    bit; the bits come from the int8 residues, and rows go in chunks,
    bounding the int32 temporaries at scale."""
    npad, lpad = seqs.shape
    c = plane_chunks(lpad)
    dev = seqs.device
    out = torch.empty((npad, c, n_planes), dtype=torch.int32, device=dev)
    q = torch.arange(n_planes, dtype=torch.int8, device=dev).view(
        1, 1, n_planes, 1)
    weight = 2 ** torch.arange(PLANE_BITS - 1, dtype=torch.int32, device=dev)
    step = max(1, _PLANE_DERIVE_ELEMS // (c * n_planes * PLANE_BITS))
    for s in range(0, npad, step):
        x = torch.nn.functional.pad(seqs[s : s + step],
                                    (0, c * PLANE_BITS - lpad))
        bits = (x.view(len(x), c, 1, PLANE_BITS) >> q) & 1
        low = (bits[..., :-1] * weight).sum(-1, dtype=torch.int32)
        out[s : s + len(x)] = torch.where(bits[..., -1] != 0,
                                          low | _SIGN_BIT, low)
    return out


def _reversed_rows(seqs: torch.Tensor, lengths: torch.Tensor,
                   pad_val: int) -> torch.Tensor:
    """Each row reversed within its length, pad residues after it
    (pallas_kernels._seqs_chunk), in row chunks of _DERIVE_CHUNK."""
    npad, lpad = seqs.shape
    pos = torch.arange(lpad, device=seqs.device)[None, :]
    out = torch.empty_like(seqs)
    for s in range(0, npad, _DERIVE_CHUNK):
        ln = lengths[s : s + _DERIVE_CHUNK, None]
        idx = (ln - 1 - pos).clamp(0, lpad - 1)
        rev = seqs[s : s + len(ln)].gather(1, idx)
        out[s : s + len(ln)] = torch.where(
            pos < ln, rev, torch.full_like(rev, pad_val)
        )
    return out


def _check_derive(rows: torch.Tensor, order: torch.Tensor,
                  key: torch.Tensor, lpad: int, pad_val: int) -> None:
    dev = rows.device
    if order.device != dev or key.device != dev:
        raise ValueError("derive_rows: rows, order and key must share a "
                         "device")
    if rows.dtype != torch.int8 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError("derive_rows: rows must be contiguous int8 [n, w]")
    if (order.dtype != torch.int64 or order.dim() != 1
            or not order.is_contiguous()):
        raise ValueError("derive_rows: order must be a contiguous int64 row")
    if (key.dtype not in (torch.int32, torch.int64)
            or key.shape != order.shape or not key.is_contiguous()):
        raise ValueError("derive_rows: key must be a contiguous int32 or "
                         "int64 row as long as order")
    if lpad < 0 or not 0 <= pad_val < 128:
        raise ValueError(f"derive_rows: lpad {lpad} and pad {pad_val} "
                         "must be non-negative, the pad an int8 code")


def derive_rows(rows: torch.Tensor, order: torch.Tensor, key: torch.Tensor,
                lpad: int, pad_val: int, *, indels: bool,
                planes: bool) -> dict:
    """The key-sorted rows of a derive, on rows' device: seqs (int8
    [npad, lpad]: row order[i] of rows, int8 [n, w], cut or padded with
    pad_val to lpad columns; all pad where order[i] is outside 0 .. n -
    1, as the sentinel n), with indels rseqs (each row reversed within
    the low 16 bits of key[i], int32 or int64 [npad], clamped to lpad;
    pad after), and with planes their residue_planes, planes and (with
    indels) rplanes, P = pad_val.bit_length(). CUDA tensors launch
    csrc/derive_rows.cu, once; CPU tensors take derive_rows_plain."""
    _check_derive(rows, order, key, lpad, pad_val)
    if rows.device.type == "cpu":
        return derive_rows_plain(rows, order, key, lpad, pad_val,
                                 indels=indels, planes=planes)
    return _derive_rows_cuda(rows, order, key, lpad, pad_val, indels, planes)


def _derive_rows_cuda(rows, order, key, lpad, pad_val, indels,
                      planes) -> dict:
    dev = rows.device
    npad = order.shape[0]
    n_planes = pad_val.bit_length()
    out = {"seqs": torch.empty((npad, lpad), dtype=torch.int8, device=dev)}
    if indels:
        out["rseqs"] = torch.empty_like(out["seqs"])
    if planes:
        out["planes"] = torch.empty((npad, plane_chunks(lpad), n_planes),
                                    dtype=torch.int32, device=dev)
        if indels:
            out["rplanes"] = torch.empty_like(out["planes"])
    lib = load_library("derive_rows")
    ptr = [out[k].data_ptr() if k in out else None
           for k in ("seqs", "rseqs", "planes", "rplanes")]
    with torch.cuda.device(dev):
        err = lib.derive_rows_launch(
            rows.data_ptr(), rows.shape[0], rows.shape[1], order.data_ptr(),
            npad, key.data_ptr(), key.element_size() // 4, lpad, pad_val,
            n_planes, *ptr, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"derive_rows launch failed: CUDA error {err} "
            f"({lib.derive_rows_error_string(err).decode()})")
    _count_launch("derive_rows")
    return out


def derive_rows_plain(rows: torch.Tensor, order: torch.Tensor,
                      key: torch.Tensor, lpad: int, pad_val: int, *,
                      indels: bool, planes: bool) -> dict:
    """derive_rows in plain PyTorch, on any device: rows cut or padded to
    lpad with one all-pad row after them, gathered by index_select, then
    _reversed_rows and residue_planes."""
    n, w = rows.shape
    src = torch.full((n + 1, lpad), pad_val, dtype=torch.int8,
                     device=rows.device)
    src[:n, : min(w, lpad)] = rows[:, :lpad]
    seqs = src.index_select(0, torch.where((order >= 0) & (order < n),
                                           order, n))
    out = {"seqs": seqs}
    if indels:
        out["rseqs"] = _reversed_rows(seqs, (key & 0xFFFF).clamp(0, lpad),
                                      pad_val)
    if planes:
        out["planes"] = residue_planes(seqs, pad_val.bit_length())
        if indels:
            out["rplanes"] = residue_planes(out["rseqs"],
                                            pad_val.bit_length())
    return out


def _sorted_rows(db, order: np.ndarray, npad: int, lpad: int,
                 key: np.ndarray, device, indels: bool, planes: bool):
    """The key-sorted layout both derives share, on `device`: (order,
    key, rows). order is int64 [npad], pack_keys' permutation with the
    all-pad sentinel row n on the pads; key is the caller's host key row
    [npad], uploaded as it is; rows is derive_rows' dict over the SeqDB's
    int8 rows, uploaded as they are: seqs, with indels rseqs (the key's
    low 16 bits the lengths), with planes planes and (with indels)
    rplanes."""
    n = db.n
    order_full = np.full(npad, n, dtype=np.int64)
    order_full[:n] = order
    o = upload(order_full, device)
    k = upload(key, device)
    seqs = upload(np.ascontiguousarray(db.seqs, dtype=np.int8), device)
    return o, k, derive_rows(seqs, o, k, lpad, int(db.pad_value),
                             indels=indels, planes=planes)


def device_args_raw(db, order: np.ndarray, npad: int, lpad: int,
                    sort_key: np.ndarray, device, *, indels: bool = False,
                    wide: bool = False, planes: bool = False) -> dict:
    """Upload a SeqDB's raw arrays (plus one all-pad sentinel row) and
    derive the key-sorted layouts the dense kernels read, on `device`:

      seqs    int8  [npad, lpad] residues, pad rows all pad residue
      rseqs   int8  [npad, lpad] rows reversed within their lengths
                                 (only with indels)
      planes  int32 [npad, C, P] residue_planes of seqs, P =
                                 pad_value.bit_length() (only with
                                 planes: the CUDA kernels' rows)
      rplanes int32 [npad, C, P] residue_planes of rseqs (only with
                                 planes and indels)
      key32   int32 [npad]       bucket key, pads -1   (not wide)
      cnt     int32 [npad]       duplicate count, pads 0 (not wide)
      key64   int64 [npad]       bucket key, pads -1   (wide)
      cnt64   int64 [npad]       duplicate count, pads 0 (wide)
      rep     int32 [npad]       repertoire, pads -1

    `order` is pack_keys' permutation and `sort_key` its sorted padded
    key vector; padding rows gather the sentinel. dense_match and
    dense_indel read the int32 rows: their kernel choice admits keys
    below 2^31 and counts below 2^16 (or ignores them under -f).
    dense_general reads the wide rows, which hold any key and any
    parser-validated integer count. The lengths of the reversal come
    from the key's low 16 bits (clamped to lpad on pads, whose rows
    are all pad)."""
    n = db.n
    m = _canon_src(n + 1)
    if not wide and n and int(sort_key[:n].max()) >= 1 << 31:
        raise ValueError("a bucket key is >= 2^31: the key rows must be wide")
    dtype = np.int64 if wide else np.int32
    cnt = np.zeros(m, dtype=dtype)
    cnt[:n] = np.asarray(db.counts, dtype=np.int64)
    key = np.full(npad, -1, dtype=dtype)
    key[:n] = sort_key[:n]
    o, k, rows = _sorted_rows(db, order, npad, lpad, key, device, indels,
                              planes)
    return {
        **rows,
        "key64" if wide else "key32": k,
        "rep": upload(_shrink(db.rep_no, -1, m), device).index_select(
            0, o).to(torch.int32),
        "cnt64" if wide else "cnt": upload(cnt, device).index_select(0, o),
    }


# the key rows are int32 while every real key of both sets is below
# this, with the salted pad band above them (pallas_kernels._KEY_FUSE_MAX);
# otherwise int64, with the band at _KEY64_BAND
_KEY_FUSE_MAX = 1 << 29
_KEY64_BAND = 1 << 62


def wide_keys(*real_keys: np.ndarray) -> bool:
    """Whether a tile-route run needs int64 key rows: some real key of
    either set is at or above 2^29. One choice for both sets of a run,
    so that the kernels always get two key rows of one type."""
    return any(len(k) and int(k.max()) >= _KEY_FUSE_MAX for k in real_keys)


def device_rows_raw(db, order: np.ndarray, npad: int, lpad: int,
                    indels: bool, sort_key: np.ndarray, pad_salt: int,
                    device, *, wide: bool, planes: bool = False) -> dict:
    """Upload a SeqDB's raw arrays (plus one all-pad sentinel row) and
    derive the key-sorted layouts the tile kernels read, on `device`
    (pallas_kernels.device_rows_raw with _gather_sparse_key_fn and
    _gather_sparse_fn):

      seqs   int8  [npad, lpad]  residues, pad rows all pad residue
      rseqs  int8  [npad, lpad]  rows reversed within their lengths
                                 (None unless indels)
      key    int32 [npad]        bucket key (JAX's key32 row); int64
                                 when wide (wide_keys of both sets)
      orig   int32 [npad]        original row index, pads -1
      planes  int32 [npad, C, P] residue_planes of seqs, P =
                                 pad_value.bit_length() (only with
                                 planes: the tile kernels' rows)
      rplanes int32 [npad, C, P] residue_planes of rseqs (only with
                                 planes and indels)

    Pad keys are unique, 4 apart, in a band above every real key:
    2^29 + 2 + pad_salt + 4i (2^62 + ... for int64 rows). pad_salt is 0
    for set 1 and 2 for set 2, so no pad ever key-matches a row of
    either set or sits at key distance 1 from one; only a pad and its
    own twin in a self-comparison share a key, and exclude_self drops
    that pair through orig. The lengths of the reversal come from the
    key's low 16 bits (garbage on pads, whose rows are all pad)."""
    n = db.n
    if not wide and wide_keys(sort_key[:n]):
        raise ValueError("a bucket key is >= 2^29: the key rows must be wide")
    key = np.empty(npad, dtype=np.int64 if wide else np.int32)
    key[:n] = sort_key[:n]
    key[n:] = (
        (_KEY64_BAND if wide else _KEY_FUSE_MAX) + 2 + pad_salt
        + 4 * np.arange(npad - n, dtype=key.dtype)
    )
    o, k, rows = _sorted_rows(db, order, npad, lpad, key, device, indels,
                              planes)
    return {
        "rseqs": None,
        **rows,
        "key": k,
        "orig": torch.where(o >= n, -1, o).to(torch.int32),
    }


# bytes upload() has copied to a card while tracing is on; engine reads
# it by difference over a phase into that phase's upload_bytes
UPLOAD_BYTES = 0


def upload(x: np.ndarray, device) -> torch.Tensor:
    """The contiguous array x as a tensor on `device`; a copy to a card
    adds its bytes to UPLOAD_BYTES while tracing is on."""
    global UPLOAD_BYTES
    t = torch.from_numpy(x).to(device)
    if trace.ON and t.device.type != "cpu":
        UPLOAD_BYTES += x.nbytes
    return t


def upload_worklist(work: np.ndarray, device) -> torch.Tensor:
    """int32 [T, 2] worklist of element starts on `device`."""
    return upload(
        np.ascontiguousarray(work, dtype=np.int32).reshape(-1, 2), device
    )


# --------------------------------------------------------------------
# kernel choice
# --------------------------------------------------------------------

# the JAX package's gate pallas_kernels._V2_GE_CMAX: the largest integer
# count its min/max threshold chains cover
_V2_GE_CMAX = 64


def _has_chains(score_int: int, ignore_counts: bool, cmax: float) -> bool:
    """Whether the JAX package's score chains (pallas_kernels._v2_chains)
    decompose this score at this largest count: -f, product, MH and
    mean always; min, max and Jaccard for integer counts up to
    _V2_GE_CMAX; ratio never."""
    if ignore_counts or score_int in (SCORE_MH, SCORE_PRODUCT, SCORE_MEAN):
        return True
    if score_int in (SCORE_JACCARD, SCORE_MIN, SCORE_MAX):
        return cmax == int(cmax) and cmax <= _V2_GE_CMAX
    return False


def _dense_kernel_kind(*, indels: bool, score_int: int,
                       ignore_counts: bool, cmax: float,
                       key_max: int) -> str:
    """The kernel a dense run takes, by the JAX package's ladder
    (pallas_kernels._dense_kernel_kind) without its TPU memory gates
    _v3_scratch_ok, _v2_scratch_ok and _oh_fits (these kernels build
    no one-hot rows in device memory, so no one-hot budget exists):

      dense_match    JAX's v3: no indels, keys below 2^31, a score with
                     chains, counts below 2^16 (or -f);
      dense_onehot   JAX's v2: the same runs while COMPAIRR_V3 is "0",
                     the JAX package's own switch, read here at
                     dispatch and tested as it tests it
                     (pallas_kernels.py:1444);
      dense_indel    JAX's v2c: the same with the indel (-d 1 -i);
      dense_general  JAX's v1: every other run (ratio, min/max/Jaccard
                     with a count above 64, counts >= 2^16, keys >=
                     2^31), with or without the indel.

    JAX also takes v2 where v2's chain scratch fits VMEM and v3's DMA
    ring does not; with no memory gate those runs take dense_match
    here. A one-hot budget overflow, which JAX sends to v2c, takes
    dense_match, or dense_onehot under COMPAIRR_V3=0, whose one-hots
    live in shared memory. Indel runs and dense_general's runs keep
    their kernels whatever COMPAIRR_V3 says, as v2 needs no indels."""
    if (
        key_max >= 1 << 31
        or not _has_chains(score_int, ignore_counts, cmax)
        or not (ignore_counts or cmax < 1 << 16)
    ):
        return "dense_general"
    if indels:
        return "dense_indel"
    if os.environ.get("COMPAIRR_V3", "1") == "0":
        return "dense_onehot"
    return "dense_match"


# --------------------------------------------------------------------
# dense_match: kernel wrapper and plain version
# --------------------------------------------------------------------

# per-pair score modes of the dense kernels (ScoreMode in
# csrc/dense_match.cu and csrc/dense_general.cu); ratio only in
# dense_general's float64 sums
SC_ONE, SC_PRODUCT, SC_MIN, SC_MAX, SC_SUM, SC_RATIO = 0, 1, 2, 3, 4, 5


def score_mode(score_int: int, ignore_counts: bool) -> int:
    """Kernel score mode for a CompAIRR score (compute_score,
    CompAIRR src/overlap.cc:144-166): mean sums cnt_a + cnt_b and the
    caller halves the matrix once."""
    if ignore_counts:
        return SC_ONE
    return {
        SCORE_MH: SC_PRODUCT,
        SCORE_PRODUCT: SC_PRODUCT,
        SCORE_JACCARD: SC_MIN,
        SCORE_MIN: SC_MIN,
        SCORE_MAX: SC_MAX,
        SCORE_MEAN: SC_SUM,
        SCORE_RATIO: SC_RATIO,
    }[score_int]


def _pair_score(mode: int, ca: torch.Tensor, cb: torch.Tensor):
    """Per-pair scores of two count vectors of one dtype (int64, or
    float64 for dense_general's float64 sums)."""
    if mode == SC_PRODUCT:
        return ca * cb
    if mode == SC_MIN:
        return torch.minimum(ca, cb)
    if mode == SC_MAX:
        return torch.maximum(ca, cb)
    if mode == SC_SUM:
        return ca + cb
    if mode == SC_RATIO:
        return ca / torch.where(cb == 0, torch.ones_like(cb), cb)
    return torch.ones_like(ca)


def dense_match_plain(a: dict, b: dict, work: torch.Tensor, *,
                      differences: int, score_mode: int, tile_m: int,
                      tile_n: int, r1p: int, r2p: int) -> torch.Tensor:
    """Plain PyTorch version of the dense_match kernel: _dense_join_plain
    on the int32 key and count rows, without the indel test."""
    return _dense_join_plain(
        a, b, work, key="key32", cnt="cnt", indels=False,
        differences=differences, score_mode=score_mode,
        out_dtype=torch.int64, tile_m=tile_m, tile_n=tile_n, r1p=r1p,
        r2p=r2p,
    )


def _npad(side: dict) -> int:
    """The rows of a side: its residue rows', or (a dense side whose
    residue rows were dropped) its repertoire row's."""
    return side["seqs" if "seqs" in side else "rep"].shape[0]


def _check_side(side: dict, name: str, dev: torch.device,
                wide: bool = False, indels: bool = False,
                byte_rows: bool = True) -> None:
    """A dense kernel's rows of one side (device_args_raw's): contiguous
    int8 residues (and reversed residues with indels), and [npad] rows
    rep int32 and key32/cnt int32, or key64/cnt64 int64 when wide, all
    on dev. byte_rows=False (a CUDA kernel that reads planes, whose
    caller may have dropped the int8 rows) lets the residue rows be
    absent; they are checked where present."""
    npad = _npad(side)
    rows = []
    seqs = side.get("seqs")
    if byte_rows or seqs is not None:
        if seqs is None or seqs.dtype != torch.int8 or seqs.dim() != 2 or not seqs.is_contiguous():
            raise ValueError(f"{name}['seqs'] must be a contiguous int8 [npad, lpad] tensor")
        rows.append(("seqs", seqs))
    if indels and (byte_rows or side.get("rseqs") is not None):
        r = side.get("rseqs")
        if r is None or seqs is None or r.dtype != torch.int8 or r.shape != seqs.shape or not r.is_contiguous():
            raise ValueError(f"{name}['rseqs'] must be a contiguous int8 tensor shaped as seqs on indel runs")
        rows.append(("rseqs", r))
    key, cnt, wtype = (("key64", "cnt64", torch.int64) if wide
                       else ("key32", "cnt", torch.int32))
    for k, dtype in ((key, wtype), ("rep", torch.int32), (cnt, wtype)):
        x = side[k]
        if x.dtype != dtype or x.shape != (npad,) or not x.is_contiguous():
            raise ValueError(f"{name}[{k!r}] must be a contiguous {dtype} [npad] tensor")
        rows.append((k, x))
    for k, x in rows:
        if x.device != dev:
            raise ValueError(f"{name}[{k!r}] is on {x.device}, expected {dev}")
        if dev.type == "cuda" and x.data_ptr() % 16:
            raise ValueError(f"{name}[{k!r}] is not 16-byte aligned")


def _check_work(work: torch.Tensor, dev: torch.device) -> None:
    if (
        work.dtype != torch.int32
        or work.dim() != 2
        or work.shape[1] != 2
        or not work.is_contiguous()
        or work.device != dev
    ):
        raise ValueError(f"work must be a contiguous int32 [T, 2] tensor on {dev}")


def _assert_reps(a: dict, b: dict, r1p: int, r2p: int, name: str) -> None:
    """Every repertoire index must address a cell of the output. Checked
    on the device without a host sync: on the CPU a failure raises
    here; on CUDA it is a device-side assert that stops the stream
    before the kernel can write out of bounds, as PyTorch's own
    indexing ops do."""
    for side, rows in ((a, r1p), (b, r2p)):
        if side["rep"].numel():
            torch._assert_async(
                side["rep"].max() < rows,
                f"{name}: a repertoire index is >= {rows}, outside "
                f"the [{r1p}, {r2p}] matrix",
            )


def _check_smem(name: str, smem: int, shape: str) -> None:
    if smem > 232448:
        raise ValueError(
            f"{name} {shape} needs {smem} bytes of shared memory a "
            "block, over the card's 232448"
        )


def _check_planes(side: dict, name: str, dev: torch.device,
                  key: str = "planes") -> None:
    """A side's residue planes (residue_planes of its seqs; rplanes, of
    its rseqs): contiguous int32 [npad, C, P] with 1 <= P <= 5 and C =
    plane_chunks(lpad) of its residue rows (any C >= 1 on a dense side
    whose residue rows were dropped), on dev, 16-byte aligned on the
    card."""
    pl, npad = side.get(key), _npad(side)
    seqs = side.get("seqs")
    chunks = plane_chunks(seqs.shape[1]) if seqs is not None else None
    if (
        pl is None
        or pl.dtype != torch.int32
        or pl.dim() != 3
        or pl.shape[0] != npad
        or (pl.shape[1] != chunks if chunks else pl.shape[1] < 1)
        or not 1 <= pl.shape[2] <= 5
        or not pl.is_contiguous()
    ):
        raise ValueError(
            f"{name}[{key!r}] must be a contiguous int32 [{npad}, "
            f"{chunks or 'C'}, P] tensor with 1 <= P <= 5 "
            "(residue_planes of the rows)"
        )
    if pl.device != dev:
        raise ValueError(f"{name}[{key!r}] is on {pl.device}, expected {dev}")
    if dev.type == "cuda" and pl.data_ptr() % 16:
        raise ValueError(f"{name}[{key!r}] is not 16-byte aligned")


def _check_plane_pair(a: dict, b: dict, dev: torch.device,
                      indels: bool) -> None:
    """Both sides' planes (_check_planes), and with indels the reversed
    rows' planes shaped as the planes; one C and one P for both sides."""
    keys = ("planes", "rplanes") if indels else ("planes",)
    for side, name in ((a, "a"), (b, "b")):
        for key in keys:
            if side.get(key) is None:
                raise ValueError(
                    f"{name}[{key!r}] must be given: the kernel reads "
                    "residue planes (device_args_raw or device_rows_raw "
                    "with planes)")
    for side, name in ((a, "a"), (b, "b")):
        for key in keys:
            _check_planes(side, name, dev, key)
        if indels and side["rplanes"].shape != side["planes"].shape:
            raise ValueError(
                f"{name}['rplanes'] must be shaped as {name}['planes']")
    if a["planes"].shape[1:] != b["planes"].shape[1:]:
        raise ValueError("a and b residue planes differ in number or "
                         "chunks")


def dense_match(a: dict, b: dict, work: torch.Tensor, *, differences: int,
                score_mode: int, tile_m: int, tile_n: int, r1p: int,
                r2p: int) -> torch.Tensor:
    """int64 [r1p, r2p] matrix: sum of the score over every pair of
    every worklist tile with equal keys, rep >= 0 on both sides and at
    most `differences` differing residues. a/b are device_args_raw
    dicts, whose rows are key-sorted with pads (key -1) last: the
    kernel splits each tile into its equal-key runs, so it needs that
    order; the plain version does not. The kernel reads the residue
    planes (device_args_raw with planes), which the CUDA path requires
    and the plain version ignores (they are checked where present).
    work is int32 [T, 2] element starts of tiles inside both row sets,
    on the same device. CUDA tensors launch csrc/dense_match.cu; CPU
    tensors take dense_match_plain."""
    dev = a["seqs"].device
    _check_side(a, "a", dev)
    _check_side(b, "b", dev)
    lpad = a["seqs"].shape[1]
    if b["seqs"].shape[1] != lpad:
        raise ValueError("a and b residue rows differ in width")
    if dev.type == "cuda" or "planes" in a or "planes" in b:
        _check_plane_pair(a, b, dev, False)
    _check_work(work, dev)
    if tile_m <= 0 or tile_n <= 0:
        raise ValueError(f"tiles must be positive, got {tile_m}x{tile_n}")
    if score_mode == SC_RATIO:
        raise ValueError("dense_match sums integers: no ratio score")
    _assert_tiles_inside(a, b, work, tile_m, tile_n, "dense_match")
    _assert_reps(a, b, r1p, r2p, "dense_match")
    kw = dict(differences=differences, score_mode=score_mode,
              tile_m=tile_m, tile_n=tile_n, r1p=r1p, r2p=r2p)
    if dev.type == "cpu":
        return dense_match_plain(a, b, work, **kw)
    if dev.type != "cuda":
        raise ValueError(f"dense_match runs on cuda or cpu tensors, not {dev}")
    n_chunks, n_planes = a["planes"].shape[1:]
    lib = load_library("dense_match")
    _check_smem("dense_match",
                lib.dense_match_smem_bytes(tile_m, tile_n, n_chunks,
                                           n_planes),
                f"tile_n={tile_n}, lpad={lpad}")
    out = torch.zeros((r1p, r2p), dtype=torch.int64, device=dev)
    n_tiles = work.shape[0]
    if n_tiles == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.dense_match_launch(
            a["planes"].data_ptr(), a["key32"].data_ptr(),
            a["rep"].data_ptr(), a["cnt"].data_ptr(),
            b["planes"].data_ptr(), b["key32"].data_ptr(),
            b["rep"].data_ptr(), b["cnt"].data_ptr(),
            work.data_ptr(), n_tiles,
            a["seqs"].shape[0], b["seqs"].shape[0], tile_m, tile_n,
            n_chunks, n_planes, differences, score_mode, r2p,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"dense_match launch failed: CUDA error {err} "
            f"({lib.dense_match_error_string(err).decode()})"
        )
    _count_launch("dense_match")
    return out


# --------------------------------------------------------------------
# dense_onehot: kernel wrapper and plain version
# --------------------------------------------------------------------

# residue classes of the one-hot rows: aa 0..19 / nt 0..3 and the pad
# code (20 / 4), as pallas_kernels.NCLASS
ONEHOT_CLASSES = 21
_ONEHOT_TILE = 64  # csrc/dense_onehot.cu's row slice: tiles are multiples


def onehot_width(lpad: int) -> int:
    """K, the lanes of a one-hot row: ONEHOT_CLASSES * lpad rounded up to
    a multiple of 32 (the depth of one int8 tensor-core step)."""
    return -(-ONEHOT_CLASSES * lpad // 32) * 32


def onehot_rows(seqs: torch.Tensor) -> torch.Tensor:
    """[rows, lpad] int8 residues -> [rows, onehot_width(lpad)] int8
    one-hot rows: feature (class c, position p) at lane c * lpad + p,
    zero lanes past ONEHOT_CLASSES * lpad
    (pallas_kernels._onehot_rows_chunk's layout)."""
    rows, lpad = seqs.shape
    cls = torch.arange(ONEHOT_CLASSES, dtype=seqs.dtype, device=seqs.device)
    oh = (seqs[:, None, :] == cls[None, :, None]).to(torch.int8)
    oh = oh.reshape(rows, ONEHOT_CLASSES * lpad)
    return torch.nn.functional.pad(
        oh, (0, onehot_width(lpad) - ONEHOT_CLASSES * lpad)
    )


def dense_onehot_plain(a: dict, b: dict, work: torch.Tensor, *,
                       differences: int, score_mode: int, tile_m: int,
                       tile_n: int, r1p: int, r2p: int) -> torch.Tensor:
    """Plain PyTorch version of the dense_onehot kernel: its one-hot
    formulation step by step, a few tiles a step. The one-hot rows of
    the tiles' a and b rows; their product, the position matches of
    every pair; the mask (equal int32 keys, rep >= 0 on both sides,
    lpad - matches <= differences); the pair scores scattered into
    int64 cells. The products run in int64 on the CPU. On the card,
    where torch has no int64 matmul, they run in float32 with TF32 off
    (allow_tf32 False, full float32 precision, set here for the call),
    which is exact: every entry is at most lpad < 2^24."""
    dev = a["seqs"].device
    lpad = a["seqs"].shape[1]
    kdim = onehot_width(lpad)
    prod = torch.int64 if dev.type == "cpu" else torch.float32
    out = torch.zeros(r1p * r2p, dtype=torch.int64, device=dev)
    step = max(1, _PLAIN_ELEMS // (tile_m * tile_n + (tile_m + tile_n) * kdim))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(0, len(work), step):
            w = work[s : s + step]
            ra = w[:, :1].long() + torch.arange(tile_m, device=dev)
            cb = w[:, 1:].long() + torch.arange(tile_n, device=dev)
            oa = onehot_rows(a["seqs"][ra].reshape(-1, lpad))
            ob = onehot_rows(b["seqs"][cb].reshape(-1, lpad))
            matches = torch.bmm(
                oa.view(len(w), tile_m, kdim).to(prod),
                ob.view(len(w), tile_n, kdim).to(prod).transpose(1, 2),
            )
            rep_a, rep_b = a["rep"][ra], b["rep"][cb]
            hit = (
                (a["key32"][ra][:, :, None] == b["key32"][cb][:, None, :])
                & (rep_a >= 0)[:, :, None]
                & (rep_b >= 0)[:, None, :]
                & (lpad - matches <= differences)
            )
            t, i, j = hit.nonzero(as_tuple=True)
            score = _pair_score(score_mode, a["cnt"][ra[t, i]].long(),
                                b["cnt"][cb[t, j]].long())
            out.index_put_(
                (rep_a[t, i].long() * r2p + rep_b[t, j].long(),), score,
                accumulate=True,
            )
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out.view(r1p, r2p)


def dense_onehot(a: dict, b: dict, work: torch.Tensor, *, differences: int,
                 score_mode: int, tile_m: int, tile_n: int, r1p: int,
                 r2p: int) -> torch.Tensor:
    """dense_match's int64 [r1p, r2p] matrix, computed as v2 computes
    it: the position matches of each tile are an int8 one-hot product
    on the tensor cores. a/b are device_args_raw dicts (int32 key and
    count rows) in any row order; work is int32 [T, 2] element starts
    of tiles inside both row sets, on the same device; tile_m and
    tile_n are multiples of 64 and every residue code is below
    ONEHOT_CLASSES. No ratio. CUDA tensors launch csrc/dense_onehot.cu,
    which skips the sub-blocks whose keys cannot meet; CPU tensors take
    dense_onehot_plain."""
    if tile_m % _ONEHOT_TILE or tile_n % _ONEHOT_TILE:
        raise ValueError(f"dense_onehot needs tiles that are multiples of "
                         f"{_ONEHOT_TILE}, got {tile_m}x{tile_n}")
    dev = _check_join(a, b, work, wide=False, indels=False, tile_m=tile_m,
                      tile_n=tile_n, r1p=r1p, r2p=r2p, name="dense_onehot")
    if score_mode == SC_RATIO:
        raise ValueError("dense_onehot sums integers: no ratio score")
    for side in (a,) if b is a else (a, b):
        if side["seqs"].numel():
            torch._assert_async(
                side["seqs"].max() < ONEHOT_CLASSES,
                f"dense_onehot: a residue code is >= {ONEHOT_CLASSES}, "
                "outside the one-hot classes",
            )
    kw = dict(differences=differences, score_mode=score_mode,
              tile_m=tile_m, tile_n=tile_n, r1p=r1p, r2p=r2p)
    if dev.type == "cpu":
        return dense_onehot_plain(a, b, work, **kw)
    lpad = a["seqs"].shape[1]
    lib = load_library("dense_onehot")
    _check_smem("dense_onehot", lib.dense_onehot_smem_bytes(lpad),
                f"lpad={lpad}")
    out = torch.zeros((r1p, r2p), dtype=torch.int64, device=dev)
    if work.shape[0] == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.dense_onehot_launch(
            a["seqs"].data_ptr(), a["key32"].data_ptr(),
            a["rep"].data_ptr(), a["cnt"].data_ptr(),
            b["seqs"].data_ptr(), b["key32"].data_ptr(),
            b["rep"].data_ptr(), b["cnt"].data_ptr(),
            work.data_ptr(), work.shape[0],
            a["seqs"].shape[0], b["seqs"].shape[0], tile_m, tile_n, lpad,
            differences, score_mode, r2p, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"dense_onehot launch failed: CUDA error {err} "
            f"({lib.dense_onehot_error_string(err).decode()})"
        )
    _count_launch("dense_onehot")
    return out


# --------------------------------------------------------------------
# count_tiles / extract_tiles: kernel wrappers and plain versions
# --------------------------------------------------------------------

# tile classes of the kernels (csrc/tile_match.cu TileClass): the
# streams engine.find_pairs splits its worklist into
CLS_HAMMING, CLS_BOTH, CLS_INDEL_ONLY = 0, 1, 2
CLASS_NAMES = ("hamming", "both", "indel_only")  # by class

# elements of a plain version's [tiles, TM, TN, lpad] compare per step
_PLAIN_ELEMS = 1 << 26


def _first_mismatch_plain(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """[B, TM, TN] position of the first differing residue of every
    row pair, lpad when the rows are equal."""
    neq = sa[:, :, None, :] != sb[:, None, :, :]
    first = neq.to(torch.uint8).argmax(-1)  # the first maximal index
    return torch.where(neq.any(-1), first, neq.shape[-1])


def _match_tiles_plain(a: dict, b: dict, work: torch.Tensor, *,
                       differences: int, cls: int, exclude_self: bool,
                       tile_m: int, tile_n: int,
                       key: str = "key") -> torch.Tensor:
    """bool [B, TM, TN] match masks of the tiles work [B, 2]: the match
    criterion of csrc/tile_match.cu and csrc/dense_general.cu
    (pallas_kernels._cached_key_match), on the key row `key`."""
    dev = work.device
    ra = work[:, :1].long() + torch.arange(tile_m, device=dev)
    cb = work[:, 1:].long() + torch.arange(tile_n, device=dev)
    ka = a[key][ra].long()[:, :, None]
    kb = b[key][cb].long()[:, None, :]
    sa, sb = a["seqs"][ra], b["seqs"][cb]
    hit = torch.zeros((len(work), tile_m, tile_n), dtype=torch.bool,
                      device=dev)
    if cls != CLS_INDEL_ONLY:
        diff = (sa[:, :, None, :] != sb[:, None, :, :]).sum(-1)
        hit |= (ka == kb) & (diff <= differences)
    if cls != CLS_HAMMING:
        pre = _first_mismatch_plain(sa, sb)
        suf = _first_mismatch_plain(a["rseqs"][ra], b["rseqs"][cb])
        minlen = torch.minimum(ka & 0xFFFF, kb & 0xFFFF)
        hit |= ((ka - kb).abs() == 1) & (pre + suf >= minlen)
    if exclude_self:
        hit &= a["orig"][ra][:, :, None] != b["orig"][cb][:, None, :]
    return hit


def _plain_batches(work: torch.Tensor, tile_m: int, tile_n: int,
                   lpad: int):
    step = max(1, _PLAIN_ELEMS // (tile_m * tile_n * lpad))
    for s in range(0, len(work), step):
        yield s, work[s : s + step]


def count_tiles_plain(a: dict, b: dict, work: torch.Tensor, *,
                      differences: int, cls: int, exclude_self: bool,
                      tile_m: int, tile_n: int) -> torch.Tensor:
    """Plain PyTorch version of the count_tiles kernel: int32 [T]
    match counts, a few hundred tiles a step."""
    lpad = a["seqs"].shape[1]
    out = torch.zeros(len(work), dtype=torch.int32, device=work.device)
    for s, w in _plain_batches(work, tile_m, tile_n, lpad):
        hit = _match_tiles_plain(
            a, b, w, differences=differences, cls=cls,
            exclude_self=exclude_self, tile_m=tile_m, tile_n=tile_n,
        )
        out[s : s + len(w)] = hit.sum((1, 2)).to(torch.int32)
    return out


_SLOTS_MISMATCH = "extract_tiles: a tile's matches do not fill its slots"


def extract_tiles_plain(a: dict, b: dict, work: torch.Tensor, *,
                        differences: int, cls: int, exclude_self: bool,
                        tile_m: int, tile_n: int, offsets: torch.Tensor,
                        total: int):
    """Plain PyTorch version of the extract_tiles kernel: (a original
    indices, b original indices), int32 [total] tensors, tile t's
    matches in slots offsets[t] .. offsets[t + 1] - 1 (total after the
    last tile), in row and column order; raises where a tile's matches
    do not fill its slots."""
    lpad = a["seqs"].shape[1]
    # (tile, a row, b column) of every match: tile by tile, each tile's
    # matches in row and column order
    parts = [torch.zeros((3, 0), dtype=torch.int64, device=work.device)]
    for s, w in _plain_batches(work, tile_m, tile_n, lpad):
        hit = _match_tiles_plain(
            a, b, w, differences=differences, cls=cls,
            exclude_self=exclude_self, tile_m=tile_m, tile_n=tile_n,
        )
        wt, r, c = hit.nonzero(as_tuple=True)
        parts.append(torch.stack([wt + s, w[wt, 0].long() + r,
                                  w[wt, 1].long() + c]))
    t, ra, cb = torch.cat(parts, 1)
    n_t = torch.bincount(t, minlength=len(work))
    ends = torch.cat([offsets[1:], offsets.new_tensor([total])])
    if len(work) == 0:
        if total:
            raise RuntimeError(_SLOTS_MISMATCH)
    elif offsets[0] < 0 or not torch.equal(ends - offsets, n_t):
        raise RuntimeError(_SLOTS_MISMATCH)
    first = torch.cumsum(n_t, 0) - n_t
    slot = offsets[t] + torch.arange(len(t), device=work.device) - first[t]
    out = torch.empty((2, total), dtype=torch.int32, device=work.device)
    out[0, slot] = a["orig"][ra]
    out[1, slot] = b["orig"][cb]
    return out[0], out[1]


def _check_sparse_side(side: dict, name: str, dev: torch.device,
                       cls: int) -> None:
    seqs = side["seqs"]
    if seqs.dtype != torch.int8 or seqs.dim() != 2 or not seqs.is_contiguous():
        raise ValueError(f"{name}['seqs'] must be a contiguous int8 [npad, lpad] tensor")
    rows = [("seqs", seqs)]
    if cls != CLS_HAMMING:
        r = side.get("rseqs")
        if r is None or r.dtype != torch.int8 or r.shape != seqs.shape or not r.is_contiguous():
            raise ValueError(f"{name}['rseqs'] must be a contiguous int8 tensor shaped as seqs on indel tiles")
        rows.append(("rseqs", r))
    for k, dtypes in (("key", (torch.int32, torch.int64)), ("orig", (torch.int32,))):
        x = side[k]
        if x.dtype not in dtypes or x.shape != (seqs.shape[0],) or not x.is_contiguous():
            raise ValueError(f"{name}[{k!r}] must be a contiguous {'/'.join(map(str, dtypes))} [npad] tensor")
        rows.append((k, x))
    for k, x in rows:
        if x.device != dev:
            raise ValueError(f"{name}[{k!r}] is on {x.device}, expected {dev}")
        if dev.type == "cuda" and x.data_ptr() % 16:
            raise ValueError(f"{name}[{k!r}] is not 16-byte aligned")


def _check_tiles(a: dict, b: dict, work: torch.Tensor, cls: int,
                 tile_m: int, tile_n: int) -> torch.device:
    """The device of a tile call, after its input checks: the rows'
    types, shapes and devices, the worklist's, and (on the device, with
    no host sync) that every tile lies inside both row sets. The
    kernels read the residue planes (and, on the indel classes, the
    reversed rows' planes), which CUDA requires and the plain versions
    ignore (they are checked where present)."""
    dev = a["seqs"].device
    _check_sparse_side(a, "a", dev, cls)
    _check_sparse_side(b, "b", dev, cls)
    lpad = a["seqs"].shape[1]
    if b["seqs"].shape[1] != lpad:
        raise ValueError("a and b residue rows differ in width")
    if a["key"].dtype != b["key"].dtype:
        raise ValueError("a and b key rows differ in type")
    if (
        work.dtype != torch.int32
        or work.dim() != 2
        or work.shape[1] != 2
        or not work.is_contiguous()
        or work.device != dev
    ):
        raise ValueError(f"work must be a contiguous int32 [T, 2] tensor on {dev}")
    if cls not in (CLS_HAMMING, CLS_BOTH, CLS_INDEL_ONLY):
        raise ValueError(f"unknown tile class {cls}")
    if tile_m <= 0 or tile_n <= 0 or tile_n % 32:
        raise ValueError(f"tiles must be positive with tile_n % 32 == 0, got {tile_m}x{tile_n}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"tile kernels run on cuda or cpu tensors, not {dev}")
    _assert_tiles_inside(a, b, work, tile_m, tile_n, "tile_match")
    if dev.type == "cuda" or "planes" in a or "planes" in b:
        _check_plane_pair(a, b, dev, cls != CLS_HAMMING)
    return dev


def _assert_tiles_inside(a: dict, b: dict, work: torch.Tensor, tile_m: int,
                         tile_n: int, name: str) -> None:
    """On the device, with no host sync: every tile of work lies inside
    both row sets."""
    if len(work):
        torch._assert_async(
            (work.min() >= 0)
            & (work[:, 0].max() <= _npad(a) - tile_m)
            & (work[:, 1].max() <= _npad(b) - tile_n),
            f"{name}: a worklist tile lies outside the row sets",
        )


def _tile_args(a: dict, b: dict, work: torch.Tensor, cls: int, tile_m: int,
               tile_n: int, differences: int, exclude_self: bool):
    """The shared leading arguments of the two C launch functions (the
    reversed rows' planes only on the classes that read them)."""
    indels = cls != CLS_HAMMING
    n_chunks, n_planes = a["planes"].shape[1:]
    return (
        a["planes"].data_ptr(), a["rplanes"].data_ptr() if indels else None,
        a["key"].data_ptr(), a["orig"].data_ptr(),
        b["planes"].data_ptr(), b["rplanes"].data_ptr() if indels else None,
        b["key"].data_ptr(), b["orig"].data_ptr(),
        work.data_ptr(), work.shape[0], a["seqs"].shape[0],
        b["seqs"].shape[0], tile_m, tile_n, n_chunks, n_planes,
        a["seqs"].shape[1], differences, cls, int(exclude_self),
        a["key"].element_size(),
    )


def _tile_library(a: dict, cls: int, tile_m: int, tile_n: int):
    lib = load_library("tile_match")
    n_chunks, n_planes = a["planes"].shape[1:]
    _check_smem("tile_match",
                lib.tile_match_smem_bytes(tile_m, tile_n, n_chunks, n_planes,
                                          cls),
                f"tile_n={tile_n}, lpad={a['seqs'].shape[1]}")
    return lib


def _raise_on(lib, name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({lib.tile_match_error_string(err).decode()})"
        )


def count_tiles(a: dict, b: dict, work: torch.Tensor, *, differences: int,
                cls: int, exclude_self: bool, tile_m: int,
                tile_n: int) -> torch.Tensor:
    """int32 [T] match counts of the worklist tiles (work: int32 [T, 2]
    element starts), on the rows' device, without a host sync. a/b are
    device_rows_raw dicts, whose rows are key-sorted with pads last:
    the kernel searches each a run's key window in the b tile, so it
    needs that order, and it reads the residue planes (device_rows_raw
    with planes), which CUDA requires; the plain version needs neither.
    cls is the tile class (CLS_*). CUDA tensors launch
    csrc/tile_match.cu; CPU tensors take count_tiles_plain."""
    dev = _check_tiles(a, b, work, cls, tile_m, tile_n)
    kw = dict(differences=differences, cls=cls, exclude_self=exclude_self,
              tile_m=tile_m, tile_n=tile_n)
    if dev.type == "cpu":
        return count_tiles_plain(a, b, work, **kw)
    out = torch.empty(work.shape[0], dtype=torch.int32, device=dev)
    if work.shape[0] == 0:
        return out
    lib = _tile_library(a, cls, tile_m, tile_n)
    with torch.cuda.device(dev):
        err = lib.count_tiles_launch(
            *_tile_args(a, b, work, cls, tile_m, tile_n, differences,
                        exclude_self),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, "count_tiles", err)
    _count_launch("count_tiles")
    return out


def _check_offsets(offsets: torch.Tensor, total, work: torch.Tensor,
                   dev: torch.device) -> None:
    if (
        not isinstance(offsets, torch.Tensor)
        or offsets.dtype != torch.int64
        or offsets.shape != (work.shape[0],)
        or not offsets.is_contiguous()
        or offsets.device != dev
    ):
        raise ValueError(
            f"offsets must be a contiguous int64 [T] tensor on {dev}, one "
            "slot start a worklist tile")
    if not isinstance(total, int) or total < 0:
        raise ValueError(f"total must be an int >= 0, got {total!r}")


def extract_tiles(a: dict, b: dict, work: torch.Tensor, *, differences: int,
                  cls: int, exclude_self: bool, tile_m: int, tile_n: int,
                  offsets: torch.Tensor, total: int):
    """Every match of the worklist tiles as its pair of original
    indices: (i1, i2) int32 [total] tensors on the rows' device, with no
    copy to the host. The rows are count_tiles'. offsets (int64 [T], on
    the device) gives each tile's first slot: tile t's matches fill
    slots offsets[t] .. offsets[t + 1] - 1, and the last tile's end at
    total, so offsets is the exclusive prefix sum of count_tiles' counts
    and total their sum. Raises where a tile's matches do not fill its
    slots (one flag read back a call).

    CUDA tensors launch csrc/tile_match.cu, whose pairs within a tile
    come in no fixed order; CPU tensors take extract_tiles_plain (row
    and column order)."""
    dev = _check_tiles(a, b, work, cls, tile_m, tile_n)
    _check_offsets(offsets, total, work, dev)
    if dev.type == "cpu":
        return extract_tiles_plain(
            a, b, work, differences=differences, cls=cls,
            exclude_self=exclude_self, tile_m=tile_m, tile_n=tile_n,
            offsets=offsets, total=total,
        )
    # one buffer: [a indices (total), b indices (total), error flag]
    buf = torch.empty(2 * total + 1, dtype=torch.int32, device=dev)
    flag = buf[2 * total:]
    flag.zero_()
    if work.shape[0]:
        lib = _tile_library(a, cls, tile_m, tile_n)
        with torch.cuda.device(dev):
            err = lib.extract_tiles_launch(
                *_tile_args(a, b, work, cls, tile_m, tile_n, differences,
                            exclude_self),
                offsets.data_ptr(), total, buf.data_ptr(),
                buf[total:].data_ptr(), flag.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _raise_on(lib, "extract_tiles", err)
        _count_launch("extract_tiles")
    elif total:
        raise RuntimeError(_SLOTS_MISMATCH)
    bad = int(flag.item())
    trace.count("d2h_bytes", flag.element_size())
    if bad:
        raise RuntimeError(_SLOTS_MISMATCH)
    return buf[:total], buf[total : 2 * total]


# --------------------------------------------------------------------
# dense_indel / dense_general: kernel wrappers and plain versions
# --------------------------------------------------------------------


def _dense_join_plain(a: dict, b: dict, work: torch.Tensor, *, key: str,
                      cnt: str, indels: bool, differences: int,
                      score_mode: int, out_dtype: torch.dtype, tile_m: int,
                      tile_n: int, r1p: int, r2p: int) -> torch.Tensor:
    """The plain version of the three dense kernels, a few tiles a
    step: the match masks of _match_tiles_plain on the key
    row `key` (Hamming on equal keys, and with indels the indel test on
    keys 1 apart), the pad mask (rep >= 0 on both sides), the per-pair
    score in out_dtype from the count row `cnt`, and a scatter-add into
    the [r1p, r2p] matrix."""
    dev = a["seqs"].device
    lpad = a["seqs"].shape[1]
    out = torch.zeros(r1p * r2p, dtype=out_dtype, device=dev)
    cls = CLS_BOTH if indels else CLS_HAMMING
    for _, w in _plain_batches(work, tile_m, tile_n, lpad):
        hit = _match_tiles_plain(
            a, b, w, differences=differences, cls=cls, exclude_self=False,
            tile_m=tile_m, tile_n=tile_n, key=key,
        )
        ra = w[:, :1].long() + torch.arange(tile_m, device=dev)
        cb = w[:, 1:].long() + torch.arange(tile_n, device=dev)
        rep_a = a["rep"][ra].long()
        rep_b = b["rep"][cb].long()
        hit &= (rep_a >= 0)[:, :, None] & (rep_b >= 0)[:, None, :]
        t, i, j = hit.nonzero(as_tuple=True)
        s = _pair_score(
            score_mode,
            a[cnt][ra[t, i]].to(out_dtype),
            b[cnt][cb[t, j]].to(out_dtype),
        )
        out.index_put_((rep_a[t, i] * r2p + rep_b[t, j],), s,
                       accumulate=True)
    return out.view(r1p, r2p)


def dense_indel_plain(a: dict, b: dict, work: torch.Tensor, *,
                      differences: int, score_mode: int, tile_m: int,
                      tile_n: int, r1p: int, r2p: int) -> torch.Tensor:
    """Plain PyTorch version of the dense_indel kernel (int64 sums over
    the int32 key and count rows)."""
    return _dense_join_plain(
        a, b, work, key="key32", cnt="cnt", indels=True,
        differences=differences, score_mode=score_mode,
        out_dtype=torch.int64, tile_m=tile_m, tile_n=tile_n, r1p=r1p,
        r2p=r2p,
    )


def dense_general_plain(a: dict, b: dict, work: torch.Tensor, *,
                        differences: int, indels: bool, score_mode: int,
                        float_out: bool, tile_m: int, tile_n: int, r1p: int,
                        r2p: int) -> torch.Tensor:
    """Plain PyTorch version of the dense_general kernel (int64 sums, or
    float64 with float_out, over the int64 key and count rows)."""
    return _dense_join_plain(
        a, b, work, key="key64", cnt="cnt64", indels=indels,
        differences=differences, score_mode=score_mode,
        out_dtype=torch.float64 if float_out else torch.int64,
        tile_m=tile_m, tile_n=tile_n, r1p=r1p, r2p=r2p,
    )


def _check_join(a: dict, b: dict, work: torch.Tensor, *, wide: bool,
                indels: bool, tile_m: int, tile_n: int, r1p: int, r2p: int,
                name: str, planes: bool = False) -> torch.device:
    """The device of a dense_indel / dense_general / dense_onehot call,
    after its input checks: the rows' types, shapes, devices and
    alignment, the worklist's, and (on the device, with no host sync)
    that every tile lies inside both row sets and every repertoire
    inside the matrix. planes: the CUDA kernel reads residue planes
    (and, with indels, the reversed rows' planes), which a CUDA call
    then requires in place of the residue rows; the plain version reads
    the residue rows, and the planes are checked where present."""
    dev = a["rep"].device
    cuda_planes = planes and dev.type == "cuda"
    _check_side(a, "a", dev, wide=wide, indels=indels,
                byte_rows=not cuda_planes)
    _check_side(b, "b", dev, wide=wide, indels=indels,
                byte_rows=not cuda_planes)
    if "seqs" in a and "seqs" in b and (b["seqs"].shape[1]
                                        != a["seqs"].shape[1]):
        raise ValueError("a and b residue rows differ in width")
    _check_work(work, dev)
    if tile_m <= 0 or tile_n <= 0:
        raise ValueError(f"tiles must be positive, got {tile_m}x{tile_n}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {dev}")
    if cuda_planes or (planes and ("planes" in a or "planes" in b)):
        _check_plane_pair(a, b, dev, indels)
    elif dev.type == "cuda" and a["seqs"].shape[1] % 4:
        raise ValueError(f"{name} needs lpad % 4 == 0, got "
                         f"{a['seqs'].shape[1]}")
    _assert_tiles_inside(a, b, work, tile_m, tile_n, name)
    _assert_reps(a, b, r1p, r2p, name)
    return dev


def _launch_join(name: str, a: dict, b: dict, work: torch.Tensor, *,
                 wide: bool, indels: bool, float_out: bool,
                 differences: int, score_mode: int, tile_m: int,
                 tile_n: int, r1p: int, r2p: int) -> torch.Tensor:
    """dense_indel's or dense_general's kernel (csrc/dense_general.cu) on
    checked CUDA inputs: the [r1p, r2p] matrix, int64 or float64."""
    dev = a["rep"].device
    lib = load_library("dense_general")
    n_chunks, n_planes = a["planes"].shape[1:]
    if name == "dense_indel":
        smem = lib.dense_indel_smem_bytes(tile_m, tile_n, n_chunks, n_planes)
    else:
        smem = lib.dense_general_smem_bytes(tile_m, tile_n, n_chunks,
                                            n_planes, int(indels))
    _check_smem(name, smem, f"{tile_m}x{tile_n}, C={n_chunks}, P={n_planes}")
    out = torch.zeros((r1p, r2p),
                      dtype=torch.float64 if float_out else torch.int64,
                      device=dev)
    if work.shape[0] == 0:
        return out
    key, cnt = ("key64", "cnt64") if wide else ("key32", "cnt")
    args = []
    for side in (a, b):
        args += [side["planes"].data_ptr(),
                 side["rplanes"].data_ptr() if indels else None,
                 side[key].data_ptr(), side["rep"].data_ptr(),
                 side[cnt].data_ptr()]
    args += [work.data_ptr(), work.shape[0], _npad(a), _npad(b), tile_m,
             tile_n, n_chunks, n_planes, differences]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if name == "dense_indel":
            err = lib.dense_indel_launch(*args, score_mode, r2p,
                                         out.data_ptr(), stream)
        else:
            err = lib.dense_general_launch(*args, int(indels), score_mode,
                                           r2p, int(float_out),
                                           out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({lib.dense_general_error_string(err).decode()})"
        )
    _count_launch(name)
    return out


def dense_indel(a: dict, b: dict, work: torch.Tensor, *, differences: int,
                score_mode: int, tile_m: int, tile_n: int, r1p: int,
                r2p: int) -> torch.Tensor:
    """int64 [r1p, r2p] matrix of a dense run with the indel: the sum
    of the score over every pair of every worklist tile with rep >= 0
    on both sides that matches by Hamming (equal keys, at most
    `differences` differing residues) or by the indel test (keys 1
    apart, prefix + suffix >= the shorter length). a/b are
    device_args_raw dicts with indels (int32 key and count rows),
    key-sorted with pads (key -1) last, as the kernel's key windows
    need; work is int32 [T, 2] element starts of tiles inside both row
    sets, on the same device. No ratio. CUDA tensors launch
    csrc/dense_general.cu, which reads the residue planes and the
    reversed rows' planes (device_args_raw with planes) and raises
    without them; CPU tensors take dense_indel_plain, which reads the
    residue rows."""
    dev = _check_join(a, b, work, wide=False, indels=True, tile_m=tile_m,
                      tile_n=tile_n, r1p=r1p, r2p=r2p, name="dense_indel",
                      planes=True)
    if score_mode == SC_RATIO:
        raise ValueError("dense_indel sums integers: no ratio score")
    kw = dict(differences=differences, score_mode=score_mode,
              tile_m=tile_m, tile_n=tile_n, r1p=r1p, r2p=r2p)
    if dev.type == "cpu":
        return dense_indel_plain(a, b, work, **kw)
    return _launch_join("dense_indel", a, b, work, wide=False, indels=True,
                        float_out=False, **kw)


def dense_general(a: dict, b: dict, work: torch.Tensor, *, differences: int,
                  indels: bool, score_mode: int, float_out: bool,
                  tile_m: int, tile_n: int, r1p: int,
                  r2p: int) -> torch.Tensor:
    """[r1p, r2p] matrix of any dense run: dense_indel's sum (the indel
    test only with indels) over wide rows (device_args_raw with wide:
    int64 key and count rows), in int64, or in float64 with float_out.
    The ratio score needs float_out; the caller takes int64 only where
    no cell can pass 2^62 (engine._cell_bound). CUDA tensors launch
    csrc/dense_general.cu, which reads the residue planes (and, with
    indels, the reversed rows' planes) and raises without them; CPU
    tensors take dense_general_plain."""
    dev = _check_join(a, b, work, wide=True, indels=indels, tile_m=tile_m,
                      tile_n=tile_n, r1p=r1p, r2p=r2p, name="dense_general",
                      planes=True)
    if score_mode == SC_RATIO and not float_out:
        raise ValueError("dense_general sums ratio scores in float64 only")
    kw = dict(differences=differences, score_mode=score_mode, tile_m=tile_m,
              tile_n=tile_n, r1p=r1p, r2p=r2p)
    if dev.type == "cpu":
        return dense_general_plain(a, b, work, indels=indels,
                                   float_out=float_out, **kw)
    return _launch_join("dense_general", a, b, work, wide=True,
                        indels=indels, float_out=float_out, **kw)


# --------------------------------------------------------------------
# airr_parse: the AIRR TSV tokeniser of io/card.py's card route
# --------------------------------------------------------------------

# the columns a spec names, in the order of csrc/airr_parse.cu's F_ words
AIRR_FIELDS = ("seq", "rep", "sid", "dc", "v", "j")
AIRR_KINDS = ("rep", "v", "j")  # the interned tokens, in slot order
AIRR_SLOTS = 1 << 12  # table slots a kind at first; grown while over half full
AIRR_TILE_BYTES = 1 << 14  # line_count_kernel's tile
# one entry a try: the bits of a token's FNV-1a hash that key the tables
# (as int64), all of them. Each try hashes the tokens from its own offset
# basis (airr_key_basis), so two tokens that share a key in one try are
# told apart by the next; a file whose tokens still share a key after
# the last try goes to the host parser. A test narrows a try's mask to
# plant collisions.
AIRR_KEY_MASKS = (-1, -1, -1)
# csrc/airr_parse.cu's stats words
_S_FLAGGED, _S_LONGEST, _S_SHORTEST, _S_TOTAL_DUP, _S_RESIDUES = range(5)
_S_OCCUPIED, _S_OVERFLOW, _S_COLLISIONS = 5, 8, 9
_S_IGN_UNKNOWN, _S_IGN_EMPTY, _S_IGNORED = 10, 11, 12
_FNV_BASIS = 1469598103934665603
_FNV_PRIME = 1099511628211
_COUNT_MAX = 1 << 62
_WHITESPACE = (32, 9, 10, 13, 11, 12)  # what strtol skips


def airr_key_basis(attempt: int) -> int:
    """The FNV-1a offset basis (as int64) of a try's token keys: the
    standard one first, then the golden-ratio step added by xor."""
    b = (_FNV_BASIS ^ (attempt * 0x9E3779B97F4A7C15)) & (2**64 - 1)
    return b - (1 << 64) if b >= 1 << 63 else b


@dataclass(frozen=True)
class AirrSpec:
    """What the row pass reads: cols, the 1-based column of each
    AIRR_FIELDS entry (0 where the header lacks it); the read options;
    and where the default repertoire id's bytes lie in the buffer
    (def_off, def_len), past the body."""

    cols: tuple
    nucleotides: bool
    ignore_counts: bool
    ignore_genes: bool
    require_sid: bool
    def_off: int
    def_len: int
    ignore_unknown: bool = False
    ignore_empty: bool = False

    def col(self, field: str) -> int:
        return self.cols[AIRR_FIELDS.index(field)]

    def words(self, attempt: int = 0) -> np.ndarray:
        """The int64 spec words the C entries read (the P_ words), the
        token keys those of try attempt."""
        return np.asarray(
            [*self.cols, self.ignore_counts, self.ignore_genes,
             self.require_sid, self.def_off, self.def_len,
             AIRR_KEY_MASKS[attempt], airr_key_basis(attempt),
             self.ignore_unknown, self.ignore_empty], dtype=np.int64)

    def residue_map(self) -> np.ndarray:
        """int8 [256]: each byte's residue code, -1 for none."""
        from ..constants import MAP_AA, MAP_NT

        return MAP_NT if self.nucleotides else MAP_AA


def _airr_call(name: str, fn: str, *args) -> None:
    lib = load_library("airr_parse")
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({lib.airr_parse_error_string(err).decode()})")
    _count_launch(name)


def _check_body(body: torch.Tensor, n_bytes: int, spec: AirrSpec) -> None:
    if (body.dtype != torch.uint8 or body.dim() != 1
            or not body.is_contiguous()):
        raise ValueError("airr_scan: body must be a contiguous uint8 row")
    if n_bytes <= 0 or body.numel() < n_bytes + (-n_bytes % 16) or (
            spec.def_off + spec.def_len > body.numel()):
        raise ValueError(
            f"airr_scan: a buffer of {body.numel()} bytes cannot hold a "
            f"{n_bytes}-byte body padded to 16 and the default id")
    if len(spec.cols) != len(AIRR_FIELDS) or not spec.col("seq"):
        raise ValueError("airr_scan: the spec names no sequence column")


def _tables(keys: np.ndarray, rows: np.ndarray, tok_off: np.ndarray,
            tok_len: np.ndarray, n_slots: int) -> dict:
    """firsts (each distinct token's first line, ascending: the order of
    first appearance), first_slots, tok_off, tok_len: one list entry a
    kind, from the tables' used slots."""
    out = {"firsts": [], "first_slots": [], "tok_off": [], "tok_len": []}
    for k in range(len(AIRR_KINDS)):
        part = slice(k * n_slots, (k + 1) * n_slots)
        used = np.flatnonzero(keys[part] != 0)
        order = used[np.argsort(rows[part][used], kind="stable")]
        out["firsts"].append(rows[part][order].astype(np.int64))
        out["first_slots"].append(order.astype(np.int64))
        out["tok_off"].append(tok_off[part][order])
        out["tok_len"].append(tok_len[part][order])
    return out


def airr_scan(body: torch.Tensor, n_bytes: int, spec: AirrSpec) -> dict:
    """Tokenise the body of an AIRR TSV, the file after its header line,
    held in body (uint8, zero-padded past n_bytes to a 16-byte multiple,
    the default repertoire id at spec.def_off), as the host parser
    (native/airr_parser.cpp, io/airr.py) reads it. Returns a dict:
    lines, starts (int64 [lines + 1]), flagged (rows that would be an
    error), ignored (rows skipped under -u and -e), ignored_unknown and
    ignored_empty (the host parser's counts), n (the rows kept),
    collisions (kept rows whose repertoire, V or J token differs from
    the first line's with its key, after the last try of
    AIRR_KEY_MASKS), longest, shortest, total_dup, residues; on body's
    device, for the kept rows in file order, lengths int32, counts
    int64, row_hash int64 (the uint64 FNV-1a of the residue codes),
    seq_off int64, sid_off int64 and sid_len int32 (None without a
    sequence_id column), slots int32 [3, n], map (the residue table);
    and, a list of one numpy array a kind (AIRR_KINDS), firsts (the
    first line of each distinct token, ascending), first_slots, tok_off,
    tok_len (the token's bytes in body). Where flagged or collisions is
    not 0 the rest is not complete. CUDA tensors launch
    csrc/airr_parse.cu; CPU tensors take airr_scan_plain."""
    _check_body(body, n_bytes, spec)
    if body.device.type == "cpu":
        return airr_scan_plain(body, n_bytes, spec)
    dev = body.device
    with torch.cuda.device(dev):
        return _airr_scan_cuda(body, n_bytes, spec, dev)


def _airr_scan_cuda(body, n_bytes, spec, dev) -> dict:
    stream = torch.cuda.current_stream(dev).cuda_stream
    i64, i32 = torch.int64, torch.int32
    tiles = -(-n_bytes // AIRR_TILE_BYTES)
    tile_first = torch.empty(tiles + 1, dtype=i64, device=dev)
    _airr_call("airr_lines", "airr_line_count_launch", body.data_ptr(),
               n_bytes, tile_first.data_ptr(), stream)
    newlines = int(tile_first[tiles])
    open_end = n_bytes + 1 if int(body[n_bytes - 1]) != 10 else -1
    n = newlines + (open_end > 0)
    if n >= 1 << 31:
        raise ValueError(f"airr_scan: {n} lines pass int32 row ids")
    starts = torch.empty(n + 1, dtype=i64, device=dev)
    _airr_call("airr_lines", "airr_line_starts_launch", body.data_ptr(),
               n_bytes, tile_first.data_ptr(), newlines, open_end,
               starts.data_ptr(), stream)
    del tile_first
    out = {
        "lines": n, "n": n, "starts": starts,
        "lengths": torch.empty(n, dtype=i32, device=dev),
        "counts": torch.empty(n, dtype=i64, device=dev),
        "row_hash": torch.empty(n, dtype=i64, device=dev),
        "seq_off": torch.empty(n, dtype=i64, device=dev),
        "sid_off": None, "sid_len": None,
        "slots": torch.empty((len(AIRR_KINDS), n), dtype=i32, device=dev),
        "map": torch.from_numpy(spec.residue_map()).to(dev),
    }
    if spec.col("sid"):
        out["sid_off"] = torch.empty(n, dtype=i64, device=dev)
        out["sid_len"] = torch.empty(n, dtype=i32, device=dev)
    stats = torch.empty(int(load_library("airr_parse").airr_stats_words()),
                        dtype=i64, device=dev)
    n_slots = AIRR_SLOTS
    row_args = [None if out[k] is None else out[k].data_ptr()
                for k in _AIRR_ROW_FIELDS]
    for attempt in range(len(AIRR_KEY_MASKS)):
        words = spec.words(attempt)
        while True:
            keys = torch.empty(len(AIRR_KINDS) * n_slots, dtype=i64,
                               device=dev)
            rows = torch.empty(len(AIRR_KINDS) * n_slots, dtype=i32,
                               device=dev)
            _airr_call("airr_rows", "airr_rows_launch", body.data_ptr(),
                       starts.data_ptr(), n, words.ctypes.data,
                       out["map"].data_ptr(), *row_args, keys.data_ptr(),
                       rows.data_ptr(), n_slots, stats.data_ptr(), stream)
            st = stats.cpu().numpy()
            occupied = int(st[_S_OCCUPIED:_S_OCCUPIED + 3].max())
            if st[_S_FLAGGED] or not (st[_S_OVERFLOW]
                                      or 2 * occupied > n_slots):
                break
            n_slots = (n_slots * 16 if st[_S_OVERFLOW]
                       else 1 << (4 * occupied - 1).bit_length())
        out.update(n_slots=n_slots, flagged=int(st[_S_FLAGGED]),
                   collisions=0)
        if out["flagged"]:
            return out
        tok_off = torch.empty(len(AIRR_KINDS) * n_slots, dtype=i64,
                              device=dev)
        tok_len = torch.empty(len(AIRR_KINDS) * n_slots, dtype=i32,
                              device=dev)
        _airr_call("airr_verify", "airr_verify_launch", body.data_ptr(),
                   starts.data_ptr(), n, words.ctypes.data,
                   out["lengths"].data_ptr(), out["slots"].data_ptr(),
                   keys.data_ptr(), rows.data_ptr(), n_slots,
                   tok_off.data_ptr(), tok_len.data_ptr(),
                   stats.data_ptr(), stream)
        st = stats.cpu().numpy()
        if not st[_S_COLLISIONS]:
            break
    tables = [t.cpu().numpy() for t in (keys, rows, tok_off, tok_len)]
    trace.count("d2h_bytes", st.nbytes + sum(t.nbytes for t in tables))
    out.update(_tables(*tables, n_slots))
    out.update(collisions=int(st[_S_COLLISIONS]),
               longest=int(st[_S_LONGEST]), shortest=int(st[_S_SHORTEST]),
               total_dup=int(st[_S_TOTAL_DUP]),
               residues=int(st[_S_RESIDUES]),
               ignored=int(st[_S_IGNORED]),
               ignored_unknown=int(st[_S_IGN_UNKNOWN]),
               ignored_empty=int(st[_S_IGN_EMPTY]))
    if out["ignored"] and not out["collisions"]:
        _airr_compact_cuda(out, dev, stream)
    return out


# the row pass's per-row arrays, in the order of its C entry's arguments
_AIRR_ROW_FIELDS = ("lengths", "counts", "row_hash", "seq_off", "sid_off",
                    "sid_len", "slots")


def _airr_compact_cuda(out: dict, dev, stream) -> None:
    """out's per-row arrays cut to the kept rows (in place of the
    lines'), n set to their count."""
    n = out["lines"]
    m = n - out["ignored"]
    lib = load_library("airr_parse")
    scratch = torch.empty(int(lib.airr_offset_chunks(n)) + 1,
                          dtype=torch.int64, device=dev)
    index = torch.empty(n + 1, dtype=torch.int64, device=dev)
    kept = {k: None if out[k] is None else torch.empty(
        (len(AIRR_KINDS), m) if k == "slots" else m, dtype=out[k].dtype,
        device=dev) for k in _AIRR_ROW_FIELDS}
    ptr = [None if out[k] is None else out[k].data_ptr()
           for k in _AIRR_ROW_FIELDS]
    _airr_call("airr_compact", "airr_compact_launch", n, *ptr,
               scratch.data_ptr(), index.data_ptr(), m,
               *[None if kept[k] is None else kept[k].data_ptr()
                 for k in _AIRR_ROW_FIELDS], stream)
    out.update(kept, n=m)


def _token_bytes(body: torch.Tensor, off: torch.Tensor,
                 length: torch.Tensor, width: int) -> torch.Tensor:
    """int64 [n, width]: each token's bytes, -1 past its length."""
    pos = torch.arange(width, dtype=torch.int64)
    idx = (off[:, None] + pos).clamp(0, body.numel() - 1)
    return torch.where(pos < length[:, None], body[idx].long(),
                       torch.full((), -1, dtype=torch.int64))


def _fnv_plain(vals: torch.Tensor, length: torch.Tensor,
               basis: int = _FNV_BASIS) -> torch.Tensor:
    """int64 [n]: the FNV-1a hash (uint64 bits; offset basis basis) of
    each row's first length values (bytes or residue codes) of vals
    [n, width]."""
    h = torch.full((vals.shape[0],), basis, dtype=torch.int64)
    for c in range(vals.shape[1]):
        h = torch.where(c < length, (h ^ (vals[:, c] & 0xFF)) * _FNV_PRIME,
                        h)
    return h


def _lines_plain(body: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """int64 [n + 1] line starts, as line_starts_kernel writes them."""
    b = body[:n_bytes]
    parts = [torch.zeros(1, dtype=torch.int64),
             torch.nonzero(b == 10).flatten() + 1]
    if int(b[-1]) != 10:
        parts.append(torch.tensor([n_bytes + 1]))
    return torch.cat(parts)


def _fields_plain(body: torch.Tensor, n_bytes: int, starts: torch.Tensor,
                  spec: AirrSpec) -> dict:
    """{field: (off, len)} of each line, len -1 where the line lacks the
    column, as split_fields gives them."""
    s, q = starts[:-1], starts[1:] - 1
    cr = (q > s) & (body[(q - 1).clamp(min=0)] == 13)
    e = q - cr.long()
    tabs = torch.nonzero(body[:n_bytes] == 9).flatten()
    lo = torch.searchsorted(tabs, s)
    ntab = torch.searchsorted(tabs, e) - lo
    tab = tabs if len(tabs) else torch.zeros(1, dtype=torch.int64)

    def at(k):  # each line's k-th tab, where it has one
        return tab[(lo + k).clamp(0, len(tab) - 1)]

    missing = torch.full_like(s, -1)
    out = {}
    for field, c in zip(AIRR_FIELDS, spec.cols):
        if not c:
            out[field] = (s, missing)
            continue
        start = s if c == 1 else at(c - 2) + 1
        end = torch.where(ntab >= c, at(c - 1), e)
        have = ntab >= c - 1
        out[field] = (torch.where(have, start, s),
                      torch.where(have, end - start, missing))
    return out


def _counts_plain(body: torch.Tensor, off: torch.Tensor,
                  length: torch.Tensor):
    """(ok, value) of parse_count over each token (length >= 0)."""
    n = len(length)
    width = int(length.max()) if n else 0
    tb = _token_bytes(body, off, length, width)
    blank = torch.isin(tb, torch.tensor(_WHITESPACE))
    skipping = torch.ones(n, dtype=torch.bool)
    i = torch.zeros(n, dtype=torch.int64)  # the first byte past the blanks
    for c in range(width):
        skipping &= blank[:, c]
        i += skipping.long()
    first = (tb.gather(1, i.clamp(max=max(width - 1, 0))[:, None])[:, 0]
             if width else torch.full((n,), -1, dtype=torch.int64))
    sign = (i < length) & ((first == 43) | (first == 45))
    d0 = i + sign.long()  # the first digit
    ok = (d0 < length) & ~(sign & (first == 45))
    v = torch.zeros(n, dtype=torch.int64)
    for c in range(width):
        inside = (c >= d0) & (c < length)
        digit = tb[:, c] - 48
        ok &= ~inside | ((digit >= 0) & (digit <= 9))
        v = torch.where(inside & ok, v * 10 + digit.clamp(0, 9), v)
        ok &= v <= _COUNT_MAX
    return ok & (v >= 1), v


def airr_scan_plain(body: torch.Tensor, n_bytes: int, spec: AirrSpec) -> dict:
    """airr_scan in plain PyTorch (CPU), vectorised over the lines. Its
    slots are the distinct tokens' ranks in first-appearance order."""
    starts = _lines_plain(body, n_bytes)
    lines = len(starts) - 1
    f = _fields_plain(body, n_bytes, starts, spec)
    seq_off, seq_len = f["seq"]
    seq_len = seq_len.clamp(min=0)
    res_map = torch.from_numpy(spec.residue_map())
    tb = _token_bytes(body, seq_off, seq_len, int(seq_len.max()))
    codes = torch.where(tb >= 0, res_map.long()[tb.clamp(min=0)],
                        torch.full((), -2, dtype=torch.int64))
    # airr_parser.cpp's scan: an unknown printable symbol is ignored
    # under -u, any other byte that is no residue an error; no residue
    # is ignored under -e
    printable = (tb >= 32) & (tb <= 126)
    unknown = ((codes == -1) & printable).sum(1)
    length = (codes >= 0).sum(1)
    bad = ((codes == -1) & ~printable).any(1)
    if not spec.ignore_unknown:
        bad |= unknown > 0
    if not spec.ignore_empty:
        bad |= length == 0
    skip = ~bad & ((unknown > 0) | (length == 0))
    kept = ~bad & ~skip
    sid_off = sid_len = None
    if spec.col("sid"):
        sid_off, sid_len = f["sid"][0], f["sid"][1].clamp(min=0).int()
        if spec.require_sid:
            bad |= kept & (sid_len == 0)
    dc_off, dc_len = f["dc"]
    ok, counts = _counts_plain(body, dc_off, dc_len.clamp(min=0))
    counts = torch.where(dc_len > 0, counts, torch.ones_like(counts))
    bad |= kept & (dc_len > 0) & ~ok
    if not spec.ignore_counts:
        bad |= kept & (dc_len <= 0)
    if not spec.ignore_genes:
        bad |= kept & ((f["v"][1] <= 0) | (f["j"][1] <= 0))
    line = torch.nonzero(kept).flatten()  # the kept rows' lines
    n = len(line)
    out = {"lines": lines, "n": n, "starts": starts,
           "lengths": length[line].int(), "counts": counts[line],
           "row_hash": _fnv_plain(codes, length)[line],
           "seq_off": seq_off[line],
           "sid_off": None if sid_off is None else sid_off[line],
           "sid_len": None if sid_len is None else sid_len[line],
           "map": res_map, "flagged": int(bad.sum()), "collisions": 0,
           "n_slots": 0, "ignored": int(skip.sum()),
           "ignored_unknown": int(unknown[skip].sum()),
           "ignored_empty": int((skip & (length == 0)).sum())}
    if out["flagged"]:
        return out
    for attempt in range(len(AIRR_KEY_MASKS)):
        tables = _token_ranks_plain(body, f, line, spec, attempt)
        out.update(tables)
        if not out["collisions"]:
            break
    kl = out["lengths"]
    out.update(longest=int(kl.max()) if n else 0,
               shortest=int(kl.min()) if n else 0x7FFFFFFF,
               total_dup=int(out["counts"].sum()), residues=int(kl.sum()))
    return out


def _token_ranks_plain(body: torch.Tensor, f: dict, line: torch.Tensor,
                       spec: AirrSpec, attempt: int) -> dict:
    """slots, firsts, first_slots, tok_off, tok_len and collisions of the
    kept rows (their lines line) under try attempt's keys."""
    out = {"firsts": [], "first_slots": [], "tok_off": [], "tok_len": []}
    n = len(line)
    pos = torch.arange(n, dtype=torch.int64)
    differ = torch.zeros(n, dtype=torch.bool)
    slots = []
    basis = airr_key_basis(attempt)
    for kind in AIRR_KINDS:
        off, ln = f[kind][0][line], f[kind][1][line]
        if kind == "rep":
            off = torch.where(ln < 0, spec.def_off, off)
            ln = torch.where(ln < 0, spec.def_len, ln)
        ln = ln.clamp(min=0)
        kb = _token_bytes(body, off, ln, int(ln.max()) if n else 0)
        key = _fnv_plain(kb, ln, basis) & AIRR_KEY_MASKS[attempt]
        key = torch.where(key == 0, 1, key)
        uniq, inv = torch.unique(key, return_inverse=True)
        first = torch.full((len(uniq),), n, dtype=torch.int64).scatter_reduce(
            0, inv, pos, "amin")
        rep = first[inv]
        differ |= (ln != ln[rep]) | (kb != kb[rep]).any(1)
        order = torch.argsort(first)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(len(order))
        slots.append(rank[inv].int())
        out["firsts"].append(line[first[order]].numpy())
        out["first_slots"].append(np.arange(len(order), dtype=np.int64))
        out["tok_off"].append(off[first[order]].numpy())
        out["tok_len"].append(ln[first[order]].int().numpy())
    out["slots"] = (torch.stack(slots) if n else
                    torch.zeros((len(AIRR_KINDS), 0), dtype=torch.int32))
    out["collisions"] = int(differ.sum())
    return out


def airr_ids(scan: dict, ids: list) -> torch.Tensor:
    """int32 [3, n] on the scan's device: each row's repertoire, V and J
    id, ids giving one numpy int32 array a kind (AIRR_KINDS) in the
    order of scan["firsts"]. CUDA tensors launch csrc/airr_parse.cu,
    which turns the scan's slots into the ids in place; CPU tensors take
    a gather (the plain version)."""
    slots = scan["slots"]
    if slots.device.type == "cpu":
        return torch.stack([torch.from_numpy(np.asarray(x, dtype=np.int32))[
            slots[k].long()] for k, x in enumerate(ids)])
    return _airr_ids_cuda(scan, ids)


def _airr_ids_cuda(scan: dict, ids: list) -> torch.Tensor:
    slots = scan["slots"]
    n_slots = scan["n_slots"]
    table = np.zeros(len(AIRR_KINDS) * n_slots, dtype=np.int32)
    for k, x in enumerate(ids):
        table[k * n_slots + scan["first_slots"][k]] = x
    dev = slots.device
    slot_ids = torch.from_numpy(table).to(dev)
    with torch.cuda.device(dev):
        _airr_call("airr_ids", "airr_ids_launch", slots.data_ptr(),
                   scan["n"], slot_ids.data_ptr(), n_slots,
                   torch.cuda.current_stream(dev).cuda_stream)
    return slots


def airr_pack(body: torch.Tensor, scan: dict, lmax: int,
              pad: int) -> torch.Tensor:
    """int8 [n, lmax] on body's device: each row's residue codes, then
    pad. CUDA tensors launch csrc/airr_parse.cu; CPU tensors take a
    gather (the plain version)."""
    if body.device.type == "cpu":
        tb = _token_bytes(body, scan["seq_off"], scan["lengths"].long(),
                          lmax)
        return torch.where(tb >= 0, scan["map"][tb.clamp(min=0)],
                           torch.full((), pad, dtype=torch.int8))
    return _airr_pack_cuda(body, scan, lmax, pad)


def _airr_pack_cuda(body, scan, lmax, pad) -> torch.Tensor:
    out = torch.empty((scan["n"], lmax), dtype=torch.int8,
                      device=body.device)
    with torch.cuda.device(body.device):
        _airr_call("airr_pack", "airr_pack_launch", body.data_ptr(),
                   scan["seq_off"].data_ptr(), scan["lengths"].data_ptr(),
                   scan["n"], lmax, scan["map"].data_ptr(), pad,
                   out.data_ptr(),
                   torch.cuda.current_stream(body.device).cuda_stream)
    return out


def airr_gather(src: torch.Tensor, off: torch.Tensor,
                length: torch.Tensor):
    """(blob uint8, offsets int64 [k + 1]) on src's device: the k tokens
    src[off[t], +length[t]) one after another (off int64, length int32;
    a negative length counts 0). CUDA tensors launch
    csrc/airr_parse.cu; CPU tensors take cumsum and a gather (the plain
    version)."""
    if src.device.type == "cpu":
        ln = length.long().clamp(min=0)
        offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                             torch.cumsum(ln, 0)])
        total = int(offsets[-1])
        starts = torch.repeat_interleave(off - offsets[:-1], ln)
        return src[starts + torch.arange(total)], offsets
    return _airr_gather_cuda(src, off, length)


def _airr_gather_cuda(src, off, length):
    k = len(length)
    dev = src.device
    with torch.cuda.device(dev):
        lib = load_library("airr_parse")
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = torch.empty(int(lib.airr_offset_chunks(k)) + 1,
                              dtype=torch.int64, device=dev)
        offsets = torch.empty(k + 1, dtype=torch.int64, device=dev)
        _airr_call("airr_gather", "airr_offsets_launch", length.data_ptr(),
                   k, scratch.data_ptr(), offsets.data_ptr(), stream)
        blob = torch.empty(int(offsets[k]), dtype=torch.uint8, device=dev)
        _airr_call("airr_gather", "airr_gather_launch", src.data_ptr(),
                   off.data_ptr(), length.data_ptr(), offsets.data_ptr(), k,
                   blob.data_ptr(), stream)
    return blob, offsets


# --------------------------------------------------------------------
# build and load
# --------------------------------------------------------------------

# kernel sources under csrc/, each built into its own shared library
# with a plain C interface, and the C signatures the wrappers call
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "dense_match": {
        "dense_match_launch": ([_P] * 9 + [_I] * 10 + [_P, _P], _I),
        "dense_match_smem_bytes": ([_I] * 4, _I),
        "dense_match_error_string": ([_I], ctypes.c_char_p),
    },
    "dense_onehot": {
        "dense_onehot_launch": ([_P] * 9 + [_I] * 9 + [_P, _P], _I),
        "dense_onehot_smem_bytes": ([_I], _I),
        "dense_onehot_error_string": ([_I], ctypes.c_char_p),
    },
    "dense_general": {
        "dense_indel_launch": ([_P] * 11 + [_I] * 10 + [_P, _P], _I),
        "dense_general_launch": ([_P] * 11 + [_I] * 12 + [_P, _P], _I),
        "dense_indel_smem_bytes": ([_I] * 4, _I),
        "dense_general_smem_bytes": ([_I] * 5, _I),
        "dense_general_error_string": ([_I], ctypes.c_char_p),
    },
    "tile_match": {
        "count_tiles_launch": ([_P] * 9 + [_I] * 12 + [_P, _P], _I),
        "extract_tiles_launch": ([_P] * 9 + [_I] * 12 + [_P, _L]
                                 + [_P] * 4, _I),
        "tile_match_smem_bytes": ([_I] * 5, _I),
        "tile_match_error_string": ([_I], ctypes.c_char_p),
    },
    "derive_rows": {
        "derive_rows_launch": ([_P, _L, _I, _P, _L, _P] + [_I] * 4
                               + [_P] * 5, _I),
        "derive_rows_error_string": ([_I], ctypes.c_char_p),
    },
    "airr_parse": {
        "airr_line_count_launch": ([_P, _L, _P, _P], _I),
        "airr_line_starts_launch": ([_P, _L, _P, _L, _L, _P, _P], _I),
        "airr_rows_launch": ([_P, _P, _L] + [_P] * 11 + [_I, _P, _P], _I),
        "airr_verify_launch": ([_P, _P, _L] + [_P] * 5 + [_I] + [_P] * 4,
                               _I),
        "airr_compact_launch": ([_L] + [_P] * 9 + [_L] + [_P] * 8, _I),
        "airr_ids_launch": ([_P, _L, _P, _I, _P], _I),
        "airr_pack_launch": ([_P, _P, _P, _L, _I, _P, _I, _P, _P], _I),
        "airr_offsets_launch": ([_P, _L, _P, _P, _P], _I),
        "airr_gather_launch": ([_P] * 4 + [_L, _P, _P], _I),
        "airr_offset_chunks": ([_L], _L),
        "airr_stats_words": ([], _I),
        "airr_parse_error_string": ([_I], ctypes.c_char_p),
    },
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_LIBS: dict = {}
_BUILD_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.environ.get("NVCC"),
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the CUDA kernels are "
        "built from csrc/ at first use"
    )


def library_path(name: str) -> str:
    """build/lib<name>-<hash>.so, the hash taken over the source and
    the flags, so an edited source never loads a stale build."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str, verbose: bool = False) -> str:
    """Compile csrc/<name>.cu with nvcc unless a current build exists.
    Returns the library path. Raises with nvcc's output when it fails."""
    path = library_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.run(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    if verbose and proc.stdout:
        print(proc.stdout, end="")
    if proc.returncode != 0:
        raise RuntimeError(
            f"kernel build failed: {name}: nvcc exited {proc.returncode}\n"
            f"{proc.stdout}"
        )
    os.replace(tmp, path)
    trace.count_job("kernel_builds", 1)
    return path


def load_library(name: str):
    """The ctypes handle of a built kernel library (building it first
    when needed), with its C signatures set."""
    with _BUILD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
            trace.count_job("kernel_loads", 1)
        return lib
