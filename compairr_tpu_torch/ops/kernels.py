"""Device layouts and the hand-written kernels of the device routes.

Port of the parts of compairr_tpu/ops/pallas_kernels.py that the dense
engine runs:

  * the device derive (pallas_kernels.py:2049-2493): the host packs
    residues 6 five-bit codes to an int32 word (_pack_residues /
    _packed_upload); the device gathers the rows into key-sorted order
    and unpacks them (_gathered_seqs / _unpack_residues) and gathers
    the repertoire and count rows (device_args_raw). Torch ops, not
    kernels. Substitution runs need no reversed rows and the kernel
    reads residues, so no one-hot rows are derived.
  * the kernel choice (_dense_kernel_kind, pallas_kernels.py:1424):
    the v3 kernel's eligibility without the TPU's memory gates.
  * dense_match: the wrapper of csrc/dense_match.cu, which replaces the
    v3 dense kernel (pallas_kernels.py:970), with its launch counter
    and its plain PyTorch version (dense_match_plain).
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
from typing import Optional

import numpy as np
import torch

from ..constants import (
    SCORE_JACCARD,
    SCORE_MAX,
    SCORE_MEAN,
    SCORE_MH,
    SCORE_MIN,
    SCORE_PRODUCT,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# launches per kernel, counted by each wrapper where it launches its
# kernel and nowhere else (a run reads them to prove its path)
LAUNCHES = {"dense_match": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------
# device derive
# --------------------------------------------------------------------

RES_PER_WORD = 6  # 5-bit residues per int32 word (values < 32)
_DERIVE_CHUNK = 1 << 21  # rows per derive step: bounds int32 temporaries


def _pack_residues(seqs_i8: np.ndarray) -> np.ndarray:
    """Host half of the residue compression: 6 five-bit residues per
    int32 word, ~4x fewer bytes to upload than int8 rows at lmax 24.
    All residue codes (aa 0..20 incl. pad, nt 0..4) fit 5 bits."""
    n, l = seqs_i8.shape
    nw = -(-l // RES_PER_WORD)
    grown = np.zeros((n, nw * RES_PER_WORD), dtype=np.uint32)
    grown[:, :l] = seqs_i8.astype(np.uint32)
    g = grown.reshape(n, nw, RES_PER_WORD)
    packed = g[:, :, 0].copy()
    for k in range(1, RES_PER_WORD):
        packed |= g[:, :, k] << np.uint32(5 * k)
    return packed.astype(np.int32)


def _packed_upload(db, m: int, lpad: int, pad_val: int) -> np.ndarray:
    """[m, nw] int32 packed residues for upload, all-pad past db.n:
    native single pass when available, else numpy."""
    from ..io.native import pack5_rows_native

    nw = -(-lpad // RES_PER_WORD)
    nat = pack5_rows_native(db.seqs, m, lpad, nw, pad_val)
    if nat is not None:
        return nat
    n = db.n
    seqs = np.full((m, lpad), pad_val, dtype=np.int8)
    if n:
        seqs[:n, : db.seqs.shape[1]] = db.seqs
    return _pack_residues(seqs)


def _unpack_residues(packed: torch.Tensor, lmax: int) -> torch.Tensor:
    """Device half: [N, nw] int32 -> [N, lmax] int8."""
    npad, nw = packed.shape
    shifts = (
        torch.arange(RES_PER_WORD, dtype=torch.int32, device=packed.device)
        * 5
    ).reshape(1, 1, RES_PER_WORD)
    res = ((packed[:, :, None] >> shifts) & 31).to(torch.int8)
    return res.reshape(npad, nw * RES_PER_WORD)[:, :lmax].contiguous()


def _gathered_seqs(packed: torch.Tensor, order: torch.Tensor,
                   lmax: int) -> torch.Tensor:
    """Key-sorted [npad, lmax] int8 residue rows, gathered and unpacked
    in row chunks so the int32 temporaries stay bounded at scale."""
    npad = order.shape[0]
    out = torch.empty((npad, lmax), dtype=torch.int8, device=packed.device)
    for s in range(0, npad, _DERIVE_CHUNK):
        o = order[s : s + _DERIVE_CHUNK]
        out[s : s + len(o)] = _unpack_residues(packed.index_select(0, o), lmax)
    return out


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


def device_args_raw(db, order: np.ndarray, npad: int, lpad: int,
                    sort_key: np.ndarray, device) -> dict:
    """Upload a SeqDB's raw arrays (plus one all-pad sentinel row) and
    derive the key-sorted layouts the dense kernel reads, on `device`:

      seqs   int8  [npad, lpad]  residues, pad rows all pad residue
      key32  int32 [npad]        bucket key, pads -1
      rep    int32 [npad]        repertoire, pads -1
      cnt    int32 [npad]        duplicate count, pads 0

    `order` is pack_keys' permutation and `sort_key` its sorted padded
    key vector; padding rows gather the sentinel. Counts are
    parser-validated integers; the kernel choice admits counts below
    2^16 (or ignores them under -f), so int32 holds them."""
    n = db.n
    pad_val = int(db.pad_value)
    m = _canon_src(n + 1)
    order_full = np.full(npad, n, dtype=np.int64)
    order_full[:n] = order
    cnt = np.zeros(m, dtype=np.int32)
    cnt[:n] = np.asarray(db.counts, dtype=np.int64).astype(np.int32)
    k32 = np.full(npad, -1, dtype=np.int32)
    k32[:n] = sort_key[:n]

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    o = up(order_full)
    return {
        "seqs": _gathered_seqs(up(_packed_upload(db, m, lpad, pad_val)), o, lpad),
        "key32": up(k32),
        "rep": up(_shrink(db.rep_no, -1, m)).index_select(0, o).to(torch.int32),
        "cnt": up(cnt).index_select(0, o),
    }


def upload_worklist(work: np.ndarray, device) -> torch.Tensor:
    """int32 [T, 2] worklist of element starts on `device`."""
    return torch.from_numpy(
        np.ascontiguousarray(work, dtype=np.int32).reshape(-1, 2)
    ).to(device)


# --------------------------------------------------------------------
# kernel choice
# --------------------------------------------------------------------

# the JAX package's gate pallas_kernels._V2_GE_CMAX: the largest integer
# count its v3 min/max threshold chains cover; JAX sends larger counts to
# its v1 kernel, so the port raises there until v1 is ported
_V2_GE_CMAX = 64

_V1 = "the v1 dense kernel (compairr_tpu/ops/pallas_kernels.py:411 _make_kernel)"
_V2C = (
    "the v2c dense kernel (compairr_tpu/ops/pallas_kernels.py:1147 "
    "_make_dense_v2c_kernel)"
)


def _dense_kernel_kind(*, indels: bool, score_int: int,
                       ignore_counts: bool, cmax: float,
                       key_max: int) -> str:
    """The kernel a dense run takes: "dense_match" for every run the
    JAX package sends to its v3 kernel (the eligibility of
    pallas_kernels._dense_kernel_kind without the TPU memory gates
    _v3_scratch_ok, _v2_scratch_ok and _oh_fits: this kernel reads
    residues, so no one-hot budget exists). The runs JAX sends to v2c
    or v1 raise NotImplementedError naming the kernel still to port."""
    if indels:
        raise NotImplementedError(
            f"dense runs with indels need {_V2C}, not ported yet"
        )
    if key_max >= (1 << 31):
        raise NotImplementedError(
            f"dense runs with bucket keys >= 2^31 need {_V1}, not ported yet"
        )
    if ignore_counts:
        return "dense_match"
    if score_mode(score_int, False) is None:
        raise NotImplementedError(
            f"the dense ratio score needs {_V1}, not ported yet"
        )
    if score_int in (SCORE_JACCARD, SCORE_MIN, SCORE_MAX) and (
        cmax != int(cmax) or cmax > _V2_GE_CMAX
    ):
        raise NotImplementedError(
            f"dense min/max/Jaccard with counts above {_V2_GE_CMAX} "
            f"need {_V1}, not ported yet"
        )
    if cmax >= (1 << 16):
        raise NotImplementedError(
            f"dense runs with counts >= 2^16 need {_V1}, not ported yet"
        )
    return "dense_match"


# --------------------------------------------------------------------
# dense_match: kernel wrapper and plain version
# --------------------------------------------------------------------

# per-pair score modes of the kernel (csrc/dense_match.cu ScoreMode)
SC_ONE, SC_PRODUCT, SC_MIN, SC_MAX, SC_SUM = 0, 1, 2, 3, 4


def score_mode(score_int: int, ignore_counts: bool) -> Optional[int]:
    """Kernel score mode for a CompAIRR score (compute_score,
    CompAIRR src/overlap.cc:144-166): mean sums cnt_a + cnt_b and the
    caller halves the matrix; None for ratio, which has no exact
    integer form."""
    if ignore_counts:
        return SC_ONE
    return {
        SCORE_MH: SC_PRODUCT,
        SCORE_PRODUCT: SC_PRODUCT,
        SCORE_JACCARD: SC_MIN,
        SCORE_MIN: SC_MIN,
        SCORE_MAX: SC_MAX,
        SCORE_MEAN: SC_SUM,
    }.get(score_int)


def _pair_score(mode: int, ca: torch.Tensor, cb: torch.Tensor):
    if mode == SC_PRODUCT:
        return ca * cb
    if mode == SC_MIN:
        return torch.minimum(ca, cb)
    if mode == SC_MAX:
        return torch.maximum(ca, cb)
    if mode == SC_SUM:
        return ca + cb
    return torch.ones_like(ca)


def dense_match_plain(a: dict, b: dict, work: torch.Tensor, *,
                      differences: int, score_mode: int, tile_m: int,
                      tile_n: int, r1p: int, r2p: int) -> torch.Tensor:
    """Plain PyTorch version of the dense_match kernel, tile by tile:
    residue compare, key and pad mask, per-pair score, and an int64
    scatter-add into the [r1p, r2p] matrix."""
    dev = a["seqs"].device
    lpad = a["seqs"].shape[1]
    out = torch.zeros(r1p * r2p, dtype=torch.int64, device=dev)
    for ra, cb in work.tolist():
        if ra < 0 or cb < 0:
            continue
        sa = a["seqs"][ra : ra + tile_m]
        sb = b["seqs"][cb : cb + tile_n]
        matches = (sa[:, None, :] == sb[None, :, :]).sum(-1)
        rep_a = a["rep"][ra : ra + tile_m].long()
        rep_b = b["rep"][cb : cb + tile_n].long()
        hit = (
            (a["key32"][ra : ra + tile_m, None] == b["key32"][None, cb : cb + tile_n])
            & (matches >= lpad - differences)
            & (rep_a[:, None] >= 0)
            & (rep_b[None, :] >= 0)
        )
        i, j = hit.nonzero(as_tuple=True)
        if len(i) == 0:
            continue
        s = _pair_score(
            score_mode,
            a["cnt"][ra : ra + tile_m].long()[i],
            b["cnt"][cb : cb + tile_n].long()[j],
        )
        out.index_put_((rep_a[i] * r2p + rep_b[j],), s, accumulate=True)
    return out.view(r1p, r2p)


def _check_side(side: dict, name: str, dev: torch.device) -> None:
    seqs = side["seqs"]
    if seqs.dtype != torch.int8 or seqs.dim() != 2 or not seqs.is_contiguous():
        raise ValueError(f"{name}['seqs'] must be a contiguous int8 [npad, lpad] tensor")
    for k in ("key32", "rep", "cnt"):
        x = side[k]
        if (
            x.dtype != torch.int32
            or x.shape != (seqs.shape[0],)
            or not x.is_contiguous()
        ):
            raise ValueError(f"{name}[{k!r}] must be a contiguous int32 [npad] tensor")
    for k in ("seqs", "key32", "rep", "cnt"):
        if side[k].device != dev:
            raise ValueError(f"{name}[{k!r}] is on {side[k].device}, expected {dev}")


def dense_match(a: dict, b: dict, work: torch.Tensor, *, differences: int,
                score_mode: int, tile_m: int, tile_n: int, r1p: int,
                r2p: int) -> torch.Tensor:
    """int64 [r1p, r2p] matrix: sum of the score over every pair of
    every worklist tile with equal keys, rep >= 0 on both sides and at
    most `differences` differing residues. a/b are device_args_raw
    dicts, whose rows are key-sorted with pads (key -1) last: the
    kernel binary-searches each tile's b keys, so it needs that order;
    the plain version does not. work is int32 [T, 2] element starts on
    the same device. CUDA tensors launch csrc/dense_match.cu; CPU
    tensors take dense_match_plain."""
    dev = a["seqs"].device
    _check_side(a, "a", dev)
    _check_side(b, "b", dev)
    lpad = a["seqs"].shape[1]
    if b["seqs"].shape[1] != lpad:
        raise ValueError("a and b residue rows differ in width")
    if (
        work.dtype != torch.int32
        or work.dim() != 2
        or work.shape[1] != 2
        or not work.is_contiguous()
        or work.device != dev
    ):
        raise ValueError(f"work must be a contiguous int32 [T, 2] tensor on {dev}")
    # every repertoire index must address a cell of the output. Checked
    # on the device without a host sync: on the CPU a failure raises
    # here; on CUDA it is a device-side assert that stops the stream
    # before the kernel can write out of bounds, as PyTorch's own
    # indexing ops do.
    for side, rows in ((a, r1p), (b, r2p)):
        if side["rep"].numel():
            torch._assert_async(
                side["rep"].max() < rows,
                f"dense_match: a repertoire index is >= {rows}, outside "
                f"the [{r1p}, {r2p}] matrix",
            )
    kw = dict(differences=differences, score_mode=score_mode,
              tile_m=tile_m, tile_n=tile_n, r1p=r1p, r2p=r2p)
    if dev.type == "cpu":
        return dense_match_plain(a, b, work, **kw)
    if dev.type != "cuda":
        raise ValueError(f"dense_match runs on cuda or cpu tensors, not {dev}")
    if lpad % 4:
        raise ValueError(f"dense_match needs lpad % 4 == 0, got {lpad}")
    lib = load_library("dense_match")
    smem = lib.dense_match_smem_bytes(tile_n, lpad)
    if smem > 232448:
        raise ValueError(
            f"dense_match tile_n={tile_n}, lpad={lpad} needs {smem} bytes "
            "of shared memory a block, over the card's 232448"
        )
    out = torch.zeros((r1p, r2p), dtype=torch.int64, device=dev)
    n_tiles = work.shape[0]
    if n_tiles == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.dense_match_launch(
            a["seqs"].data_ptr(), a["key32"].data_ptr(),
            a["rep"].data_ptr(), a["cnt"].data_ptr(),
            b["seqs"].data_ptr(), b["key32"].data_ptr(),
            b["rep"].data_ptr(), b["cnt"].data_ptr(),
            work.data_ptr(), n_tiles,
            a["seqs"].shape[0], b["seqs"].shape[0], tile_m, tile_n, lpad,
            differences, score_mode, r2p, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"dense_match launch failed: CUDA error {err} "
            f"({lib.dense_match_error_string(err).decode()})"
        )
    LAUNCHES["dense_match"] += 1
    return out


# --------------------------------------------------------------------
# build and load
# --------------------------------------------------------------------

# kernel sources under csrc/, each built into its own shared library
# with a plain C interface, and the C signatures the wrappers call
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "dense_match": {
        "dense_match_launch": ([_P] * 9 + [_I] * 9 + [_P, _P], _I),
        "dense_match_smem_bytes": ([_I, _I], _I),
        "dense_match_error_string": ([_I], ctypes.c_char_p),
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
        return lib
