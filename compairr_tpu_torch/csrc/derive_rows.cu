// derive_rows: the key-sorted rows of both derives in one pass on the card.
//
// Replaces no Pallas kernel. It replaces the XLA device code of the JAX
// package's derive, compairr_tpu/ops/pallas_kernels.py: device_rows_raw
// :2354 with _gather_sparse_fn :2307 (the tile route's rows) and
// device_args_raw :2432 with _gathered_seqs :2191 (the dense engine's),
// which gather the host's 5-bit packed rows into key-sorted order, unpack
// them and reverse them within their lengths. The port ran that as
// PyTorch ops in row chunks, with the residue bit planes of
// kernels.residue_planes after it, about nine launches a chunk; here the
// parsed int8 rows go up as they are and one launch writes everything:
//
//   seqs    int8  [npad, lpad]  row order[i] of rows, pad residues from
//                               column w on; a row whose order is n or
//                               more (the sentinel) all pad
//   rseqs   int8  [npad, lpad]  each row reversed within len, pad after
//                               it, len = min(key & 0xFFFF, lpad) (with
//                               indels)
//   planes  int32 [npad, C, P]  bit p of word [i, c, q] is bit q of the
//                               residue at position 32 c + p, 0 past lpad
//                               (kernels.residue_planes; with planes)
//   rplanes int32 [npad, C, P]  the same of rseqs (with planes and indels)
//
// Columns of rows past lpad are not read. C = ceil(lpad / 32) and P (the
// pad code's bit length: 5 for amino acids, 3 for nucleotides) are run-time
// arguments, so one instantiation serves every width.
//
// Bound on the card: each byte read once and written once over 3.35 TB/s.
// A padded row reads its source row (w bytes), its order (8) and its key
// (4 or 8) and writes 2 lpad + 8 C P bytes: 1.11 GB, 0.33 ms, at igh10's
// 5,298,176 padded rows of lpad 40 (C = 2, P = 5); 0.51 GB, 0.15 ms, at
// keck20's 4,238,336 of lpad 24. The upload of the rows over PCIe (200 MB
// and 89 MB) is the larger cost. Design: one warp a row, lane p at position
// 32 c + p of chunk c. A lane's forward and reversed residues come from the
// source row in global memory (both reads within the row's one or two
// sectors, so the second comes from L1); the int8 rows are written 32
// consecutive bytes a warp store; each plane word is one __ballot_sync of
// bit q, so a row takes C P ballots (twice with the reversed rows) and no
// reduction, and lanes 0 .. P - 1 write a chunk's P words in one store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const signed char* rows;  // int8 [n, w]
  const long long* order;   // int64 [npad]
  const int* key;           // the key row's 32-bit words, key_words a key
  long long n;
  long long npad;
  int w;
  int lpad;
  int chunks;
  int n_planes;
  int key_words;
  int pad;
  signed char* seqs;
  signed char* rseqs;  // null without indels
  int* planes;         // null without planes
  int* rplanes;        // null without planes or indels
};

// residue j < lpad of the gathered row whose source is row (null: all pad)
__device__ __forceinline__ int residue(const signed char* row, int j, int w,
                                       int pad) {
  return (row != nullptr && j < w) ? row[j] : pad;
}

__global__ void __launch_bounds__(kThreads) derive_rows_kernel(Args a) {
  const long long i =
      (long long)blockIdx.x * kWarps + (long long)(threadIdx.x >> 5);
  if (i >= a.npad) return;  // a warp leaves whole
  const int lane = threadIdx.x & 31;
  const unsigned long long src = (unsigned long long)a.order[i];
  const signed char* row =
      src < (unsigned long long)a.n ? a.rows + (long long)src * a.w : nullptr;
  int len = 0;
  if (a.rseqs != nullptr) {
    // the low 16 bits of an int32 key, or of an int64 key's low word
    len = a.key[i * a.key_words] & 0xFFFF;
    if (len > a.lpad) len = a.lpad;
  }
  signed char* out = a.seqs + i * a.lpad;
  signed char* rout = a.rseqs != nullptr ? a.rseqs + i * a.lpad : nullptr;
  for (int c = 0; c < a.chunks; ++c) {
    const int j = 32 * c + lane;
    int x = 0;
    int rx = 0;
    if (j < a.lpad) {
      x = residue(row, j, a.w, a.pad);
      out[j] = (signed char)x;
      if (rout != nullptr) {
        rx = j < len ? residue(row, len - 1 - j, a.w, a.pad) : a.pad;
        rout[j] = (signed char)rx;
      }
    }
    if (a.planes == nullptr) continue;
    int word = 0;
    int rword = 0;
    for (int q = 0; q < a.n_planes; ++q) {
      const unsigned b = __ballot_sync(kFull, (x >> q) & 1);
      if (lane == q) word = (int)b;
      if (a.rplanes != nullptr) {
        const unsigned rb = __ballot_sync(kFull, (rx >> q) & 1);
        if (lane == q) rword = (int)rb;
      }
    }
    if (lane < a.n_planes) {
      const long long at = (i * a.chunks + c) * a.n_planes + lane;
      a.planes[at] = word;
      if (a.rplanes != nullptr) a.rplanes[at] = rword;
    }
  }
}

}  // namespace

extern "C" {

const char* derive_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rows int8 [n, w]; order int64 [npad]; key [npad], int32 (key_words 1)
// or int64 (2), read only with rseqs; outputs as above, rseqs, planes and
// rplanes null where not wanted (rplanes only with both). Launches on
// stream, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
int derive_rows_launch(const void* rows, long long n, int w,
                       const void* order, long long npad, const void* key,
                       int key_words, int lpad, int pad, int n_planes,
                       void* seqs, void* rseqs, void* planes, void* rplanes,
                       void* stream) {
  if (n < 0 || w < 0 || npad < 0 || lpad < 0 || (n > 0 && rows == nullptr) ||
      (key_words != 1 && key_words != 2) ||
      (planes != nullptr && (n_planes < 1 || n_planes > 32)) ||
      (rplanes != nullptr && (planes == nullptr || rseqs == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (npad == 0 || lpad == 0) return 0;
  Args a;
  a.rows = static_cast<const signed char*>(rows);
  a.order = static_cast<const long long*>(order);
  a.key = static_cast<const int*>(key);
  a.n = n;
  a.npad = npad;
  a.w = w;
  a.lpad = lpad;
  a.chunks = (lpad + 31) / 32;
  a.n_planes = n_planes;
  a.key_words = key_words;
  a.pad = pad;
  a.seqs = static_cast<signed char*>(seqs);
  a.rseqs = static_cast<signed char*>(rseqs);
  a.planes = static_cast<int*>(planes);
  a.rplanes = static_cast<int*>(rplanes);
  const long long blocks = (npad + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  derive_rows_kernel<<<(unsigned int)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
