// dense_general: the rest of the dense overlap-matrix reduction, hand-written
// for Hopper. Two kernels, one template:
//
//   dense_indel    replaces the v2c dense Pallas kernel of the JAX package,
//                  compairr_tpu/ops/pallas_kernels.py:1147
//                  (_make_dense_v2c_kernel / _dense_v2c_fn :1229): the dense
//                  runs with one indel (-d 1 -i) whose keys fit int32 and
//                  whose score is integer with counts below 2^16 (or -f).
//   dense_general  replaces the v1 dense Pallas kernel, pallas_kernels.py:411
//                  (_make_kernel / _dense_pallas_fn :493): every other dense
//                  run, with or without the indel: the ratio score,
//                  min/max/Jaccard with a count above 64, counts >= 2^16 and
//                  bucket keys >= 2^31.
//
// Both compute, over a worklist of (row block, column block) tiles of the
// two key-sorted sets,
//
//   out[rep_a[i], rep_b[j]] += score(cnt_a[i], cnt_b[j])
//
// for every pair with rep >= 0 on both sides that matches under the
// criterion of _cached_key_match (pallas_kernels.py:229-320):
//   * Hamming match: equal keys and lpad - (equal residues) <= d, pad
//     residues matching themselves;
//   * indel match (indel runs only): keys exactly 1 apart and prefix + suffix
//     >= min(len_a, len_b), the common prefix of the forward rows and of the
//     rows reversed within their lengths, the lengths taken from key &
//     0xFFFF. An equal-key pair never takes the indel test.
// The key is (V*nJ + J) << 16 | length, or the length alone under -g, so
// equal keys mean equal (V, J, length) and keys 1 apart the same V and J
// with lengths 1 apart: dense_general's one int64 key row stands for v1's
// len/v/j rows, as tile_match.cu's does for the tile route.
//
// Pads carry key -1 and repertoire -1 on both sides (the dense derive's, not
// the tile route's salted band). As unsigned, -1 sorts after every real key,
// so a real row's key window [k-1, k+1] never reaches a pad; pad a rows are
// skipped, and every pair needs rep_b >= 0 as well, so no pad contributes on
// the equal-key run or on the +-1 runs.
//
// Sums. dense_indel adds integer scores (count product, min, max, sum, or 1)
// to an int64 cell with a 64-bit atomicAdd, exact in any order; mean sums
// cnt_a + cnt_b and the caller halves once. dense_general does the same in
// int64 when the caller has proved from per-block bounds that no cell can
// pass 2^62, and otherwise (and always for ratio, ca / (cb == 0 ? 1 : cb))
// adds float64 scores with atomicAdd(double*), the reference's own type
// (CompAIRR src/overlap.cc:144-166).
//
// What is not carried over from the TPU kernels: v2c's one-hot operands
// cached in VMEM scratch, its bilinear score chains with host-planned
// flushes and its f32 exactness guard; v1's per-tile one-hot matmuls, its
// bf16 exponent trick for the first mismatch and its f32 repertoire one-hot
// products (which make v1's ratio an f32 sum). Here, as in dense_match.cu:
//   * one block per (worklist tile, 64-row slice of its a rows);
//   * the tile's b rows in shared memory: residue words transposed to
//     [word][row] (and the reversed rows' words on indel runs), keys,
//     repertoires, counts; the a slice's words beside them;
//   * each a row, one warp, binary-searches the window of keys k-1..k+1
//     (k..k without indels) in the key-sorted b tile and tests only that
//     window's pairs, each lane one pair;
//   * residues compared four bytes a word: __vcmpne4 + __popc for the
//     Hamming count, __vcmpne4 + __ffs for the first mismatch.
//
// Bound on this card: per visited a row two binary searches, per equal-key
// pair lpad/4 word compares, per key-distance-1 pair up to 2 lpad/4, all
// integer work on the CUDA cores, with each b tile re-read from L2 by each of
// its tile's row slices. The bytes every touched row must move take far less
// time than that work; the kernels are bound by instruction issue and
// latency, not by device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSubM = 64;  // a rows per block

enum ScoreMode {
  kOne = 0,
  kProduct = 1,
  kMin = 2,
  kMax = 3,
  kSum = 4,
  kRatio = 5
};

__device__ __forceinline__ long long int_score(int mode, long long ca,
                                               long long cb) {
  switch (mode) {
    case kProduct:
      return ca * cb;
    case kMin:
      return ca < cb ? ca : cb;
    case kMax:
      return ca > cb ? ca : cb;
    case kSum:
      return ca + cb;
    default:
      return 1;
  }
}

__device__ __forceinline__ double f64_score(int mode, long long ca,
                                            long long cb) {
  const double a = static_cast<double>(ca);
  const double b = static_cast<double>(cb);
  switch (mode) {
    case kProduct:
      return a * b;
    case kMin:
      return ca < cb ? a : b;
    case kMax:
      return ca > cb ? a : b;
    case kSum:
      return a + b;
    case kRatio:
      return a / (cb == 0 ? 1.0 : b);
    default:
      return 1.0;
  }
}

__device__ __forceinline__ void add_score(unsigned long long* cell, int mode,
                                          long long ca, long long cb) {
  atomicAdd(cell, static_cast<unsigned long long>(int_score(mode, ca, cb)));
}

__device__ __forceinline__ void add_score(double* cell, int mode,
                                          long long ca, long long cb) {
  atomicAdd(cell, f64_score(mode, ca, cb));
}

// first index in keys[0, n) whose value is >= k (keys ascending)
template <typename Key>
__device__ __forceinline__ int lower_bound(const Key* keys, int n, Key k) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// position of the first differing byte of two rows of nw 4-byte words
// (b read with `stride` words between consecutive words), nw*4 if none
__device__ __forceinline__ int first_mismatch(const uint32_t* a,
                                              const uint32_t* b, int stride,
                                              int nw) {
  for (int w = 0; w < nw; ++w) {
    const uint32_t x = __vcmpne4(a[w], b[w * stride]);
    if (x) return 4 * w + ((__ffs(x) - 1) >> 3);
  }
  return 4 * nw;
}

// Key: uint32_t (int32 key row) or uint64_t (int64), read as unsigned so that
// the pads' -1 sorts last. Cnt: int32_t or int64_t. Out: unsigned long long
// (int64 sums) or double.
template <typename Key, typename Cnt, typename Out>
__global__ void __launch_bounds__(kThreads) dense_join_kernel(
    const uint32_t* __restrict__ a_res, const uint32_t* __restrict__ a_rres,
    const Key* __restrict__ a_key, const int32_t* __restrict__ a_rep,
    const Cnt* __restrict__ a_cnt, const uint32_t* __restrict__ b_res,
    const uint32_t* __restrict__ b_rres, const Key* __restrict__ b_key,
    const int32_t* __restrict__ b_rep, const Cnt* __restrict__ b_cnt,
    const int32_t* __restrict__ work, int npad_a, int npad_b, int tile_m,
    int tile_n, int nw, int differences, int indels, int mode, int r2p,
    Out* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key* b_keys = reinterpret_cast<Key*>(smem);                 // [tile_n]
  Cnt* b_cnts = reinterpret_cast<Cnt*>(b_keys + tile_n);      // [tile_n]
  int32_t* b_reps = reinterpret_cast<int32_t*>(b_cnts + tile_n);
  uint32_t* b_fwd = reinterpret_cast<uint32_t*>(b_reps + tile_n);
  const int planes = indels ? 2 : 1;
  uint32_t* b_rev = b_fwd + nw * tile_n;                 // [nw][tile_n]
  uint32_t* a_fwd = b_fwd + planes * nw * tile_n;        // [kSubM][nw]
  uint32_t* a_rev = a_fwd + kSubM * nw;                  // [kSubM][nw]

  const int t = blockIdx.x;
  const int a_start = work[2 * t];
  const int b0 = work[2 * t + 1];
  const int a0 = a_start + blockIdx.y * kSubM;
  // block-uniform exits, before any barrier: invalid or ragged tiles
  if (a_start < 0 || b0 < 0 || b0 >= npad_b) return;
  const int m = min(min(kSubM, tile_m - static_cast<int>(blockIdx.y) * kSubM),
                    npad_a - a0);
  if (m <= 0) return;
  const int nb = min(tile_n, npad_b - b0);

  for (int i = threadIdx.x; i < nb * nw; i += kThreads) {
    const int row = i / nw;
    const int w = i - row * nw;
    const size_t src = static_cast<size_t>(b0 + row) * nw + w;
    b_fwd[w * tile_n + row] = b_res[src];
    if (indels) b_rev[w * tile_n + row] = b_rres[src];
  }
  for (int j = threadIdx.x; j < nb; j += kThreads) {
    b_keys[j] = b_key[b0 + j];
    b_reps[j] = b_rep[b0 + j];
    b_cnts[j] = b_cnt[b0 + j];
  }
  for (int i = threadIdx.x; i < m * nw; i += kThreads) {
    const size_t src = static_cast<size_t>(a0) * nw + i;
    a_fwd[i] = a_res[src];
    if (indels) a_rev[i] = a_rres[src];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < m; r += kWarps) {
    const int ra = a0 + r;
    const int rep_a = a_rep[ra];
    if (rep_a < 0) continue;  // pad row
    // real keys are far below the unsigned maximum (< 2^31 for int32 rows,
    // < 2^62 for int64 rows), so k + 2 cannot wrap; k - 1 is taken only
    // when k >= 1
    const Key k = a_key[ra];
    const Key klo = (indels && k > 0) ? k - 1 : k;
    const int lo = lower_bound<Key>(b_keys, nb, klo);
    const int hi = lower_bound<Key>(b_keys, nb, k + (indels ? 2 : 1));
    const long long ca = a_cnt[ra];
    const int la = static_cast<int>(k & 0xFFFF);
    const uint32_t* aw = a_fwd + r * nw;
    const uint32_t* arw = a_rev + r * nw;
    Out* row_out = out + static_cast<size_t>(rep_a) * r2p;
    for (int j = lo + lane; j < hi; j += 32) {
      const Key kb = b_keys[j];
      bool hit;
      if (kb == k) {
        int diff_bits = 0;
        for (int w = 0; w < nw; ++w) {
          diff_bits += __popc(__vcmpne4(aw[w], b_fwd[w * tile_n + j]));
        }
        hit = (diff_bits >> 3) <= differences;
      } else {
        // the window holds k-1..k+1 on indel runs only
        const int lb = static_cast<int>(kb & 0xFFFF);
        const int pre = first_mismatch(aw, b_fwd + j, tile_n, nw);
        const int suf = first_mismatch(arw, b_rev + j, tile_n, nw);
        hit = pre + suf >= min(la, lb);
      }
      const int rep_b = b_reps[j];
      if (hit && rep_b >= 0) {
        add_score(row_out + rep_b, mode, ca, static_cast<long long>(b_cnts[j]));
      }
    }
  }
}

template <typename Key, typename Cnt>
int smem_bytes(int tile_n, int lpad, int indels) {
  const int nw = lpad / 4;
  const int planes = indels ? 2 : 1;
  return tile_n * static_cast<int>(sizeof(Key) + sizeof(Cnt) + 4) +
         planes * nw * (tile_n + kSubM) * 4;
}

template <typename Key, typename Cnt, typename Out>
int launch(const void* a_res, const void* a_rres, const void* a_key,
           const void* a_rep, const void* a_cnt, const void* b_res,
           const void* b_rres, const void* b_key, const void* b_rep,
           const void* b_cnt, const void* work, int n_tiles, int npad_a,
           int npad_b, int tile_m, int tile_n, int lpad, int differences,
           int indels, int mode, int r2p, void* out, void* stream) {
  if (n_tiles <= 0) return 0;
  if (lpad <= 0 || lpad % 4 != 0 || tile_m <= 0 || tile_n <= 0 ||
      mode < kOne || mode > kRatio || (indels && (!a_rres || !b_rres))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes<Key, Cnt>(tile_n, lpad, indels);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_join_kernel<Key, Cnt, Out>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>((tile_m + kSubM - 1) / kSubM));
  dense_join_kernel<Key, Cnt, Out>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(a_res),
          static_cast<const uint32_t*>(a_rres), static_cast<const Key*>(a_key),
          static_cast<const int32_t*>(a_rep), static_cast<const Cnt*>(a_cnt),
          static_cast<const uint32_t*>(b_res),
          static_cast<const uint32_t*>(b_rres), static_cast<const Key*>(b_key),
          static_cast<const int32_t*>(b_rep), static_cast<const Cnt*>(b_cnt),
          static_cast<const int32_t*>(work), npad_a, npad_b, tile_m, tile_n,
          lpad / 4, differences, indels, mode, r2p, static_cast<Out*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one dense_indel block needs, in bytes.
int dense_indel_smem_bytes(int tile_n, int lpad) {
  return smem_bytes<uint32_t, int32_t>(tile_n, lpad, 1);
}

// Shared memory one dense_general block needs, in bytes.
int dense_general_smem_bytes(int tile_n, int lpad, int indels) {
  return smem_bytes<uint64_t, int64_t>(tile_n, lpad, indels);
}

// dense_indel on `stream` over n_tiles worklist tiles (work: int32
// [n_tiles, 2] element starts). Residue rows and reversed residue rows are
// int8 [npad, lpad] with lpad a multiple of 4; key/rep/cnt rows int32 [npad];
// mode 0..4 (no ratio); out int64 [r1p, r2p], zeroed by the caller. Returns
// the cudaError_t of the launch (0 on success).
int dense_indel_launch(const void* a_res, const void* a_rres,
                       const void* a_key, const void* a_rep,
                       const void* a_cnt, const void* b_res,
                       const void* b_rres, const void* b_key,
                       const void* b_rep, const void* b_cnt,
                       const void* work, int n_tiles, int npad_a, int npad_b,
                       int tile_m, int tile_n, int lpad, int differences,
                       int mode, int r2p, void* out, void* stream) {
  if (mode == kRatio) return static_cast<int>(cudaErrorInvalidValue);
  return launch<uint32_t, int32_t, unsigned long long>(
      a_res, a_rres, a_key, a_rep, a_cnt, b_res, b_rres, b_key, b_rep, b_cnt,
      work, n_tiles, npad_a, npad_b, tile_m, tile_n, lpad, differences, 1,
      mode, r2p, out, stream);
}

// dense_general on `stream`: as dense_indel, with int64 key and count rows,
// the reversed rows read only when indels is 1 (else they may be null), mode
// 0..5, and out int64 (float_out 0; no ratio) or float64 (float_out 1)
// [r1p, r2p], zeroed by the caller.
int dense_general_launch(const void* a_res, const void* a_rres,
                         const void* a_key, const void* a_rep,
                         const void* a_cnt, const void* b_res,
                         const void* b_rres, const void* b_key,
                         const void* b_rep, const void* b_cnt,
                         const void* work, int n_tiles, int npad_a,
                         int npad_b, int tile_m, int tile_n, int lpad,
                         int differences, int indels, int mode, int r2p,
                         int float_out, void* out, void* stream) {
  if (float_out) {
    return launch<uint64_t, int64_t, double>(
        a_res, a_rres, a_key, a_rep, a_cnt, b_res, b_rres, b_key, b_rep,
        b_cnt, work, n_tiles, npad_a, npad_b, tile_m, tile_n, lpad,
        differences, indels, mode, r2p, out, stream);
  }
  if (mode == kRatio) return static_cast<int>(cudaErrorInvalidValue);
  return launch<uint64_t, int64_t, unsigned long long>(
      a_res, a_rres, a_key, a_rep, a_cnt, b_res, b_rres, b_key, b_rep, b_cnt,
      work, n_tiles, npad_a, npad_b, tile_m, tile_n, lpad, differences,
      indels, mode, r2p, out, stream);
}

const char* dense_general_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
