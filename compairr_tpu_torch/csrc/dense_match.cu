// dense_match: the dense overlap-matrix reduction, hand-written for Hopper.
//
// Replaces the v3 dense Pallas kernel of the JAX package,
// compairr_tpu/ops/pallas_kernels.py:970 (_make_dense_v3_kernel /
// _dense_v3_fn), which computes, over a worklist of (row block, column
// block) tiles of the two key-sorted sets,
//
//   out[rep_a[i], rep_b[j]] += score(cnt_a[i], cnt_b[j])
//
// for every pair with key_a[i] == key_b[j], rep >= 0 on both sides and
// at most `differences` differing residues over the padded width (pad
// residues match themselves, so equal-length Hamming distance is the
// count of differing bytes).
//
// What it computes is v3's function; how it computes it is not v3's.
// The TPU kernel counts position matches with an int8 one-hot matmul
// on the MXU and folds scores through bilinear chains with host-planned
// flushes, an f32 matrix and an f32 exactness guard. None of that is
// carried over: no one-hot rows (no _ohp lane padding), no chain
// decomposition or flush flags (_flush_flags, _v2_run_cap), no DMA
// ring, no _dummy_i8 blocks and no 64-slot SMEM worklist chunking
// (_chunk_worklist). Here:
//   * one block per (worklist tile, 64-row slice of its a rows);
//   * the tile's b rows (residues transposed to [word][row], keys,
//     repertoires, counts) and the a slice's residues in shared memory;
//   * key test first: the b rows of a tile are sorted by key (pads,
//     key -1, sort last as unsigned), so each a row binary-searches its
//     equal-key run and only that run's residues are compared;
//   * residues compared directly, four bytes a word (__vcmpne4 + popc);
//   * the score computed per pair, as _score_tile does, and added with
//     a 64-bit integer atomicAdd. Integer sums are exact in any order,
//     so no f32 guard is needed; mean accumulates cnt_a + cnt_b and the
//     caller halves once.
//
// Bound on this card: per visited pair one key compare, per equal-key
// pair lpad/4 word compares, all on the CUDA cores, and the b tile is
// re-read from L2 by each of a tile's row slices. The tensor-core
// formulation (one-hot int8 products) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSubM = 64;  // a rows per block

enum ScoreMode { kOne = 0, kProduct = 1, kMin = 2, kMax = 3, kSum = 4 };

__device__ __forceinline__ long long pair_score(int mode, long long ca,
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

// first index in keys[0, n) whose value is >= k (keys ascending)
__device__ __forceinline__ int lower_bound(const uint32_t* keys, int n,
                                           uint32_t k) {
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

__global__ void __launch_bounds__(kThreads) dense_match_kernel(
    const uint32_t* __restrict__ a_res, const int32_t* __restrict__ a_key,
    const int32_t* __restrict__ a_rep, const int32_t* __restrict__ a_cnt,
    const uint32_t* __restrict__ b_res, const int32_t* __restrict__ b_key,
    const int32_t* __restrict__ b_rep, const int32_t* __restrict__ b_cnt,
    const int32_t* __restrict__ work, int npad_a, int npad_b, int tile_m,
    int tile_n, int nw, int differences, int mode, int r2p,
    unsigned long long* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint32_t* b_words = smem;                    // [nw][tile_n]
  uint32_t* b_keys = b_words + nw * tile_n;    // [tile_n]
  int32_t* b_reps = reinterpret_cast<int32_t*>(b_keys + tile_n);
  int32_t* b_cnts = b_reps + tile_n;
  uint32_t* a_words = reinterpret_cast<uint32_t*>(b_cnts + tile_n);

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
    b_words[w * tile_n + row] = b_res[static_cast<size_t>(b0 + row) * nw + w];
  }
  for (int j = threadIdx.x; j < nb; j += kThreads) {
    b_keys[j] = static_cast<uint32_t>(b_key[b0 + j]);
    b_reps[j] = b_rep[b0 + j];
    b_cnts[j] = b_cnt[b0 + j];
  }
  for (int i = threadIdx.x; i < m * nw; i += kThreads) {
    a_words[i] = a_res[static_cast<size_t>(a0) * nw + i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < m; r += kWarps) {
    const int ra = a0 + r;
    const int rep_a = a_rep[ra];
    if (rep_a < 0) continue;  // pad row
    // real keys are < 2^31, so key + 1 cannot wrap
    const uint32_t key = static_cast<uint32_t>(a_key[ra]);
    const int lo = lower_bound(b_keys, nb, key);
    const int hi = lower_bound(b_keys, nb, key + 1u);
    const long long ca = a_cnt[ra];
    const uint32_t* aw = a_words + r * nw;
    for (int j = lo + lane; j < hi; j += 32) {
      int diff_bits = 0;
      for (int w = 0; w < nw; ++w) {
        diff_bits += __popc(__vcmpne4(aw[w], b_words[w * tile_n + j]));
      }
      const int rep_b = b_reps[j];
      if ((diff_bits >> 3) <= differences && rep_b >= 0) {
        atomicAdd(out + static_cast<size_t>(rep_a) * r2p + rep_b,
                  static_cast<unsigned long long>(
                      pair_score(mode, ca, b_cnts[j])));
      }
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
int dense_match_smem_bytes(int tile_n, int lpad) {
  const int nw = lpad / 4;
  return (nw * tile_n + 3 * tile_n + kSubM * nw) * 4;
}

// Launch on `stream` over n_tiles worklist tiles (work: int32 [n_tiles, 2]
// element starts). Residue rows are int8 [npad, lpad] with lpad a multiple
// of 4; key/rep/cnt rows are int32 [npad]; out is int64 [r1p, r2p], zeroed
// by the caller. Returns the cudaError_t of the launch (0 on success).
int dense_match_launch(const void* a_res, const void* a_key, const void* a_rep,
                       const void* a_cnt, const void* b_res, const void* b_key,
                       const void* b_rep, const void* b_cnt, const void* work,
                       int n_tiles, int npad_a, int npad_b, int tile_m,
                       int tile_n, int lpad, int differences, int mode,
                       int r2p, void* out, void* stream) {
  if (n_tiles <= 0) return 0;
  if (lpad <= 0 || lpad % 4 != 0 || tile_m <= 0 || tile_n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = dense_match_smem_bytes(tile_n, lpad);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>((tile_m + kSubM - 1) / kSubM));
  dense_match_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a_res), static_cast<const int32_t*>(a_key),
      static_cast<const int32_t*>(a_rep), static_cast<const int32_t*>(a_cnt),
      static_cast<const uint32_t*>(b_res), static_cast<const int32_t*>(b_key),
      static_cast<const int32_t*>(b_rep), static_cast<const int32_t*>(b_cnt),
      static_cast<const int32_t*>(work), npad_a, npad_b, tile_m, tile_n,
      lpad / 4, differences, mode, r2p,
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* dense_match_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
