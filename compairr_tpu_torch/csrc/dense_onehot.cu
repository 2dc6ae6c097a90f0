// dense_onehot: the dense overlap-matrix reduction as an int8 one-hot
// product on the tensor cores, hand-written for Hopper.
//
// Replaces the v2 dense Pallas kernel of the JAX package,
// compairr_tpu/ops/pallas_kernels.py:793 (_make_dense_v2_kernel) /
// :882 (_dense_v2_fn). It computes dense_match's function (v3's, the
// same as v2's): over a worklist of (row block, column block) tiles of
// the two key-sorted sets,
//
//   out[rep_a[i], rep_b[j]] += score(cnt_a[i], cnt_b[j])
//
// for every pair with key_a[i] == key_b[j], rep >= 0 on both sides and
// lpad - matches <= differences, where matches counts the positions with
// equal residue codes, pads included (the pad residue matches itself).
//
// Its design is v2's: the position matches of a whole tile are one int8
// product of one-hot rows, feature (class c, position p) at lane
// c * lpad + p for the 21 residue classes (pallas_kernels.py:2140),
// K = 21 * lpad lanes rounded up to a multiple of 32 with zero lanes
// past 21 * lpad. Here:
//   * one block per (worklist tile, 64-row slice of its a rows), 8 warps;
//   * the one-hots are built in shared memory from the int8 residue rows
//     (one 32-bit word of four residues against each class, __vcmpeq4),
//     never in device memory: the a slice once, the b tile in chunks of
//     128 columns, and K in chunks of 512 lanes, so any lpad fits;
//   * matches are counted with mma.sync.m16n8k32 s8 x s8 -> s32 (exact:
//     matches <= lpad); each warp holds a 32 x 32 block of the slice x
//     chunk product in registers;
//   * the epilogue reads each accumulator's (row, col), applies the key,
//     rep and distance mask, and adds the pair's score to its int64 cell
//     with a 64-bit atomicAdd, as dense_match does. Mean sums
//     cnt_a + cnt_b and the caller halves once.
// v2's chain decomposition, flush flags and f32 exactness guard
// (_v2_chains, _flush_flags, _v2_run_cap, _chain_flush) are machinery
// for a chip without scatter-add and are not carried over.
//
// Bound on this card. The function's bound is dense_match's, by bytes:
// the rows a tile covers read once, the matrix written once. This
// formulation does 2 * tile_m * tile_n * K int8 tensor-core operations
// for every tile whatever its keys, so its own floor is that count over
// the int8 peak, far above the bytes: it pays where equal-key runs are
// long (-g, single-bucket data), where dense_match's per-pair compares
// grow with the run, and loses where keys are diverse. Within the
// formulation, each k-step of a warp reads 2 KB of fragments from
// shared memory for 8 mma, and two barriers a chunk serialise the
// one-hot build, the products and the epilogue: shared-memory traffic
// and those stalls, not the tensor cores, set the pace. Residue codes
// at or above 21 would match no class; the wrapper rejects them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSubM = 64;       // a rows per block
constexpr int kChunkN = 128;    // b columns per chunk
constexpr int kChunkK = 512;    // one-hot lanes (bytes) per K chunk
constexpr int kClasses = 21;    // residue classes: aa 0..19 / nt 0..3 + pad
constexpr int kRowPadWords = 4; // row stride padding: conflict-free fragments

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

// K lanes of an lpad-wide one-hot row: 21 * lpad rounded up to 32
__host__ __device__ __forceinline__ int onehot_width(int lpad) {
  return (kClasses * lpad + 31) / 32 * 32;
}

// One-hot words [k0, k0 + kw) of `rows` rows into dst (row stride sw
// words): word w of a row is lanes 4w..4w+3, one class c and four
// consecutive positions (lpad % 4 == 0), 0x01 where the residue is c.
// Rows at or past `valid` read no residues (their rep is -1).
__device__ __forceinline__ void build_onehot(uint32_t* dst, int sw,
                                             const uint32_t* __restrict__ res,
                                             int rows, int valid, int nwp,
                                             int k0, int kw) {
  for (int i = threadIdx.x; i < rows * nwp; i += kThreads) {
    const int row = i / nwp;
    const int pw = i - row * nwp;
    const uint32_t r = row < valid ? res[static_cast<size_t>(row) * nwp + pw]
                                   : 0u;
    for (int c = 0; c < kClasses; ++c) {
      const int w = c * nwp + pw;
      if (w >= k0 && w < k0 + kw) {
        dst[row * sw + w - k0] =
            __vcmpeq4(r, 0x01010101u * static_cast<uint32_t>(c)) & 0x01010101u;
      }
    }
  }
  // zero lanes past 21 * lpad
  const int tail0 = max(kClasses * nwp, k0);
  const int tail = k0 + kw - tail0;
  for (int i = threadIdx.x; i < rows * max(tail, 0); i += kThreads) {
    const int row = i / tail;
    dst[row * sw + tail0 - k0 + (i - row * tail)] = 0u;
  }
}

__device__ __forceinline__ void mma_s8(int* acc, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads, 2) dense_onehot_kernel(
    const uint32_t* __restrict__ a_res, const int32_t* __restrict__ a_key,
    const int32_t* __restrict__ a_rep, const int32_t* __restrict__ a_cnt,
    const uint32_t* __restrict__ b_res, const int32_t* __restrict__ b_key,
    const int32_t* __restrict__ b_rep, const int32_t* __restrict__ b_cnt,
    const int32_t* __restrict__ work, int npad_a, int npad_b, int tile_m,
    int tile_n, int lpad, int differences, int mode, int r2p,
    unsigned long long* __restrict__ out) {
  const int nwp = lpad / 4;                     // residue words a row
  const int kwords = onehot_width(lpad) / 4;    // one-hot words a row
  const int kcw = min(kwords, kChunkK / 4);     // words a K chunk
  const int nk = (kwords + kcw - 1) / kcw;
  const int sw = kcw + kRowPadWords;            // smem row stride, words

  extern __shared__ uint32_t smem[];
  uint32_t* a_oh = smem;                        // [kSubM][sw]
  uint32_t* b_oh = a_oh + kSubM * sw;           // [kChunkN][sw]
  int32_t* a_meta = reinterpret_cast<int32_t*>(b_oh + kChunkN * sw);
  int32_t* b_meta = a_meta + 3 * kSubM;         // key, rep, cnt rows

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

  for (int i = threadIdx.x; i < kSubM; i += kThreads) {
    const bool ok = i < m;
    a_meta[i] = ok ? a_key[a0 + i] : 0;
    a_meta[kSubM + i] = ok ? a_rep[a0 + i] : -1;
    a_meta[2 * kSubM + i] = ok ? a_cnt[a0 + i] : 0;
  }
  const uint32_t* a_rows = a_res + static_cast<size_t>(a0) * nwp;
  if (nk == 1) build_onehot(a_oh, sw, a_rows, kSubM, m, nwp, 0, kcw);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;       // fragment row group
  const int tq = lane & 3;       // thread in group
  const int wm = (warp >> 2) * 32;  // the warp's rows of the slice
  const int wn = (warp & 3) * 32;   // the warp's columns of the chunk

  for (int c0 = 0; c0 < nb; c0 += kChunkN) {
    const int nbc = min(kChunkN, nb - c0);
    __syncthreads();  // the last chunk's readers are done
    for (int j = threadIdx.x; j < kChunkN; j += kThreads) {
      const bool ok = j < nbc;
      b_meta[j] = ok ? b_key[b0 + c0 + j] : 0;
      b_meta[kChunkN + j] = ok ? b_rep[b0 + c0 + j] : -1;
      b_meta[2 * kChunkN + j] = ok ? b_cnt[b0 + c0 + j] : 0;
    }
    int acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

    const uint32_t* b_rows = b_res + static_cast<size_t>(b0 + c0) * nwp;
    for (int kc = 0; kc < nk; ++kc) {
      const int k0 = kc * kcw;
      const int kw = min(kcw, kwords - k0);
      if (kc) __syncthreads();  // the last K chunk's products are done
      if (nk > 1) build_onehot(a_oh, sw, a_rows, kSubM, m, nwp, k0, kw);
      build_onehot(b_oh, sw, b_rows, kChunkN, nbc, nwp, k0, kw);
      __syncthreads();
      for (int ks = 0; ks < kw; ks += 8) {  // 32 lanes a k-step
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const uint32_t* p = a_oh + (wm + mi * 16 + g) * sw + ks + tq;
          af[mi][0] = p[0];
          af[mi][1] = p[8 * sw];
          af[mi][2] = p[4];
          af[mi][3] = p[8 * sw + 4];
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const uint32_t* q = b_oh + (wn + ni * 8 + g) * sw + ks + tq;
          bf[ni][0] = q[0];
          bf[ni][1] = q[4];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
      }
    }

    // accumulator e of fragment (mi, ni): row wm + 16 mi + g + 8 (e >> 1),
    // column wn + 8 ni + 2 tq + (e & 1)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + mi * 16 + g + 8 * h;
        const int rep_a = a_meta[kSubM + r];
        if (rep_a < 0) continue;
        const int key = a_meta[r];
        const long long ca = a_meta[2 * kSubM + r];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = wn + ni * 8 + 2 * tq + e;
            const int rep_b = b_meta[kChunkN + j];
            if (rep_b >= 0 && b_meta[j] == key &&
                lpad - acc[mi][ni][2 * h + e] <= differences) {
              atomicAdd(out + static_cast<size_t>(rep_a) * r2p + rep_b,
                        static_cast<unsigned long long>(
                            pair_score(mode, ca, b_meta[2 * kChunkN + j])));
            }
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
int dense_onehot_smem_bytes(int lpad) {
  const int kwords = onehot_width(lpad) / 4;
  const int kcw = kwords < kChunkK / 4 ? kwords : kChunkK / 4;
  return ((kSubM + kChunkN) * (kcw + kRowPadWords) + 3 * (kSubM + kChunkN)) *
         4;
}

// Launch on `stream` over n_tiles worklist tiles (work: int32 [n_tiles, 2]
// element starts). Residue rows are int8 [npad, lpad] with lpad a multiple
// of 4 and every code below 21; key/rep/cnt rows are int32 [npad]; tile_m
// and tile_n are multiples of 64; out is int64 [r1p, r2p], zeroed by the
// caller. Returns the cudaError_t of the launch (0 on success).
int dense_onehot_launch(const void* a_res, const void* a_key,
                        const void* a_rep, const void* a_cnt,
                        const void* b_res, const void* b_key,
                        const void* b_rep, const void* b_cnt,
                        const void* work, int n_tiles, int npad_a, int npad_b,
                        int tile_m, int tile_n, int lpad, int differences,
                        int mode, int r2p, void* out, void* stream) {
  if (n_tiles <= 0) return 0;
  if (lpad <= 0 || lpad % 4 != 0 || tile_m <= 0 || tile_n <= 0 ||
      tile_m % kSubM != 0 || tile_n % kSubM != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = dense_onehot_smem_bytes(lpad);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>(tile_m / kSubM));
  dense_onehot_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a_res), static_cast<const int32_t*>(a_key),
      static_cast<const int32_t*>(a_rep), static_cast<const int32_t*>(a_cnt),
      static_cast<const uint32_t*>(b_res), static_cast<const int32_t*>(b_key),
      static_cast<const int32_t*>(b_rep), static_cast<const int32_t*>(b_cnt),
      static_cast<const int32_t*>(work), npad_a, npad_b, tile_m, tile_n, lpad,
      differences, mode, r2p, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* dense_onehot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
