// tile_match: the sparse tile route's two kernels, hand-written for Hopper.
//
//   count_tiles    replaces the count Pallas kernel of the JAX package,
//                  compairr_tpu/ops/pallas_kernels.py:1513
//                  (_make_count_kernel / _count_pallas_fn :1559 /
//                  count_tiles_pallas :1997): one int32 match count per
//                  worklist tile.
//   extract_tiles  replaces the extract Pallas kernel, pallas_kernels.py:1683
//                  (_make_extract_kernel / _extract_pallas_fn :1753 /
//                  extract_tiles_pallas :1907), with the XLA compaction
//                  epilogue of its `run` (:1878-1902): every tile's match
//                  mask packed 32 columns to a uint32 word, and the nonzero
//                  words appended as (word_idx, word_bits) records, where
//                  word_idx = tile * TM * (TN/32) + row * (TN/32) + word, the
//                  JAX package's flat index.
//
// Both test a pair with the function of _cached_key_match
// (pallas_kernels.py:229-320), written once below (pair_match):
//   * Hamming match: equal keys and lpad - (equal residues) <= d, pad
//     residues matching themselves;
//   * indel match: keys differing by exactly 1 and prefix + suffix >=
//     min(len_a, len_b), the common prefix of the forward rows and of the
//     reversed rows (reversed within the length, pads after), the lengths
//     taken from key & 0xFFFF. The key test comes first: on pad rows those
//     bits are garbage, and only the key test keeps a pad out;
//   * with exclude_self, a pair whose two original indices are equal is
//     dropped (pads carry -1, so the pad twins of a self-comparison, whose
//     keys are equal, are dropped here).
// The tile class picks the tests: 0 Hamming only, 1 Hamming and indel,
// 2 indel only (the worklist classifier proved no equal-key pair there).
//
// The key row is int32 when every real key is below 2^29 (pads in the
// salted band 2^29 + 2 + salt + 4i, as JAX's key32 row) and int64 above
// (pads at 2^62 + 2 + salt + 4i): one key row throughout, in place of the
// JAX package's len/v/j rows for keys >= 2^29 (_match_tile_pallas :323).
// Equal keys mean equal (V, J, length) and keys 1 apart mean the same V
// and J with lengths 1 apart, the tests that path makes with three rows.
//
// The TPU computes the common prefix with weighted bf16 one-hot matmuls
// read out of an f32 exponent (_first_mismatch_bw, _band_weight_row) and
// packs bits with two f32 matmuls; neither is carried over. Here the first
// mismatching byte comes from __vcmpne4 on 4-byte words and __ffs, exact
// for any lpad (a multiple of 4), and a warp's __ballot_sync over 32
// columns is the packed word. No float touches a count.
//
// Design: one block per worklist tile; the tile's b columns staged in
// shared memory in chunks of 128 (residue words transposed to
// [word][column] with a stride of 129, so that both the staging writes and
// the lanes' reads avoid bank conflicts, plus reversed words on indel
// tiles, keys, and original indices when exclude_self reads them); one
// warp per a row, whose words it copies into its own shared buffer, each
// lane one column of a 32-column word. Counts are summed across the block
// in shared memory; records are appended with one atomicAdd per nonzero
// word on a device counter, so they come back in no fixed order.
//
// Bound on this card: the key test per visited pair, lpad/4 word compares
// per equal-key pair and up to 2 lpad/4 per key-distance-1 pair, all
// integer work on the CUDA cores, with each a row read by every warp from
// L1/L2 once per 128-column chunk. Most visited pairs fail the key test, so
// the kernels are bound by instruction throughput and latency per visited
// pair, not by device memory; the bytes they must move (each touched row
// once) take far less time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;            // b columns staged at a time
constexpr int kStride = kChunk + 1;    // shared row stride of staged words

enum TileClass { kHamming = 0, kBoth = 1, kIndelOnly = 2 };

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

// the match criterion of one pair (see the header)
template <typename Key>
__device__ __forceinline__ bool pair_match(const uint32_t* aw,
                                           const uint32_t* arw,
                                           const uint32_t* bw,
                                           const uint32_t* brw, int nw,
                                           Key ka, Key kb, int cls,
                                           int differences) {
  if (cls != kIndelOnly && ka == kb) {
    int diff_bits = 0;
    for (int w = 0; w < nw; ++w) {
      diff_bits += __popc(__vcmpne4(aw[w], bw[w * kStride]));
    }
    return (diff_bits >> 3) <= differences;
  }
  if (cls != kHamming) {
    const Key dk = ka - kb;
    if (dk == 1 || dk == -1) {
      const int la = static_cast<int>(ka & 0xFFFF);
      const int lb = static_cast<int>(kb & 0xFFFF);
      const int pre = first_mismatch(aw, bw, kStride, nw);
      const int suf = first_mismatch(arw, brw, kStride, nw);
      return pre + suf >= min(la, lb);
    }
  }
  return false;
}

template <typename Key, bool kExtract>
__global__ void __launch_bounds__(kThreads) tile_match_kernel(
    const uint32_t* __restrict__ a_seq, const uint32_t* __restrict__ a_rseq,
    const Key* __restrict__ a_key, const int32_t* __restrict__ a_orig,
    const uint32_t* __restrict__ b_seq, const uint32_t* __restrict__ b_rseq,
    const Key* __restrict__ b_key, const int32_t* __restrict__ b_orig,
    const int32_t* __restrict__ work, int npad_a, int npad_b, int tile_m,
    int tile_n, int nw, int differences, int cls, int exclude_self,
    int32_t* __restrict__ counts, int k, int32_t* __restrict__ word_idx,
    uint32_t* __restrict__ word_bits, int32_t* __restrict__ counter) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key* s_key = reinterpret_cast<Key*>(smem);                  // [kChunk]
  int32_t* s_orig = reinterpret_cast<int32_t*>(s_key + kChunk);  // [kChunk]
  uint32_t* s_fwd = reinterpret_cast<uint32_t*>(s_orig + kChunk);
  const bool indels = cls != kHamming;
  uint32_t* s_rev = s_fwd + nw * kStride;                     // [nw][kStride]
  uint32_t* s_arow = s_rev + (indels ? nw * kStride : 0);     // [kWarps][2nw]
  __shared__ int s_total;

  const int t = blockIdx.x;
  const int a0 = work[2 * t];
  const int b0 = work[2 * t + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* aw = s_arow + warp * 2 * nw;
  uint32_t* arw = aw + nw;
  const int m = (a0 < 0 || b0 < 0) ? 0 : min(tile_m, npad_a - a0);
  const int n = (a0 < 0 || b0 < 0) ? 0 : min(tile_n, npad_b - b0);
  const int wpr = tile_n >> 5;
  if (threadIdx.x == 0) s_total = 0;
  int warp_total = 0;

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int nc = min(kChunk, n - c0);
    __syncthreads();  // the previous chunk's reads are done
    for (int i = threadIdx.x; i < nc * nw; i += kThreads) {
      const int col = i / nw;
      const int w = i - col * nw;
      const size_t src = static_cast<size_t>(b0 + c0 + col) * nw + w;
      s_fwd[w * kStride + col] = b_seq[src];
      if (indels) s_rev[w * kStride + col] = b_rseq[src];
    }
    for (int j = threadIdx.x; j < nc; j += kThreads) {
      s_key[j] = b_key[b0 + c0 + j];
      if (exclude_self) s_orig[j] = b_orig[b0 + c0 + j];
    }
    __syncthreads();

    for (int r = warp; r < m; r += kWarps) {
      const int ra = a0 + r;
      for (int w = lane; w < nw; w += 32) {
        aw[w] = a_seq[static_cast<size_t>(ra) * nw + w];
        if (indels) arw[w] = a_rseq[static_cast<size_t>(ra) * nw + w];
      }
      __syncwarp();
      const Key ka = a_key[ra];
      const int oa = exclude_self ? a_orig[ra] : 0;
      for (int g = 0; g < nc; g += 32) {
        const int j = g + lane;
        bool hit = false;
        if (j < nc) {
          hit = pair_match<Key>(aw, arw, s_fwd + j, s_rev + j, nw, ka,
                                s_key[j], cls, differences);
          if (exclude_self && oa == s_orig[j]) hit = false;
        }
        const unsigned bits = __ballot_sync(0xffffffffu, hit);
        if (lane == 0 && bits) {
          if (kExtract) {
            const int pos = atomicAdd(counter, 1);
            if (pos < k) {
              word_idx[pos] = (t * tile_m + r) * wpr + ((c0 + g) >> 5);
              word_bits[pos] = bits;
            }
          } else {
            warp_total += __popc(bits);
          }
        }
      }
      __syncwarp();  // the row buffer is rewritten for the next row
    }
  }
  if (!kExtract) {
    if (lane == 0 && warp_total) atomicAdd(&s_total, warp_total);
    __syncthreads();
    if (threadIdx.x == 0) counts[t] = s_total;
  }
}

int smem_bytes(int lpad, int cls, int key_bytes) {
  const int nw = lpad / 4;
  const int planes = cls == kHamming ? 1 : 2;
  return kChunk * (key_bytes + 4) + planes * nw * kStride * 4 +
         kWarps * 2 * nw * 4;
}

template <typename Key, bool kExtract>
int launch(const void* a_seq, const void* a_rseq, const void* a_key,
           const void* a_orig, const void* b_seq, const void* b_rseq,
           const void* b_key, const void* b_orig, const void* work,
           int n_tiles, int npad_a, int npad_b, int tile_m, int tile_n,
           int lpad, int differences, int cls, int exclude_self,
           void* counts, int k, void* word_idx, void* word_bits,
           void* counter, void* stream) {
  if (n_tiles <= 0) return 0;
  if (lpad <= 0 || lpad % 4 != 0 || tile_m <= 0 || tile_n <= 0 ||
      tile_n % 32 != 0 || cls < kHamming || cls > kIndelOnly) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(lpad, cls, static_cast<int>(sizeof(Key)));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_match_kernel<Key, kExtract>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tile_match_kernel<Key, kExtract>
      <<<n_tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(a_seq),
          static_cast<const uint32_t*>(a_rseq), static_cast<const Key*>(a_key),
          static_cast<const int32_t*>(a_orig),
          static_cast<const uint32_t*>(b_seq),
          static_cast<const uint32_t*>(b_rseq), static_cast<const Key*>(b_key),
          static_cast<const int32_t*>(b_orig),
          static_cast<const int32_t*>(work), npad_a, npad_b, tile_m, tile_n,
          lpad / 4, differences, cls, exclude_self,
          static_cast<int32_t*>(counts), k, static_cast<int32_t*>(word_idx),
          static_cast<uint32_t*>(word_bits), static_cast<int32_t*>(counter));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (tile class cls, key_bytes 4 for
// an int32 key row and 8 for an int64 one).
int tile_match_smem_bytes(int lpad, int cls, int key_bytes) {
  return smem_bytes(lpad, cls, key_bytes);
}

// Per-tile match counts into counts (int32 [n_tiles], written in full) on
// `stream`. Residue rows are int8 [npad, lpad] with lpad a multiple of 4
// (reversed rows only read on classes 1 and 2); keys int32 or int64
// (key_bytes 4 or 8) and original indices int32, each [npad]; work int32
// [n_tiles, 2] element starts. Returns the launch's cudaError_t.
int count_tiles_launch(const void* a_seq, const void* a_rseq,
                       const void* a_key, const void* a_orig,
                       const void* b_seq, const void* b_rseq,
                       const void* b_key, const void* b_orig,
                       const void* work, int n_tiles, int npad_a,
                       int npad_b, int tile_m, int tile_n, int lpad,
                       int differences, int cls, int exclude_self,
                       int key_bytes, void* counts, void* stream) {
  const auto fn = key_bytes == 8 ? launch<int64_t, false>
                                 : launch<int32_t, false>;
  return fn(a_seq, a_rseq, a_key, a_orig, b_seq, b_rseq, b_key, b_orig, work,
            n_tiles, npad_a, npad_b, tile_m, tile_n, lpad, differences, cls,
            exclude_self, counts, 0, nullptr, nullptr, nullptr, stream);
}

// Packed match words of the worklist tiles: each nonzero word appended at
// atomicAdd(counter, 1) into word_idx (int32 [k]) and word_bits (uint32
// [k]) while the slot is below k. counter (int32, zeroed by the caller)
// ends as the number of nonzero words, which may exceed k: the caller
// checks. Other arguments as count_tiles_launch.
int extract_tiles_launch(const void* a_seq, const void* a_rseq,
                         const void* a_key, const void* a_orig,
                         const void* b_seq, const void* b_rseq,
                         const void* b_key, const void* b_orig,
                         const void* work, int n_tiles, int npad_a,
                         int npad_b, int tile_m, int tile_n, int lpad,
                         int differences, int cls, int exclude_self,
                         int key_bytes, int k, void* word_idx,
                         void* word_bits, void* counter, void* stream) {
  const auto fn = key_bytes == 8 ? launch<int64_t, true>
                                 : launch<int32_t, true>;
  return fn(a_seq, a_rseq, a_key, a_orig, b_seq, b_rseq, b_key, b_orig, work,
            n_tiles, npad_a, npad_b, tile_m, tile_n, lpad, differences, cls,
            exclude_self, nullptr, k, word_idx, word_bits, counter, stream);
}

const char* tile_match_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
