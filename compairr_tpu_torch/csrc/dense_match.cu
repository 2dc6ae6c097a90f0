// dense_match: the dense overlap-matrix reduction, hand-written for Hopper.
//
// Replaces the v3 dense Pallas kernel of the JAX package,
// compairr_tpu/ops/pallas_kernels.py:970 (_make_dense_v3_kernel; its
// wrapper _dense_v3_fn at :1091), which computes, over a worklist of
// (row block, column block) tiles of the two key-sorted sets,
//
//   out[rep_a[i], rep_b[j]] += score(cnt_a[i], cnt_b[j])
//
// for every pair with key_a[i] == key_b[j], rep >= 0 on both sides and
// at most `differences` differing residues over the padded width (pad
// residues match themselves, so equal-length Hamming distance is the
// count of differing positions).
//
// What it computes is v3's function; how it computes it is not v3's.
// The TPU kernel counts position matches with an int8 one-hot matmul
// on the MXU and folds scores through bilinear chains with host-planned
// flushes; none of that is carried over. Here:
//   * residues are bit planes (kernels.residue_planes): for each
//     32-position chunk c and bit q, one word whose bit p is bit q of
//     the residue at position 32 c + p, P = 5 planes for amino acids
//     and 3 for nucleotides. Two rows differ at a position exactly
//     where some plane differs, so the mismatch mask of a chunk is
//     OR_q (A_q ^ B_q) (one LOP3 a plane) and the Hamming distance is
//     the sum of its popcounts. Positions past lpad are 0 on both sides;
//   * one block per worklist tile. It stages the b tile's planes as
//     [c][q][row] (lanes on consecutive b columns read consecutive
//     words), its keys, and the a tile's planes in shared memory;
//   * work split by equal-key runs: both tiles' rows are key-sorted
//     (pads, key -1, last as unsigned), so the tile's pair space is a
//     union of rectangles, one for each key present on both sides. Each
//     a row that starts a run binary-searches the run's b range once;
//     the pad run is skipped. Each rectangle is cut into units of
//     unit_rows() a rows (8 at C P = 5) by the run's whole b range,
//     dealt to the warps round-robin in run order. A unit keeps its a
//     rows' planes in registers, loaded once for the whole range; each
//     lane reads one b column's C P words (32 consecutive columns a
//     step) and tests them against all of the unit's rows. Above C = 4
//     (lpad > 128) or for a P other than 3 or 5 the same loop runs over
//     runtime C and P, with the a planes read from shared memory;
//   * 128 threads a block: small tiles (the CLI's 128) spend more on
//     staging and the run setup than on pairs, and more, smaller blocks
//     an SM overlap those stalls;
//   * a surviving pair adds its score with a 64-bit integer atomicAdd.
//     Matches are rare, so the cells are not staged. Integer sums are
//     exact in any order; mean accumulates cnt_a + cnt_b and the caller
//     halves once.
//
// Bounds on the card, for the work of a call (bench.dense_bound): the
// function's bound is its bytes (each row a tile covers read once, the
// matrix written once) over 3.35 TB/s, or, where equal-key pairs are
// many (-g, keys by length alone), its int8 operations (2 a residue of
// each pair's rows) over 1,979 TOP/s. This design's own floor is on the CUDA
// cores: C (P + 2) integer operations an equal-key pair (P LOP3, one
// popcount, one compare) over 132 SMs x 64 a clock. ptxas -v (sm_90a,
// 128 threads a block): 72 registers and 16 bytes of spill stores for
// <C, P> = <1, 5>; 40 to 72 registers, 0 to 56 bytes of spills, across
// the other instantiations. None is refused for registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kPadKey = 0xFFFFFFFFu;  // key -1: pad rows, sorted last

enum ScoreMode { kOne = 0, kProduct = 1, kMin = 2, kMax = 3, kSum = 4 };

struct Args {
  const uint32_t* a_planes;  // [npad_a, C, P]
  const int32_t* a_key;
  const int32_t* a_rep;
  const int32_t* a_cnt;
  const uint32_t* b_planes;  // [npad_b, C, P]
  const int32_t* b_key;
  const int32_t* b_rep;
  const int32_t* b_cnt;
  const int32_t* work;  // [n_tiles, 2] element starts
  int npad_a, npad_b, tile_m, tile_n, n_chunks, n_planes;
  int differences, mode, r2p;
  unsigned long long* out;  // [r1p, r2p]
};

// a rows a unit holds in registers: about 40 plane words, 1 to 8 rows
// (4 in the runtime-C loop, whose planes stay in shared memory)
template <int CT, int PT>
__host__ __device__ constexpr int unit_rows() {
  if (CT * PT == 0) return 4;
  const int r = 40 / (CT * PT > 0 ? CT * PT : 1);
  return r < 1 ? 1 : (r > 8 ? 8 : r);
}

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

// first index in keys[0, n) whose value is > k (upper) or >= k (not
// upper); keys ascending
template <bool kUpper>
__device__ __forceinline__ int bound_of(const uint32_t* keys, int n,
                                        uint32_t k) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kUpper ? keys[mid] <= k : keys[mid] < k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// the pairs of b column j (tile-relative) against the unit's rows whose
// distance diff[r] passed: rows row0 .. row0 + nrows - 1 only, with rep
// >= 0 on both sides, add their scores (R unrolled: diff stays in
// registers)
template <int R>
__device__ __forceinline__ void emit(const Args& p, int a0, int b0,
                                     int row0, int nrows, int j,
                                     const int (&diff)[R]) {
  const int rep_b = p.b_rep[b0 + j];
  if (rep_b < 0) return;
  const long long cb = p.b_cnt[b0 + j];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= nrows || diff[r] > p.differences) continue;
    const int ra = a0 + row0 + r;
    const int rep_a = p.a_rep[ra];
    if (rep_a < 0) continue;
    atomicAdd(p.out + static_cast<size_t>(rep_a) * p.r2p + rep_b,
              static_cast<unsigned long long>(
                  pair_score(p.mode, p.a_cnt[ra], cb)));
  }
}

// One unit: a rows row0 .. row0 + nrows - 1 (tile-relative, nrows <=
// kRows) against b columns lo .. hi - 1, the lane taking every 32nd
// column. Rows past nrows repeat the last row; emit drops them.
template <int CT, int PT>
__device__ __forceinline__ void run_unit(const Args& p, const uint32_t* a_pl,
                                         const uint32_t* b_pl, int a0, int b0,
                                         int row0, int nrows, int lo, int hi,
                                         int lane) {
  constexpr int R = unit_rows<CT, PT>();
  const int d = p.differences;
  if constexpr (CT > 0) {
    constexpr int kCP = CT * PT;
    uint32_t a[R][kCP];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t* src = a_pl + (row0 + min(r, nrows - 1)) * kCP;
#pragma unroll
      for (int k = 0; k < kCP; ++k) a[r][k] = src[k];
    }
    for (int j = lo + lane; j < hi; j += 32) {
      uint32_t b[kCP];
#pragma unroll
      for (int k = 0; k < kCP; ++k) b[k] = b_pl[k * p.tile_n + j];
      int diff[R];
      bool any = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int n = 0;
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          uint32_t m = a[r][c * PT] ^ b[c * PT];
#pragma unroll
          for (int q = 1; q < PT; ++q) m |= a[r][c * PT + q] ^ b[c * PT + q];
          n += __popc(m);
        }
        diff[r] = n;
        any |= n <= d;
      }
      if (any) emit<R>(p, a0, b0, row0, nrows, j, diff);
    }
  } else {
    const int C = p.n_chunks, P = p.n_planes, cp = C * P;
    for (int j = lo + lane; j < hi; j += 32) {
      int diff[R];
      bool any = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t* ar = a_pl + (row0 + min(r, nrows - 1)) * cp;
        int n = 0;
        for (int c = 0; c < C; ++c) {
          uint32_t m = 0;
          for (int q = 0; q < P; ++q) {
            const int k = c * P + q;
            m |= ar[k] ^ b_pl[k * p.tile_n + j];
          }
          n += __popc(m);
        }
        diff[r] = n;
        any |= n <= d;
      }
      if (any) emit<R>(p, a0, b0, row0, nrows, j, diff);
    }
  }
}

template <int CT, int PT>
__global__ void __launch_bounds__(kThreads) dense_match_kernel(const Args p) {
  extern __shared__ uint32_t smem[];
  constexpr int R = unit_rows<CT, PT>();
  const int cp = CT > 0 ? CT * PT : p.n_chunks * p.n_planes;
  const int tile_m = p.tile_m, tile_n = p.tile_n;
  uint32_t* b_pl = smem;                      // [cp][tile_n]
  uint32_t* b_keys = b_pl + cp * tile_n;      // [tile_n]
  uint32_t* a_pl = b_keys + tile_n;           // [tile_m][cp]
  int* run_lo = reinterpret_cast<int*>(a_pl + cp * tile_m);  // [tile_m]
  int* run_hi = run_lo + tile_m;                             // [tile_m]
  uint32_t* starts = reinterpret_cast<uint32_t*>(run_hi + tile_m);

  const int a0 = p.work[2 * blockIdx.x];
  const int b0 = p.work[2 * blockIdx.x + 1];
  // block-uniform exits, before any barrier: invalid or ragged tiles
  if (a0 < 0 || b0 < 0 || a0 >= p.npad_a || b0 >= p.npad_b) return;
  const int m = min(tile_m, p.npad_a - a0);
  const int nb = min(tile_n, p.npad_b - b0);

  const uint32_t* b_src = p.b_planes + static_cast<size_t>(b0) * cp;
  for (int i = threadIdx.x; i < nb * cp; i += kThreads) {
    const int row = i / cp;
    b_pl[(i - row * cp) * tile_n + row] = b_src[i];
  }
  for (int j = threadIdx.x; j < nb; j += kThreads) {
    b_keys[j] = static_cast<uint32_t>(p.b_key[b0 + j]);
  }
  const uint32_t* a_src = p.a_planes + static_cast<size_t>(a0) * cp;
  for (int i = threadIdx.x; i < m * cp; i += kThreads) a_pl[i] = a_src[i];
  __syncthreads();

  // The runs of equal a keys: bit i % 32 of starts[i / 32] marks an a
  // row whose key differs from the row before it. That row holds its
  // run's range [run_lo, run_hi) of b rows with the same key (empty for
  // the pad key and for a key the b tile lacks).
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_words = (m + 31) >> 5;
  for (int base = warp * 32; base < n_words * 32; base += kThreads) {
    const int i = base + lane;
    bool start = false;
    if (i < m) {
      const uint32_t key = static_cast<uint32_t>(p.a_key[a0 + i]);
      start = i == 0 || key != static_cast<uint32_t>(p.a_key[a0 + i - 1]);
      if (start) {
        const bool pad = key == kPadKey;
        run_lo[i] = pad ? 0 : bound_of<false>(b_keys, nb, key);
        run_hi[i] = pad ? 0 : bound_of<true>(b_keys, nb, key);
      }
    }
    const unsigned bits = __ballot_sync(0xFFFFFFFFu, start);
    if (lane == 0) starts[base >> 5] = bits;
  }
  __syncthreads();

  // Deal each run's units (kRows a rows each) to the warps round-robin,
  // in run order; every warp walks the same runs and counts the same
  // units dealt, u, so each unit goes to exactly one warp.
  int u = 0;
  int cur = -1;  // first row of the open run
  auto deal = [&](int rs, int re) {
    const int lo = run_lo[rs], hi = run_hi[rs];
    if (lo >= hi) return;
    const int n_units = (re - rs + R - 1) / R;
    for (int g = (warp - u) & (kWarps - 1); g < n_units; g += kWarps) {
      const int row0 = rs + g * R;
      run_unit<CT, PT>(p, a_pl, b_pl, a0, b0, row0, min(R, re - row0), lo,
                       hi, lane);
    }
    u += n_units;
  };
  for (int w = 0; w < n_words; ++w) {
    uint32_t bits = starts[w];
    while (bits) {
      const int i = (w << 5) + __ffs(bits) - 1;
      bits &= bits - 1;
      if (cur >= 0) deal(cur, i);
      cur = i;
    }
  }
  deal(cur, m);  // row 0 always starts a run, so cur >= 0
}

int smem_words(int tile_m, int tile_n, int n_chunks, int n_planes) {
  const int cp = n_chunks * n_planes;
  return cp * tile_n + tile_n + cp * tile_m + 2 * tile_m + (tile_m + 31) / 32;
}

template <int CT, int PT>
int launch(const Args& p, int n_tiles, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_match_kernel<CT, PT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dense_match_kernel<CT, PT><<<static_cast<unsigned>(n_tiles), kThreads,
                               smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
int dense_match_smem_bytes(int tile_m, int tile_n, int n_chunks,
                           int n_planes) {
  return 4 * smem_words(tile_m, tile_n, n_chunks, n_planes);
}

// Launch on `stream` over n_tiles worklist tiles (work: int32 [n_tiles, 2]
// element starts). Plane rows are int32 [npad, n_chunks, n_planes]
// (kernels.residue_planes); key/rep/cnt rows are int32 [npad]; out is
// int64 [r1p, r2p], zeroed by the caller. Returns the cudaError_t of the
// launch (0 on success).
int dense_match_launch(const void* a_planes, const void* a_key,
                       const void* a_rep, const void* a_cnt,
                       const void* b_planes, const void* b_key,
                       const void* b_rep, const void* b_cnt, const void* work,
                       int n_tiles, int npad_a, int npad_b, int tile_m,
                       int tile_n, int n_chunks, int n_planes,
                       int differences, int mode, int r2p, void* out,
                       void* stream) {
  if (n_tiles <= 0) return 0;
  if (tile_m <= 0 || tile_n <= 0 || n_chunks <= 0 || n_planes <= 0 ||
      n_planes > 5) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args p = {
      static_cast<const uint32_t*>(a_planes),
      static_cast<const int32_t*>(a_key),
      static_cast<const int32_t*>(a_rep),
      static_cast<const int32_t*>(a_cnt),
      static_cast<const uint32_t*>(b_planes),
      static_cast<const int32_t*>(b_key),
      static_cast<const int32_t*>(b_rep),
      static_cast<const int32_t*>(b_cnt),
      static_cast<const int32_t*>(work),
      npad_a, npad_b, tile_m, tile_n, n_chunks, n_planes,
      differences, mode, r2p,
      static_cast<unsigned long long*>(out)};
  const int smem = dense_match_smem_bytes(tile_m, tile_n, n_chunks, n_planes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_planes == 5) {
    switch (n_chunks) {
      case 1: return launch<1, 5>(p, n_tiles, smem, st);
      case 2: return launch<2, 5>(p, n_tiles, smem, st);
      case 3: return launch<3, 5>(p, n_tiles, smem, st);
      case 4: return launch<4, 5>(p, n_tiles, smem, st);
      default: break;
    }
  } else if (n_planes == 3) {
    switch (n_chunks) {
      case 1: return launch<1, 3>(p, n_tiles, smem, st);
      case 2: return launch<2, 3>(p, n_tiles, smem, st);
      case 3: return launch<3, 3>(p, n_tiles, smem, st);
      case 4: return launch<4, 3>(p, n_tiles, smem, st);
      default: break;
    }
  }
  return launch<0, 0>(p, n_tiles, smem, st);
}

const char* dense_match_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
