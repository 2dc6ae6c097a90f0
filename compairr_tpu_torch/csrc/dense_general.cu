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
// Pads carry key -1 and repertoire -1 on both sides. Read as unsigned, -1
// sorts after every real key (below 2^31 in int32 rows, below 2^62 in int64
// rows), so a real row's key window [k-1, k+1] never reaches a pad; the pad
// run of the a rows is skipped, and a pair needs rep_b >= 0 as well.
//
// Sums. Integer scores (count product, min, max, sum, or 1) add to an int64
// cell with a 64-bit atomicAdd, exact in any order; mean sums cnt_a + cnt_b
// and the caller halves once. dense_general adds float64 scores with
// atomicAdd(double*), the reference's own type (CompAIRR
// src/overlap.cc:144-166), for ratio (ca / (cb == 0 ? 1 : cb)) and wherever
// the caller could not prove from per-block bounds that no cell passes 2^62.
//
// What the TPU kernels compute is kept; how is not. v2c's one-hot operands
// cached in VMEM scratch, its bilinear score chains with host-planned
// flushes and its f32 exactness guard, v1's per-tile one-hot matmuls, its
// bf16 exponent trick for the first mismatch and its f32 repertoire one-hot
// products are not carried over. Here, as in tile_match.cu's kernels:
//   * residues are bit planes (kernels.residue_planes): word [row, c, q]
//     holds bit q of the residues at positions 32 c .. 32 c + 31, P = 5
//     planes for amino acids and 3 for nucleotides, 0 past lpad. The
//     mismatch mask of a chunk is m_c = OR_q (A_q ^ B_q) (P LOP3s), the
//     Hamming distance is the sum of popc(m_c), and the first mismatch is
//     32 c + ctz(m_c) of the first nonzero chunk (32 C when none). The
//     suffix is the first mismatch of the reversed rows' planes. Both rows
//     are 0 past lpad, so a prefix past lpad means the rows agree through
//     lpad, and since every length is at most lpad the test passes with or
//     without a clamp to lpad: none is applied;
//   * one block of 128 threads per worklist tile. It stages the b tile's
//     keys (as unsigned 64-bit) and planes (and reversed planes on indel
//     runs) in shared memory, [plane word][column], and the a tile's planes,
//     row by row, in one coalesced pass. The repertoires and counts are read
//     only for a matched pair, from device memory;
//   * one key window per a run. Both tiles' rows are key-sorted (pads
//     last), so the b columns with keys in [k - delta, k + delta] form one
//     range, and its columns of key k - 1, k and k + 1 three consecutive
//     sub-ranges. Each run of equal keys among the a rows binary-searches
//     them once (delta 1 on indel runs, else 0); no key is compared per
//     pair, and no pair outside a window is visited;
//   * each run is cut into units of up to 8 a rows (unit_rows; half that on
//     indel runs below tile 512, kLongUnitTile), dealt to the warps in turn.
//     A unit holds its rows' planes in registers and walks the 32-column
//     words of its window, one b column a lane: a lane in the equal-key
//     sub-range runs the Hamming test, a lane at key distance 1 the indel
//     test. Lanes diverge only on a word that straddles a key edge and on a
//     match. Above C = 4 (lpad > 128) or for a P other than 3 or 5 the same
//     loop runs over runtime C and P, with the a planes read from device
//     memory, not staged;
//   * b planes beyond kStageBytes are staged in column chunks, multiples of
//     32 (long rows at big tiles); a unit walks its window's part of each
//     chunk.
//
// Bound on this card (bench.dense_bound): by bytes where keys are
// sparse (each touched row read once, the matrix written once), by int8
// operations under -g. This design's own floor is on the CUDA cores
// (chip_smoke.tile_floor over dense_bound's pairs): C (P + 2) integer
// operations an equal-key pair and, on indel runs, 2 C (P + 2) a
// key-distance-1 pair, over 132 SMs x 64 a clock.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kStageBytes = 64 * 1024;  // b planes staged at a time

// Indel runs on tiles shorter than this take units of half the rows: their
// registers (forward and reversed planes) then leave room for twice the
// blocks an SM, which pays where per-block setup weighs most (tile 128);
// at tile 512 and above the longer units' reuse of each staged b word pays
// more (tile_match.cu's tuning, which this rule follows).
constexpr int kLongUnitTile = 512;

enum ScoreMode {
  kOne = 0,
  kProduct = 1,
  kMin = 2,
  kMax = 3,
  kSum = 4,
  kRatio = 5
};

struct Args {
  const uint32_t* a_pl;   // [npad_a, C, P]
  const uint32_t* a_rpl;  // reversed rows' planes (indel runs)
  const void* a_key;      // int32 or int64 (wide) [npad_a]
  const int32_t* a_rep;   // [npad_a]
  const void* a_cnt;      // int32 or int64 (wide) [npad_a]
  const uint32_t* b_pl;
  const uint32_t* b_rpl;
  const void* b_key;
  const int32_t* b_rep;
  const void* b_cnt;
  const int32_t* work;  // [n_tiles, 2] element starts
  int npad_a, npad_b, tile_m, tile_n, n_chunks, n_planes;
  int differences, mode, r2p, wide, float_out, chunk;
  void* out;  // int64 or float64 (float_out) [r1p, r2p]
};

// a rows a unit holds in registers: about 40 plane words, 1 to 8 rows
// (4 in the runtime-C loop, whose a planes stay in device memory), or
// half that (at least 1) with kShort
template <int CT, int PT, bool kShort>
__host__ __device__ constexpr int unit_rows() {
  int r = 4;
  if (CT * PT > 0) {
    r = 40 / (CT * PT > 0 ? CT * PT : 1);
    r = r < 1 ? 1 : (r > 8 ? 8 : r);
  }
  return kShort && r > 1 ? r / 2 : r;
}

// a key as unsigned, so that the pads' -1 sorts after every real key
__device__ __forceinline__ unsigned long long key_at(const void* keys,
                                                     int wide, int i) {
  return wide ? static_cast<const unsigned long long*>(keys)[i]
              : static_cast<const uint32_t*>(keys)[i];
}

__device__ __forceinline__ long long cnt_at(const void* cnts, int wide,
                                            int i) {
  return wide ? static_cast<const long long*>(cnts)[i]
              : static_cast<const int32_t*>(cnts)[i];
}

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

// a matched pair (absolute rows ra, rb): its score added to its cell
__device__ __forceinline__ void add_pair(const Args& p, int ra, int rb) {
  const int rep_a = p.a_rep[ra];
  const int rep_b = p.b_rep[rb];
  if (rep_a < 0 || rep_b < 0) return;
  const long long ca = cnt_at(p.a_cnt, p.wide, ra);
  const long long cb = cnt_at(p.b_cnt, p.wide, rb);
  const size_t cell = static_cast<size_t>(rep_a) * p.r2p + rep_b;
  if (p.float_out) {
    atomicAdd(static_cast<double*>(p.out) + cell, f64_score(p.mode, ca, cb));
  } else {
    atomicAdd(static_cast<unsigned long long*>(p.out) + cell,
              static_cast<unsigned long long>(int_score(p.mode, ca, cb)));
  }
}

// first index in keys[0, n) whose value is > k (upper) or >= k (not
// upper); keys ascending
template <bool kUpper>
__device__ __forceinline__ int bound_of(const unsigned long long* keys, int n,
                                        unsigned long long k) {
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

// trailing zeros, 32 for 0
__device__ __forceinline__ int ctz(uint32_t m) { return __clz(__brev(m)); }

// Common prefix of two rows' planes (C = CT chunks of PT planes), 32 CT
// when they agree throughout. Branch-free: a chunk after the first nonzero
// mask adds nothing.
template <int CT, int PT>
__device__ __forceinline__ int prefix(const uint32_t (&a)[CT * PT],
                                      const uint32_t (&b)[CT * PT]) {
  int pre = 0;
  bool open = true;
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    uint32_t m = a[c * PT] ^ b[c * PT];
#pragma unroll
    for (int q = 1; q < PT; ++q) m |= a[c * PT + q] ^ b[c * PT + q];
    if (CT == 1) {
      pre = ctz(m);
    } else {
      pre += open ? ctz(m) : 0;
      open = open && m == 0;
    }
  }
  return pre;
}

// A unit's a rows with C and P fixed at compile time: the planes (and
// reversed planes) of R rows in registers; each test takes one b column
// from the staged planes (word k at s[k * stride + col]) and returns the
// rows that match it as bits of a mask.
template <int CT, int PT, bool kIndel, int R>
struct UnitRows {
  static constexpr int kCP = CT * PT;
  uint32_t f[R][kCP];
  uint32_t v[kIndel ? R : 1][kIndel ? kCP : 1];

  // rows f0 and v0 onwards (shared memory, C P words a row)
  __device__ __forceinline__ void load(const Args&, const uint32_t* f0,
                                       const uint32_t* v0, int nrows) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int off = min(r, nrows - 1) * kCP;
#pragma unroll
      for (int k = 0; k < kCP; ++k) {
        f[r][k] = f0[off + k];
        if constexpr (kIndel) v[r][k] = v0[off + k];
      }
    }
  }

  __device__ __forceinline__ uint32_t hamming(const uint32_t* s, int stride,
                                              int col, int d) const {
    uint32_t b[kCP];
#pragma unroll
    for (int k = 0; k < kCP; ++k) b[k] = s[k * stride + col];
    uint32_t hm = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int n = 0;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        uint32_t m = f[r][c * PT] ^ b[c * PT];
#pragma unroll
        for (int q = 1; q < PT; ++q) m |= f[r][c * PT + q] ^ b[c * PT + q];
        n += __popc(m);
      }
      hm |= static_cast<uint32_t>(n <= d) << r;
    }
    return hm;
  }

  __device__ __forceinline__ uint32_t indel(const uint32_t* sf,
                                            const uint32_t* sr, int stride,
                                            int col, int minlen) const {
    uint32_t b[kCP], br[kCP];
#pragma unroll
    for (int k = 0; k < kCP; ++k) {
      b[k] = sf[k * stride + col];
      br[k] = sr[k * stride + col];
    }
    uint32_t hm = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int pre = prefix<CT, PT>(f[r], b);
      const int suf = prefix<CT, PT>(v[r], br);
      hm |= static_cast<uint32_t>(pre + suf >= minlen) << r;
    }
    return hm;
  }
};

// The same with runtime C and P: the a planes read from device memory.
template <bool kIndel, int R>
struct UnitRows<0, 0, kIndel, R> {
  const uint32_t* f[R];
  const uint32_t* v[R];
  int n_chunks, n_planes;

  // rows f0 and v0 onwards (device memory)
  __device__ __forceinline__ void load(const Args& p, const uint32_t* f0,
                                       const uint32_t* v0, int nrows) {
    n_chunks = p.n_chunks;
    n_planes = p.n_planes;
    const int cp = n_chunks * n_planes;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int off = min(r, nrows - 1) * cp;
      f[r] = f0 + off;
      v[r] = kIndel ? v0 + off : nullptr;
    }
  }

  __device__ __forceinline__ uint32_t mask(const uint32_t* a,
                                           const uint32_t* s, int stride,
                                           int col, int c) const {
    uint32_t m = 0;
    for (int q = 0; q < n_planes; ++q) {
      const int k = c * n_planes + q;
      m |= __ldg(a + k) ^ s[k * stride + col];
    }
    return m;
  }

  __device__ __forceinline__ int prefix(const uint32_t* a, const uint32_t* s,
                                        int stride, int col) const {
    for (int c = 0; c < n_chunks; ++c) {
      const uint32_t m = mask(a, s, stride, col, c);
      if (m) return 32 * c + ctz(m);
    }
    return 32 * n_chunks;
  }

  __device__ __forceinline__ uint32_t hamming(const uint32_t* s, int stride,
                                              int col, int d) const {
    uint32_t hm = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int n = 0;
      for (int c = 0; c < n_chunks; ++c) {
        n += __popc(mask(f[r], s, stride, col, c));
      }
      hm |= static_cast<uint32_t>(n <= d) << r;
    }
    return hm;
  }

  __device__ __forceinline__ uint32_t indel(const uint32_t* sf,
                                            const uint32_t* sr, int stride,
                                            int col, int minlen) const {
    uint32_t hm = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int pre = prefix(f[r], sf, stride, col);
      const int suf = prefix(v[r], sr, stride, col);
      hm |= static_cast<uint32_t>(pre + suf >= minlen) << r;
    }
    return hm;
  }
};

// A block's shared memory: the b tile's keys, each run start's window
// (lo, eq_lo, eq_hi, hi: keys k - delta .. k - 1, k, k + 1 .. k + delta),
// the run-start bits, one chunk of staged b planes, and on the
// compile-time C/P path the a tile's planes.
struct Stage {
  unsigned long long* keys;  // [tile_n]
  int* lo;                   // [tile_m] each, set at run starts
  int* eq_lo;
  int* eq_hi;
  int* hi;
  uint32_t* starts;  // [ceil(tile_m / 32)]
  uint32_t* fwd;     // [C P][stride]
  uint32_t* rev;     // [C P][stride], indel runs
  uint32_t* a_fwd;   // [tile_m][C P], compile-time C/P only
  uint32_t* a_rev;   // [tile_m][C P], and indel runs
  int stride;
};

__host__ __device__ inline int head_bytes(int tile_m, int tile_n) {
  const int b = 8 * tile_n + 16 * tile_m + 4 * ((tile_m + 31) / 32);
  return (b + 15) & ~15;
}

__host__ __device__ inline int plane_bytes(int chunk, int cp, bool indel) {
  return 4 * cp * (chunk + 1) * (indel ? 2 : 1);
}

// whether the a tile's planes are staged: on the compile-time C/P path
bool stages_a(int n_chunks, int n_planes) {
  return (n_planes == 3 || n_planes == 5) && n_chunks <= 4;
}

// b columns staged at a time: the whole tile when its planes fit
// kStageBytes, else the largest multiple of 32 that does (at least 32)
int chunk_cols(int tile_n, int cp, bool indel) {
  int c = tile_n;
  while (c > 32 && plane_bytes(c, cp, indel) > kStageBytes) c -= 32;
  return c;
}

__device__ __forceinline__ Stage layout(unsigned char* smem, const Args& p,
                                        int cp, bool indel) {
  Stage s;
  s.keys = reinterpret_cast<unsigned long long*>(smem);
  s.lo = reinterpret_cast<int*>(s.keys + p.tile_n);
  s.eq_lo = s.lo + p.tile_m;
  s.eq_hi = s.eq_lo + p.tile_m;
  s.hi = s.eq_hi + p.tile_m;
  s.starts = reinterpret_cast<uint32_t*>(s.hi + p.tile_m);
  s.stride = p.chunk + 1;
  s.fwd = reinterpret_cast<uint32_t*>(smem + head_bytes(p.tile_m, p.tile_n));
  s.rev = s.fwd + cp * s.stride;
  s.a_fwd = reinterpret_cast<uint32_t*>(smem +
                                        head_bytes(p.tile_m, p.tile_n) +
                                        plane_bytes(p.chunk, cp, indel));
  s.a_rev = s.a_fwd + p.tile_m * cp;
  return s;
}

// One unit: a rows row0 .. row0 + nrows - 1 (tile-relative, nrows <=
// unit_rows) of the run with key `key`, against the columns of its window
// [lo, hi) inside the staged chunk [c0, c0 + cc). Rows past nrows repeat
// the last row and are masked out.
template <int CT, int PT, bool kIndel, bool kShort>
__device__ __forceinline__ void run_unit(const Args& p, const Stage& s,
                                         int a0, int b0, int row0, int nrows,
                                         unsigned long long key, int lo,
                                         int eq_lo, int eq_hi, int hi, int c0,
                                         int cc, int lane) {
  constexpr int R = unit_rows<CT, PT, kShort>();
  UnitRows<CT, PT, kIndel, R> a;
  if constexpr (CT > 0) {
    a.load(p, s.a_fwd + row0 * CT * PT, s.a_rev + row0 * CT * PT, nrows);
  } else {
    const size_t off =
        static_cast<size_t>(a0 + row0) * p.n_chunks * p.n_planes;
    a.load(p, p.a_pl + off, kIndel ? p.a_rpl + off : nullptr, nrows);
  }
  const uint32_t valid = (1u << nrows) - 1u;
  int ml_lo = 0, ml_hi = 0;  // the shorter length at key k - 1 and k + 1
  if constexpr (kIndel) {
    const int la = static_cast<int>(key & 0xFFFF);
    ml_lo = min(la, static_cast<int>((key - 1) & 0xFFFF));
    ml_hi = min(la, static_cast<int>((key + 1) & 0xFFFF));
  }
  const int j_lo = max(lo, c0);
  const int j_hi = min(hi, c0 + cc);
  for (int w = j_lo >> 5; w < (j_hi + 31) >> 5; ++w) {
    const int j = (w << 5) + lane;  // tile column; j - c0 in the chunk
    if (j < j_lo || j >= j_hi) continue;
    uint32_t hm = 0;
    if (j >= eq_lo && j < eq_hi) {
      hm = a.hamming(s.fwd, s.stride, j - c0, p.differences);
    } else if constexpr (kIndel) {
      hm = a.indel(s.fwd, s.rev, s.stride, j - c0,
                   j < eq_lo ? ml_lo : ml_hi);
    }
    hm &= valid;
    while (hm) {
      const int r = __ffs(hm) - 1;
      hm &= hm - 1;
      add_pair(p, a0 + row0 + r, b0 + j);
    }
  }
}

template <int CT, int PT, bool kIndel, bool kShort>
__global__ void __launch_bounds__(kThreads) dense_join_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = unit_rows<CT, PT, kShort>();
  const int t = blockIdx.x;
  const int a0 = p.work[2 * t];
  const int b0 = p.work[2 * t + 1];
  // block-uniform exit, before any barrier: an invalid tile adds nothing
  if (a0 < 0 || b0 < 0 || a0 >= p.npad_a || b0 >= p.npad_b) return;
  const int m = min(p.tile_m, p.npad_a - a0);
  const int nb = min(p.tile_n, p.npad_b - b0);
  const int cp = CT > 0 ? CT * PT : p.n_chunks * p.n_planes;
  const Stage s = layout(smem, p, cp, kIndel);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned long long pad_key = p.wide ? ~0ull : 0xFFFFFFFFull;

  for (int j = threadIdx.x; j < nb; j += kThreads) {
    s.keys[j] = key_at(p.b_key, p.wide, b0 + j);
  }
  if constexpr (CT > 0) {
    const size_t a_src = static_cast<size_t>(a0) * cp;
    for (int i = threadIdx.x; i < m * cp; i += kThreads) {
      s.a_fwd[i] = p.a_pl[a_src + i];
      if constexpr (kIndel) s.a_rev[i] = p.a_rpl[a_src + i];
    }
  }
  __syncthreads();

  // The runs of equal a keys: bit i % 32 of starts[i / 32] marks an a row
  // whose key differs from the row before it; that row holds its run's
  // window (empty for the pad run).
  const int n_words = (m + 31) >> 5;
  for (int base = warp * 32; base < n_words * 32; base += kThreads) {
    const int i = base + lane;
    bool start = false;
    if (i < m) {
      const unsigned long long key = key_at(p.a_key, p.wide, a0 + i);
      start = i == 0 || key != key_at(p.a_key, p.wide, a0 + i - 1);
      if (start) {
        int lo = 0, el = 0, eh = 0, hi = 0;
        if (key != pad_key) {
          el = bound_of<false>(s.keys, nb, key);
          eh = el + bound_of<true>(s.keys + el, nb - el, key);
          lo = (kIndel && key > 0) ? bound_of<false>(s.keys, el, key - 1)
                                   : el;
          hi = kIndel ? eh + bound_of<true>(s.keys + eh, nb - eh, key + 1)
                      : eh;
        }
        s.lo[i] = lo;
        s.eq_lo[i] = el;
        s.eq_hi[i] = eh;
        s.hi[i] = hi;
      }
    }
    const unsigned bits = __ballot_sync(kFull, start);
    if (lane == 0) s.starts[base >> 5] = bits;
  }

  for (int c0 = 0; c0 < nb; c0 += p.chunk) {
    const int cc = min(p.chunk, nb - c0);
    __syncthreads();  // run windows written; the last chunk's reads done
    const size_t src0 = static_cast<size_t>(b0 + c0) * cp;
    for (int i = threadIdx.x; i < cc * cp; i += kThreads) {
      const int col = i / cp;
      const int k = i - col * cp;
      s.fwd[k * s.stride + col] = p.b_pl[src0 + i];
      if constexpr (kIndel) s.rev[k * s.stride + col] = p.b_rpl[src0 + i];
    }
    __syncthreads();

    // Deal each run's units to the warps in turn, in run order; every
    // warp walks the same runs and counts the same units dealt, u, so
    // each unit goes to exactly one warp.
    int u = 0;
    int cur = -1;  // first row of the open run
    auto deal = [&](int rs, int re) {
      const int lo = s.lo[rs], hi = s.hi[rs];
      if (max(lo, c0) >= min(hi, c0 + cc)) return;
      const unsigned long long key = key_at(p.a_key, p.wide, a0 + rs);
      const int n_units = (re - rs + R - 1) / R;
      for (int g = (warp - u) & (kWarps - 1); g < n_units; g += kWarps) {
        const int row0 = rs + g * R;
        run_unit<CT, PT, kIndel, kShort>(p, s, a0, b0, row0,
                                         min(R, re - row0), key, lo,
                                         s.eq_lo[rs], s.eq_hi[rs], hi, c0,
                                         cc, lane);
      }
      u += n_units;
    };
    for (int w = 0; w < n_words; ++w) {
      uint32_t bits = s.starts[w];
      while (bits) {
        const int i = (w << 5) + __ffs(bits) - 1;
        bits &= bits - 1;
        if (cur >= 0) deal(cur, i);
        cur = i;
      }
    }
    deal(cur, m);  // row 0 always starts a run, so cur >= 0
  }
}

int smem_bytes(int tile_m, int tile_n, int n_chunks, int n_planes,
               bool indel) {
  const int cp = n_chunks * n_planes;
  const int a_bytes =
      stages_a(n_chunks, n_planes) ? 4 * tile_m * cp * (indel ? 2 : 1) : 0;
  return head_bytes(tile_m, tile_n) +
         plane_bytes(chunk_cols(tile_n, cp, indel), cp, indel) + a_bytes;
}

template <int CT, int PT, bool kIndel, bool kShort>
int launch(const Args& p, int n_tiles, int smem, cudaStream_t stream) {
  const auto kernel = dense_join_kernel<CT, PT, kIndel, kShort>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(n_tiles), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// kI, kS: kIndel, kShort of the kernel
template <bool kI, bool kS>
int dispatch(const Args& p, int n_tiles, int smem, cudaStream_t st) {
  if (p.n_planes == 5) {
    switch (p.n_chunks) {
      case 1: return launch<1, 5, kI, kS>(p, n_tiles, smem, st);
      case 2: return launch<2, 5, kI, kS>(p, n_tiles, smem, st);
      case 3: return launch<3, 5, kI, kS>(p, n_tiles, smem, st);
      case 4: return launch<4, 5, kI, kS>(p, n_tiles, smem, st);
      default: break;
    }
  } else if (p.n_planes == 3) {
    switch (p.n_chunks) {
      case 1: return launch<1, 3, kI, kS>(p, n_tiles, smem, st);
      case 2: return launch<2, 3, kI, kS>(p, n_tiles, smem, st);
      case 3: return launch<3, 3, kI, kS>(p, n_tiles, smem, st);
      case 4: return launch<4, 3, kI, kS>(p, n_tiles, smem, st);
      default: break;
    }
  }
  return launch<0, 0, kI, kS>(p, n_tiles, smem, st);
}

// Validates, then launches the kernel of the run: Hamming only, or with
// the indel test in short units below kLongUnitTile and full ones above.
int run(Args p, int n_tiles, bool indels, void* stream) {
  if (n_tiles <= 0) return 0;
  if (p.tile_m <= 0 || p.tile_n <= 0 || p.n_chunks <= 0 ||
      p.n_planes <= 0 || p.n_planes > 5 || p.mode < kOne ||
      p.mode > kRatio || (p.mode == kRatio && !p.float_out) || !p.a_pl ||
      !p.b_pl || (indels && (!p.a_rpl || !p.b_rpl))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.chunk = chunk_cols(p.tile_n, p.n_chunks * p.n_planes, indels);
  const int smem =
      smem_bytes(p.tile_m, p.tile_n, p.n_chunks, p.n_planes, indels);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!indels) return dispatch<false, false>(p, n_tiles, smem, st);
  if (p.tile_m < kLongUnitTile) {
    return dispatch<true, true>(p, n_tiles, smem, st);
  }
  return dispatch<true, false>(p, n_tiles, smem, st);
}

Args make_args(const void* a_planes, const void* a_rplanes,
               const void* a_key, const void* a_rep, const void* a_cnt,
               const void* b_planes, const void* b_rplanes,
               const void* b_key, const void* b_rep, const void* b_cnt,
               const void* work, int npad_a, int npad_b, int tile_m,
               int tile_n, int n_chunks, int n_planes, int differences,
               int mode, int r2p, int wide, int float_out, void* out) {
  Args p = {};
  p.a_pl = static_cast<const uint32_t*>(a_planes);
  p.a_rpl = static_cast<const uint32_t*>(a_rplanes);
  p.a_key = a_key;
  p.a_rep = static_cast<const int32_t*>(a_rep);
  p.a_cnt = a_cnt;
  p.b_pl = static_cast<const uint32_t*>(b_planes);
  p.b_rpl = static_cast<const uint32_t*>(b_rplanes);
  p.b_key = b_key;
  p.b_rep = static_cast<const int32_t*>(b_rep);
  p.b_cnt = b_cnt;
  p.work = static_cast<const int32_t*>(work);
  p.npad_a = npad_a;
  p.npad_b = npad_b;
  p.tile_m = tile_m;
  p.tile_n = tile_n;
  p.n_chunks = n_chunks;
  p.n_planes = n_planes;
  p.differences = differences;
  p.mode = mode;
  p.r2p = r2p;
  p.wide = wide;
  p.float_out = float_out;
  p.out = out;
  return p;
}

}  // namespace

extern "C" {

// Shared memory one dense_indel block needs, in bytes.
int dense_indel_smem_bytes(int tile_m, int tile_n, int n_chunks,
                           int n_planes) {
  return smem_bytes(tile_m, tile_n, n_chunks, n_planes, true);
}

// Shared memory one dense_general block needs, in bytes.
int dense_general_smem_bytes(int tile_m, int tile_n, int n_chunks,
                             int n_planes, int indels) {
  return smem_bytes(tile_m, tile_n, n_chunks, n_planes, indels != 0);
}

// dense_indel on `stream` over n_tiles worklist tiles (work: int32
// [n_tiles, 2] element starts). Plane rows are int32 [npad, n_chunks,
// n_planes] (kernels.residue_planes of the residue rows and of the rows
// reversed within their lengths); key/rep/cnt rows int32 [npad], key-sorted
// with pads (key -1) last; mode 0..4 (no ratio); out int64 [r1p, r2p],
// zeroed by the caller. Returns the cudaError_t of the launch (0 on
// success).
int dense_indel_launch(const void* a_planes, const void* a_rplanes,
                       const void* a_key, const void* a_rep,
                       const void* a_cnt, const void* b_planes,
                       const void* b_rplanes, const void* b_key,
                       const void* b_rep, const void* b_cnt,
                       const void* work, int n_tiles, int npad_a, int npad_b,
                       int tile_m, int tile_n, int n_chunks, int n_planes,
                       int differences, int mode, int r2p, void* out,
                       void* stream) {
  const Args p = make_args(a_planes, a_rplanes, a_key, a_rep, a_cnt,
                           b_planes, b_rplanes, b_key, b_rep, b_cnt, work,
                           npad_a, npad_b, tile_m, tile_n, n_chunks,
                           n_planes, differences, mode, r2p, 0, 0, out);
  return run(p, n_tiles, true, stream);
}

// dense_general on `stream`: as dense_indel, with int64 key and count rows,
// the reversed rows' planes read only when indels is 1 (else they may be
// null), mode 0..5, and out int64 (float_out 0; no ratio) or float64
// (float_out 1) [r1p, r2p], zeroed by the caller.
int dense_general_launch(const void* a_planes, const void* a_rplanes,
                         const void* a_key, const void* a_rep,
                         const void* a_cnt, const void* b_planes,
                         const void* b_rplanes, const void* b_key,
                         const void* b_rep, const void* b_cnt,
                         const void* work, int n_tiles, int npad_a,
                         int npad_b, int tile_m, int tile_n, int n_chunks,
                         int n_planes, int differences, int indels, int mode,
                         int r2p, int float_out, void* out, void* stream) {
  const Args p = make_args(a_planes, a_rplanes, a_key, a_rep, a_cnt,
                           b_planes, b_rplanes, b_key, b_rep, b_cnt, work,
                           npad_a, npad_b, tile_m, tile_n, n_chunks,
                           n_planes, differences, mode, r2p, 1, float_out,
                           out);
  return run(p, n_tiles, indels != 0, stream);
}

const char* dense_general_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
