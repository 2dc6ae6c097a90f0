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
//                  epilogue of its `run` (:1878-1902) and the host's decode
//                  of its packed match words: each match is written as its
//                  pair of original indices, tile t's into the slots
//                  offsets[t] .. offsets[t + 1] - 1 that the caller scanned
//                  from count_tiles' counts, so nothing is left to decode
//                  on the host.
//
// Both test a pair with the function of _cached_key_match
// (pallas_kernels.py:229-320):
//   * Hamming match: equal keys and lpad - (equal residues) <= d, pad
//     residues matching themselves;
//   * indel match: keys differing by exactly 1 and prefix + suffix >=
//     min(len_a, len_b), the common prefix of the forward rows and of the
//     reversed rows (reversed within the length, pads after), the lengths
//     taken from key & 0xFFFF;
//   * with exclude_self, a pair whose two original indices are equal is
//     dropped (pads carry -1).
// The tile class picks the tests: 0 Hamming only, 1 Hamming and indel,
// 2 indel only (the worklist classifier proved no equal-key pair there).
//
// The key row is int32 when every real key is below 2^29 (pads in the
// salted band 2^29 + 2 + salt + 4i, as JAX's key32 row) and int64 above
// (pads at 2^62 + 2 + salt + 4i): one key row throughout, in place of the
// JAX package's len/v/j rows for keys >= 2^29 (_match_tile_pallas :323).
// Equal keys mean equal (V, J, length) and keys 1 apart mean the same V
// and J with lengths 1 apart. A pad's key is unique in its set and meets
// no real key of either set, nor lies 1 from one.
//
// What the TPU kernels compute is kept; how is not. The TPU tests every
// pair of a tile with weighted bf16 one-hot matmuls read out of an f32
// exponent and packs bits with f32 matmuls; none of that is carried over.
// Here:
//   * residues are bit planes (kernels.residue_planes): word [row, c, q]
//     holds bit q of the residues at positions 32 c .. 32 c + 31, P = 5
//     planes for amino acids and 3 for nucleotides, 0 past lpad. The
//     mismatch mask of a chunk is m_c = OR_q (A_q ^ B_q) (P LOP3s), the
//     Hamming distance is the sum of popc(m_c), and the first mismatch
//     is 32 c + ctz(m_c) of the first nonzero chunk (lpad when none).
//     The suffix is the first mismatch of the reversed rows' planes;
//   * one block of 128 threads per worklist tile. It stages the b tile's
//     keys (as int64), original indices and planes (and reversed planes
//     on the indel classes) in shared memory, [plane word][column], and
//     the a tile's planes, row by row, in one coalesced pass;
//   * one key window per a run. Both tiles' rows are key-sorted (pads
//     last), so the b columns with keys in [k - delta, k + delta] form
//     one range, and its columns of key k - 1, k and k + 1 three
//     consecutive sub-ranges. Each run of equal keys among the a rows
//     binary-searches them once (delta 0 on class 0, 1 otherwise); no
//     key is compared per pair, and no pair outside a window is visited;
//   * each run is cut into units of up to 8 a rows (unit_rows; half that
//     on the indel classes below tile 512, kLongUnitTile), dealt to
//     the warps in turn. A unit holds its rows' planes in registers and
//     walks the 32-column words of the tile's grid that meet its window,
//     one b column a lane: a lane in the equal-key sub-range runs the
//     Hamming test (none on class 2), a lane at key distance 1 the indel
//     test, a lane outside the window votes false. Lanes diverge only on
//     a word that straddles a key edge. Above C = 4 (lpad > 128) or for a
//     P other than 3 or 5 the same loop runs over runtime C and P, with
//     the a planes read from device memory, not staged;
//   * count_tiles adds each lane's hits and sums them across the block;
//     extract_tiles ballots each row's word, lane 0 reserves the step's
//     hits (the ballots' popcounts) from a cursor in shared memory, and
//     each hitting lane writes its pairs at its rank among them, row by
//     row. Each (row, word) is visited once, so no pair is written
//     twice; a tile's pairs fill its slots in no fixed order. A warp
//     whose hits would pass the tile's slots writes nothing, and a block
//     whose cursor ends other than at its slot count sets the error
//     flag, so offsets that disagree with the kernel's own matches raise
//     in the caller and never write out of bounds;
//   * pads: with exclude_self the pad rows of a (orig -1) are skipped,
//     since their one possible pair, a pad's own twin in a
//     self-comparison, is dropped anyway; without it a pad row is a run
//     of one whose window is empty unless b holds its twin;
//   * b planes beyond kStageBytes are staged in column chunks, multiples
//     of 32 (long rows at big tiles); a unit walks its window's part of
//     each chunk.
//
// Bound on this card (chip_smoke.tile_bound): by bytes on key-sparse
// workloads (each touched row read once), by int8 operations under -g.
// This design's own floor is on the CUDA cores (chip_smoke.tile_floor):
// C (P + 2) integer operations an equal-key pair of a Hamming-testing
// class and 2 C (P + 2) a key-distance-1 pair of an indel-testing class,
// over 132 SMs x 64 a clock. ptxas -v (sm_90a, 128 threads a block),
// count kernels at C = 1, P = 5: 80 registers (24 bytes of spill
// stores) on the Hamming class, 80 (short units) and 164 (8-row units)
// on the indel classes; across the 54 instantiations 48 to 167
// registers and 0 to 48 bytes of spill stores. None is refused for
// registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kStageBytes = 64 * 1024;  // b planes staged at a time

enum TileClass { kHamming = 0, kBoth = 1, kIndelOnly = 2 };

struct Args {
  const uint32_t* a_pl;   // [npad_a, C, P]
  const uint32_t* a_rpl;  // reversed rows' planes (indel classes)
  const void* a_key;      // int32 or int64 [npad_a]
  const int32_t* a_orig;  // [npad_a]
  const uint32_t* b_pl;
  const uint32_t* b_rpl;
  const void* b_key;
  const int32_t* b_orig;
  const int32_t* work;  // [n_tiles, 2] element starts
  int npad_a, npad_b, tile_m, tile_n, n_chunks, n_planes, lpad;
  int differences, cls, exclude_self, key_bytes, chunk;
  int32_t* counts;  // count_tiles: [n_tiles]
  // extract_tiles: tile t's pairs go to slots offsets[t] .. offsets[t +
  // 1] - 1 (total after the last tile) of pair_a (a original indices)
  // and pair_b (b original indices); error is set to 1 where a tile's
  // matches do not fill its slots exactly
  const long long* offsets;  // [n_tiles]
  long long total;
  int32_t* pair_a;
  int32_t* pair_b;
  int32_t* error;
};

// A block's pair slots (extract_tiles): the first, their number (-1
// where the offsets are out of order or out of range: nothing is then
// written), and the cursor in shared memory that the warps reserve from.
struct Slots {
  long long base;
  int cap;
  int* cursor;
};

// Indel-class tiles shorter than this take units of half the rows:
// their registers (forward and reversed planes) then leave room for
// twice the blocks an SM, which pays where per-block setup weighs most
// (tile 128); at tile 512 the longer units' reuse of each staged b word
// pays more (chip_smoke phases 10 and 19 measure both).
constexpr int kLongUnitTile = 512;

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

__device__ __forceinline__ long long key_at(const void* keys, int key_bytes,
                                            int i) {
  return key_bytes == 8 ? static_cast<const long long*>(keys)[i]
                        : static_cast<const int32_t*>(keys)[i];
}

// first index in keys[0, n) whose value is > k (upper) or >= k (not
// upper); keys ascending
template <bool kUpper>
__device__ __forceinline__ int bound_of(const long long* keys, int n,
                                        long long k) {
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

// Common prefix of two rows' planes (C = CT chunks of PT planes), clamped
// to lpad. Branch-free: a chunk after the first nonzero mask adds nothing.
template <int CT, int PT>
__device__ __forceinline__ int prefix(const uint32_t (&a)[CT * PT],
                                      const uint32_t (&b)[CT * PT],
                                      int lpad) {
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
  return min(pre, lpad);
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
                                            int col, int minlen,
                                            int lpad) const {
    uint32_t b[kCP], br[kCP];
#pragma unroll
    for (int k = 0; k < kCP; ++k) {
      b[k] = sf[k * stride + col];
      br[k] = sr[k * stride + col];
    }
    uint32_t hm = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int pre = prefix<CT, PT>(f[r], b, lpad);
      const int suf = prefix<CT, PT>(v[r], br, lpad);
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
                                        int stride, int col,
                                        int lpad) const {
    for (int c = 0; c < n_chunks; ++c) {
      const uint32_t m = mask(a, s, stride, col, c);
      if (m) return min(32 * c + ctz(m), lpad);
    }
    return lpad;
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
                                            int col, int minlen,
                                            int lpad) const {
    uint32_t hm = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int pre = prefix(f[r], sf, stride, col, lpad);
      const int suf = prefix(v[r], sr, stride, col, lpad);
      hm |= static_cast<uint32_t>(pre + suf >= minlen) << r;
    }
    return hm;
  }
};

// A block's shared memory: the b tile's keys and original indices, each
// run start's window (lo, eq_lo, eq_hi, hi: keys k - delta .. k - 1,
// k, k + 1 .. k + delta), the run-start bits, one chunk of staged b
// planes, and on the compile-time C/P path the a tile's planes.
struct Stage {
  long long* keys;  // [tile_n]
  int32_t* orig;    // [tile_n]
  int* lo;          // [tile_m] each, set at run starts
  int* eq_lo;
  int* eq_hi;
  int* hi;
  uint32_t* starts;  // [ceil(tile_m / 32)]
  uint32_t* fwd;     // [C P][stride]
  uint32_t* rev;     // [C P][stride], indel classes
  uint32_t* a_fwd;   // [tile_m][C P], compile-time C/P only
  uint32_t* a_rev;   // [tile_m][C P], and indel classes
  int stride;
};

__host__ __device__ inline int head_bytes(int tile_m, int tile_n) {
  const int b = 12 * tile_n + 16 * tile_m + 4 * ((tile_m + 31) / 32);
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
                                        int cp) {
  Stage s;
  s.keys = reinterpret_cast<long long*>(smem);
  s.orig = reinterpret_cast<int32_t*>(s.keys + p.tile_n);
  s.lo = s.orig + p.tile_n;
  s.eq_lo = s.lo + p.tile_m;
  s.eq_hi = s.eq_lo + p.tile_m;
  s.hi = s.eq_hi + p.tile_m;
  s.starts = reinterpret_cast<uint32_t*>(s.hi + p.tile_m);
  s.stride = p.chunk + 1;
  s.fwd = reinterpret_cast<uint32_t*>(smem + head_bytes(p.tile_m, p.tile_n));
  s.rev = s.fwd + cp * s.stride;
  s.a_fwd = reinterpret_cast<uint32_t*>(
      smem + head_bytes(p.tile_m, p.tile_n) +
      plane_bytes(p.chunk, cp, p.cls != kHamming));
  s.a_rev = s.a_fwd + p.tile_m * cp;
  return s;
}

// One unit: a rows row0 .. row0 + nrows - 1 (tile-relative, nrows <=
// unit_rows) of the run with key `key`, against the columns of its
// window [lo, hi) inside the staged chunk [c0, c0 + cc). Rows past nrows
// repeat the last row and are masked out.
template <int CT, int PT, bool kIndel, bool kExtract, bool kShort>
__device__ __forceinline__ void run_unit(const Args& p, const Stage& s,
                                         const Slots& slots, int a0,
                                         int b0, int row0, int nrows,
                                         long long key, int lo, int eq_lo,
                                         int eq_hi, int hi, int c0, int cc,
                                         int lane, int& cnt) {
  constexpr int R = unit_rows<CT, PT, kShort>();
  UnitRows<CT, PT, kIndel, R> a;
  if constexpr (CT > 0) {
    a.load(p, s.a_fwd + row0 * CT * PT, s.a_rev + row0 * CT * PT, nrows);
  } else {
    const size_t off =
        static_cast<size_t>(a0 + row0) * p.n_chunks * p.n_planes;
    a.load(p, p.a_pl + off, kIndel ? p.a_rpl + off : nullptr, nrows);
  }
  int oa[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    oa[r] = p.exclude_self || kExtract
                ? p.a_orig[a0 + row0 + min(r, nrows - 1)]
                : 0;
  }
  const uint32_t valid = (1u << nrows) - 1u;
  const int la = static_cast<int>(key & 0xFFFF);
  const int ml_lo = min(la, static_cast<int>((key - 1) & 0xFFFF));
  const int ml_hi = min(la, static_cast<int>((key + 1) & 0xFFFF));
  const bool ham = p.cls != kIndelOnly;
  const int w_end = (min(hi, c0 + cc) + 31) >> 5;
  for (int w = max(lo, c0) >> 5; w < w_end; ++w) {
    const int j = (w << 5) + lane;  // tile column; j - c0 in the chunk
    uint32_t hm = 0;
    if (j >= lo && j < hi) {
      if (j >= eq_lo && j < eq_hi) {
        if (ham) hm = a.hamming(s.fwd, s.stride, j - c0, p.differences);
      } else {
        if constexpr (kIndel) {
          hm = a.indel(s.fwd, s.rev, s.stride, j - c0,
                       j < eq_lo ? ml_lo : ml_hi, p.lpad);
        }
      }
      if (p.exclude_self) {
        const int ob = s.orig[j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (oa[r] == ob) hm &= ~(1u << r);
        }
      }
      hm &= valid;
    }
    if constexpr (kExtract) {
      uint32_t bits[R];
      int n = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        bits[r] = __ballot_sync(kFull, (hm >> r) & 1u);
        n += __popc(bits[r]);
      }
      if (n) {
        int pos = 0;
        if (lane == 0) pos = atomicAdd(slots.cursor, n);
        pos = __shfl_sync(kFull, pos, 0);
        if (pos + n <= slots.cap) {
          const unsigned below = (1u << lane) - 1u;
          const long long at = slots.base + pos;
          const int ob = hm ? p.b_orig[b0 + j] : 0;
          int rank = 0;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if ((hm >> r) & 1u) {
              const long long slot = at + rank + __popc(bits[r] & below);
              p.pair_a[slot] = oa[r];
              p.pair_b[slot] = ob;
            }
            rank += __popc(bits[r]);
          }
        }
      }
    } else {
      cnt += __popc(hm);
    }
  }
}

template <int CT, int PT, bool kIndel, bool kExtract, bool kShort>
__global__ void __launch_bounds__(kThreads) tile_match_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_total;
  constexpr int R = unit_rows<CT, PT, kShort>();
  const int t = blockIdx.x;
  const int a0 = p.work[2 * t];
  const int b0 = p.work[2 * t + 1];
  Slots slots = {0, 0, &s_total};
  if constexpr (kExtract) {
    slots.base = p.offsets[t];
    const long long end = t + 1 < static_cast<int>(gridDim.x)
                              ? p.offsets[t + 1]
                              : p.total;
    const bool ordered = slots.base >= 0 && slots.base <= end &&
                         end <= p.total && end - slots.base <= (1 << 30);
    slots.cap = ordered ? static_cast<int>(end - slots.base) : -1;
  }
  // block-uniform exit, before any barrier: an invalid tile counts 0
  if (a0 < 0 || b0 < 0 || a0 >= p.npad_a || b0 >= p.npad_b) {
    if (!kExtract && threadIdx.x == 0) p.counts[t] = 0;
    if (kExtract && threadIdx.x == 0 && slots.cap != 0) *p.error = 1;
    return;
  }
  const int m = min(p.tile_m, p.npad_a - a0);
  const int nb = min(p.tile_n, p.npad_b - b0);
  const int cp = CT > 0 ? CT * PT : p.n_chunks * p.n_planes;
  const Stage s = layout(smem, p, cp);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) s_total = 0;
  for (int j = threadIdx.x; j < nb; j += kThreads) {
    s.keys[j] = key_at(p.b_key, p.key_bytes, b0 + j);
    if (p.exclude_self) s.orig[j] = p.b_orig[b0 + j];
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
  // window.
  const int delta = p.cls == kHamming ? 0 : 1;
  const int n_words = (m + 31) >> 5;
  for (int base = warp * 32; base < n_words * 32; base += kThreads) {
    const int i = base + lane;
    bool start = false;
    if (i < m) {
      const long long key = key_at(p.a_key, p.key_bytes, a0 + i);
      start = i == 0 || key != key_at(p.a_key, p.key_bytes, a0 + i - 1);
      if (start) {
        int lo = 0, el = 0, eh = 0, hi = 0;
        if (!(p.exclude_self && p.a_orig[a0 + i] < 0)) {
          el = bound_of<false>(s.keys, nb, key);
          eh = el + bound_of<true>(s.keys + el, nb - el, key);
          lo = delta ? bound_of<false>(s.keys, el, key - 1) : el;
          hi = delta ? eh + bound_of<true>(s.keys + eh, nb - eh, key + 1)
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

  int cnt = 0;
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
      const long long key = key_at(p.a_key, p.key_bytes, a0 + rs);
      const int n_units = (re - rs + R - 1) / R;
      for (int g = (warp - u) & (kWarps - 1); g < n_units; g += kWarps) {
        const int row0 = rs + g * R;
        run_unit<CT, PT, kIndel, kExtract, kShort>(
            p, s, slots, a0, b0, row0, min(R, re - row0), key, lo,
            s.eq_lo[rs], s.eq_hi[rs], hi, c0, cc, lane, cnt);
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

  if (!kExtract) {
    cnt = __reduce_add_sync(kFull, cnt);
    if (lane == 0 && cnt) atomicAdd(&s_total, cnt);
    __syncthreads();
    if (threadIdx.x == 0) p.counts[t] = s_total;
  } else {
    // every warp's reservations made: the cursor holds the tile's matches
    __syncthreads();
    if (threadIdx.x == 0 && s_total != slots.cap) *p.error = 1;
  }
}

int smem_bytes(int tile_m, int tile_n, int n_chunks, int n_planes,
               int cls) {
  const int cp = n_chunks * n_planes;
  const bool indel = cls != kHamming;
  const int a_bytes =
      stages_a(n_chunks, n_planes) ? 4 * tile_m * cp * (indel ? 2 : 1) : 0;
  return head_bytes(tile_m, tile_n) +
         plane_bytes(chunk_cols(tile_n, cp, indel), cp, indel) + a_bytes;
}

template <int CT, int PT, bool kIndel, bool kExtract, bool kShort>
int launch(const Args& p, int n_tiles, int smem, cudaStream_t stream) {
  const auto kernel = tile_match_kernel<CT, PT, kIndel, kExtract, kShort>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(n_tiles), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// kI, kE, kS: kIndel, kExtract, kShort of the kernel
template <bool kI, bool kE, bool kS>
int dispatch(const Args& p, int n_tiles, int smem, cudaStream_t st) {
  if (p.n_planes == 5) {
    switch (p.n_chunks) {
      case 1: return launch<1, 5, kI, kE, kS>(p, n_tiles, smem, st);
      case 2: return launch<2, 5, kI, kE, kS>(p, n_tiles, smem, st);
      case 3: return launch<3, 5, kI, kE, kS>(p, n_tiles, smem, st);
      case 4: return launch<4, 5, kI, kE, kS>(p, n_tiles, smem, st);
      default: break;
    }
  } else if (p.n_planes == 3) {
    switch (p.n_chunks) {
      case 1: return launch<1, 3, kI, kE, kS>(p, n_tiles, smem, st);
      case 2: return launch<2, 3, kI, kE, kS>(p, n_tiles, smem, st);
      case 3: return launch<3, 3, kI, kE, kS>(p, n_tiles, smem, st);
      case 4: return launch<4, 3, kI, kE, kS>(p, n_tiles, smem, st);
      default: break;
    }
  }
  return launch<0, 0, kI, kE, kS>(p, n_tiles, smem, st);
}

// the Hamming class always takes full units; the indel classes take
// short ones below kLongUnitTile
template <bool kE>
int dispatch_class(const Args& p, int n_tiles, int smem, cudaStream_t st) {
  if (p.cls == kHamming) {
    return dispatch<false, kE, false>(p, n_tiles, smem, st);
  }
  if (p.tile_m < kLongUnitTile) {
    return dispatch<true, kE, true>(p, n_tiles, smem, st);
  }
  return dispatch<true, kE, false>(p, n_tiles, smem, st);
}

int run(Args p, int n_tiles, bool extract, void* stream) {
  if (n_tiles <= 0) return 0;
  if (p.tile_m <= 0 || p.tile_n <= 0 || p.tile_n % 32 != 0 ||
      p.n_chunks <= 0 || p.n_planes <= 0 || p.n_planes > 5 || p.lpad <= 0 ||
      p.lpad > 32 * p.n_chunks || p.cls < kHamming || p.cls > kIndelOnly ||
      (p.key_bytes != 4 && p.key_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.chunk = chunk_cols(p.tile_n, p.n_chunks * p.n_planes, p.cls != kHamming);
  const int smem =
      smem_bytes(p.tile_m, p.tile_n, p.n_chunks, p.n_planes, p.cls);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return extract ? dispatch_class<true>(p, n_tiles, smem, st)
                 : dispatch_class<false>(p, n_tiles, smem, st);
}

Args make_args(const void* a_planes, const void* a_rplanes,
               const void* a_key, const void* a_orig, const void* b_planes,
               const void* b_rplanes, const void* b_key, const void* b_orig,
               const void* work, int npad_a, int npad_b, int tile_m,
               int tile_n, int n_chunks, int n_planes, int lpad,
               int differences, int cls, int exclude_self, int key_bytes) {
  Args p = {};
  p.a_pl = static_cast<const uint32_t*>(a_planes);
  p.a_rpl = static_cast<const uint32_t*>(a_rplanes);
  p.a_key = a_key;
  p.a_orig = static_cast<const int32_t*>(a_orig);
  p.b_pl = static_cast<const uint32_t*>(b_planes);
  p.b_rpl = static_cast<const uint32_t*>(b_rplanes);
  p.b_key = b_key;
  p.b_orig = static_cast<const int32_t*>(b_orig);
  p.work = static_cast<const int32_t*>(work);
  p.npad_a = npad_a;
  p.npad_b = npad_b;
  p.tile_m = tile_m;
  p.tile_n = tile_n;
  p.n_chunks = n_chunks;
  p.n_planes = n_planes;
  p.lpad = lpad;
  p.differences = differences;
  p.cls = cls;
  p.exclude_self = exclude_self;
  p.key_bytes = key_bytes;
  return p;
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (tile class cls).
int tile_match_smem_bytes(int tile_m, int tile_n, int n_chunks, int n_planes,
                          int cls) {
  return smem_bytes(tile_m, tile_n, n_chunks, n_planes, cls);
}

// Per-tile match counts into counts (int32 [n_tiles], written in full) on
// `stream`. Plane rows are int32 [npad, n_chunks, n_planes]
// (kernels.residue_planes of the residue rows, and of the reversed rows
// on classes 1 and 2), lpad <= 32 n_chunks; keys int32 or int64
// (key_bytes 4 or 8) and original indices int32, each [npad], rows
// key-sorted with pads last; work int32 [n_tiles, 2] element starts.
// Returns the launch's cudaError_t.
int count_tiles_launch(const void* a_planes, const void* a_rplanes,
                       const void* a_key, const void* a_orig,
                       const void* b_planes, const void* b_rplanes,
                       const void* b_key, const void* b_orig,
                       const void* work, int n_tiles, int npad_a,
                       int npad_b, int tile_m, int tile_n, int n_chunks,
                       int n_planes, int lpad, int differences, int cls,
                       int exclude_self, int key_bytes, void* counts,
                       void* stream) {
  Args p = make_args(a_planes, a_rplanes, a_key, a_orig, b_planes,
                     b_rplanes, b_key, b_orig, work, npad_a, npad_b, tile_m,
                     tile_n, n_chunks, n_planes, lpad, differences, cls,
                     exclude_self, key_bytes);
  p.counts = static_cast<int32_t*>(counts);
  return run(p, n_tiles, false, stream);
}

// The matches of the worklist tiles, each written as its original
// indices, a's to pair_a and b's to pair_b (int32 [total] each), tile t's
// in the slots offsets[t] .. offsets[t + 1] - 1 (int64 [n_tiles]; total
// after the last tile) in no fixed order; error (int32, zeroed by the
// caller) is set to 1 where a tile's matches do not fill its slots, and
// such a tile writes no slot past them. Other arguments as
// count_tiles_launch.
int extract_tiles_launch(const void* a_planes, const void* a_rplanes,
                         const void* a_key, const void* a_orig,
                         const void* b_planes, const void* b_rplanes,
                         const void* b_key, const void* b_orig,
                         const void* work, int n_tiles, int npad_a,
                         int npad_b, int tile_m, int tile_n, int n_chunks,
                         int n_planes, int lpad, int differences, int cls,
                         int exclude_self, int key_bytes,
                         const void* offsets, long long total, void* pair_a,
                         void* pair_b, void* error, void* stream) {
  Args p = make_args(a_planes, a_rplanes, a_key, a_orig, b_planes,
                     b_rplanes, b_key, b_orig, work, npad_a, npad_b, tile_m,
                     tile_n, n_chunks, n_planes, lpad, differences, cls,
                     exclude_self, key_bytes);
  p.offsets = static_cast<const long long*>(offsets);
  p.total = total;
  p.pair_a = static_cast<int32_t*>(pair_a);
  p.pair_b = static_cast<int32_t*>(pair_b);
  p.error = static_cast<int32_t*>(error);
  if (!p.pair_a || !p.pair_b || !p.offsets || !p.error || total < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run(p, n_tiles, true, stream);
}

const char* tile_match_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
