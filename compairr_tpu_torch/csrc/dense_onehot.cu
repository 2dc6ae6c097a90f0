// dense_onehot: the dense overlap-matrix reduction as an int8 one-hot
// product on Hopper's warpgroup tensor-core path (wgmma), hand-written.
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
// Its formulation is v2's: the position matches of a 64 x N sub-block
// are one int8 product of one-hot rows, feature (class c, position p)
// at lane c * lpad + p for the 21 residue classes (pallas_kernels.py:2140),
// K = 21 * lpad lanes rounded up to a multiple of 32, zero lanes past
// 21 * lpad. v2's chain decomposition, flush flags and f32 exactness
// guard (_v2_chains, _flush_flags, _v2_run_cap, _chain_flush) are
// machinery for a chip without scatter-add and are not carried over.
//
// Bound on this card. The function's bound is dense_match's, by bytes
// (the rows a tile covers read once, the matrix written once). The
// formulation does 2 * 64 * N * K int8 tensor-core operations for every
// sub-block it computes, so its own floor is that count over the int8
// peak; sub-blocks whose key ranges cannot meet hold no pair and are
// skipped, so the floor counts only those that meet (the skip floor).
// Under -g almost every sub-block meets and the product and the shared
// memory set the pace: a k-step reads 6 KB of operands for 64 tensor
// clocks (96 of the SM's 128 bytes a clock), and the builds share what
// is left. Issuing a slice's 16 wgmma holds its warpgroup for most of
// the product, so a block's builds overlap the other block's product,
// not its own. On diverse keys few sub-blocks meet, and the builds and
// per-tile setup set the pace.
//
// The design, against what held the kernel's first port back:
//   1. one block (one warpgroup, 128 threads) per worklist tile, no
//      row-slice grid dimension: each b chunk of N columns (N = 128 at
//      lpad 24) is built into shared memory once a tile, not once for
//      every 64-row a slice;
//   2. the build is branch-free per class and cheap: a thread loads its
//      residue words in one batch and stores one byte a residue, at lane
//      c * lpad + p; a buffer that holds the last build's one-hots at
//      the same lanes is not zeroed: each thread clears the bytes it set
//      there (at lpad 24 a slice takes 12 + 12 byte stores a thread,
//      where zeroing would store 32 KB, against the 16 wgmma k-steps of
//      1,024 tensor clocks that its product takes); no __vcmpeq4. Two
//      blocks share an SM (under 113 KB of shared memory each at lpad 24
//      and 48), so one block's builds and epilogue run while the other's
//      product does;
//   3. the product is wgmma.mma_async m64nNk32 s32.s8.s8 with A and B
//      read from shared memory through descriptors, s32 accumulators in
//      registers (exact: matches <= lpad);
//   4. before the main kernel, the launch takes the min and max key of
//      the real rows (rep >= 0) of every 64-row group of both sides, in
//      a small kernel of its own (a warp a group, each row read once),
//      so that a tile reads its groups' ranges and not their rows; a b
//      chunk whose range meets no a slice is neither built nor
//      multiplied, nor is an a slice whose range misses the chunk's, nor
//      an all-pad slice or chunk (its range is empty). Ranges are taken
//      over rows in any order, so the skip is right on unsorted rows too;
//   5. the epilogue tests the match counts first, in registers: a
//      thread whose largest count is below lpad - differences is done;
//      else a bit mask of its hits drives a short loop that reads the b
//      row's rep and key from shared memory and adds the score to its
//      int64 cell with a 64-bit atomicAdd, as dense_match does. Mean sums
//      cnt_a + cnt_b and the caller halves.

// Shared-memory layout: no swizzle. A one-hot buffer of R rows and W
// lanes is cut into core matrices of 8 rows x 16 lanes, 128 contiguous
// bytes each; a row group's core matrices follow each other along K
// (leading byte offset 128) and row groups are 8 W bytes apart (stride
// byte offset). The build computes each byte's address directly, so no
// swizzle pattern has to be followed, and each core matrix is one
// 128-byte line, which the tensor cores read without bank conflicts.
//
// K beyond one stage: the b chunk holds all K lanes (N narrows from 128
// to 8 as lpad grows, so that it fits); the a slice is built in stages
// of at most 512 lanes, the accumulators carried across stages in
// registers. Every lpad up to several hundred fits. Residue codes at or
// above 21 would match no class; the wrapper rejects them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 128;     // one warpgroup
constexpr int kSlice = 64;        // a rows a product (wgmma M)
constexpr int kGroup = 64;        // rows a key-range group
constexpr int kStageK = 512;      // a stage's lanes, at most
constexpr int kClasses = 21;      // residue classes: aa 0..19 / nt 0..3 + pad
constexpr int kTwoBlocks = 115712;   // 2 (smem + 1 KB reserved) <= 228 KB
constexpr int kMaxSmem = 232448;     // a block's shared memory, at most

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

// Byte offset of (row r, lane k) in a one-hot buffer of w lanes a row:
// core matrices of 8 rows x 16 lanes, 128 bytes each, 128 bytes apart
// along K, row groups 8 w bytes apart.
__device__ __forceinline__ int oh_offset(int r, int k, int w) {
  return (r >> 3) * (w << 3) + ((k >> 4) << 7) + ((r & 7) << 4) + (k & 15);
}

// ---- PTX: shared-memory addresses, fences, wgmma ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma matrix descriptor, no swizzle: start address, leading byte
// offset (between core matrices along K) and stride byte offset
// (between 8-row groups), each in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (N / 2 s32 a thread) = A (64 x 32, K-major) B (N x 32, K-major)^T
// (+ d when scale_d is nonzero)
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<8>(int* d, uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<16>(int* d, uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int* d, uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// ---- end PTX ----

// [lo, hi] key range of rows [row0, row0 + n): the union of their
// 64-row groups' ranges (empty, lo > hi, when no row is real)
__device__ __forceinline__ int2 rows_range(const int2* __restrict__ rng,
                                           int row0, int n) {
  int2 r = make_int2(0x7FFFFFFF, static_cast<int>(0x80000000));
  for (int g = row0 / kGroup; g <= (row0 + n - 1) / kGroup; ++g) {
    const int2 x = rng[g];
    r.x = min(r.x, x.x);
    r.y = max(r.y, x.y);
  }
  return r;
}

__device__ __forceinline__ bool ranges_meet(int2 a, int2 b) {
  return a.x <= a.y && b.x <= b.y && a.x <= b.y && b.x <= a.y;
}

constexpr int kRangeThreads = 256;  // a ranges block: 8 warps, 8 groups

// rng[g]: the min and max key over the rows with rep >= 0 of rows [64 g,
// 64 g + 64) of an npad-row side, (2^31 - 1, -2^31) when it has none. A
// warp takes a group, a lane two rows. (Its name begins with the main
// kernel's, so that a profile's dense_onehot_kernel entries hold both.)
__global__ void __launch_bounds__(kRangeThreads) dense_onehot_kernel_ranges(
    const int32_t* __restrict__ key, const int32_t* __restrict__ rep,
    int npad, int2* __restrict__ rng) {
  const int g = blockIdx.x * (kRangeThreads / 32) + (threadIdx.x >> 5);
  if (g * kGroup >= npad) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  int lo = 0x7FFFFFFF, hi = static_cast<int>(0x80000000);
#pragma unroll
  for (int h = 0; h < kGroup; h += 32) {
    const int r = g * kGroup + h + lane;
    const int k = r < npad ? key[r] : 0;
    if (r < npad && rep[r] >= 0) {
      lo = min(lo, k);
      hi = max(hi, k);
    }
  }
  lo = __reduce_min_sync(0xFFFFFFFFu, lo);
  hi = __reduce_max_sync(0xFFFFFFFFu, hi);
  if (lane == 0) rng[g] = make_int2(lo, hi);
}

// Residue words a thread loads at once for a build, issued together so
// that their latencies overlap. At lpad 24 a 64-row slice is 384 words
// (3 a thread) and a 128-row chunk 768 (6): the first batch holds them
// all, so the next build can clear exactly the bytes this one set.
constexpr int kBatch = 8;
// a word no row holds: its bytes (255) fall past every lane
constexpr uint32_t kNoWord = 0xFFFFFFFFu;

// Item i of a build is word i / ROWS of row i % ROWS: a warp takes 32
// rows at one word, so each row's byte goes to its own 16-byte line, and
// a thread keeps its items from one build to the next.
template <int ROWS>
__device__ __forceinline__ void load_words(uint32_t (&w)[kBatch],
                                           const uint32_t* __restrict__ res,
                                           int valid, int nwp, int base) {
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    if (base + q * kThreads >= ROWS * nwp) break;
    const int i = base + threadIdx.x + q * kThreads;
    const int r = i % ROWS;
    const int wd = i / ROWS;
    w[q] = r < valid && wd < nwp ? res[static_cast<size_t>(r) * nwp + wd]
                                 : kNoWord;
  }
}

// The bytes of one batch of words (load_words at base) in one-hot rows of
// w lanes holding the full row's lanes [k0, k0 + w): `value` at lane
// c * lpad + p for each residue c at position p that falls there.
template <int ROWS>
__device__ __forceinline__ void scatter_words(uint8_t* buf, int w,
                                              const uint32_t (&words)[kBatch],
                                              int nwp, int lpad, int k0,
                                              int base, uint8_t value) {
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    if (base + q * kThreads >= ROWS * nwp) break;
    const int i = base + threadIdx.x + q * kThreads;
    const int r = i % ROWS;
    const int p = 4 * (i / ROWS) - k0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k =
          static_cast<int>((words[q] >> (8 * e)) & 0xFF) * lpad + p + e;
      if (static_cast<unsigned>(k) < static_cast<unsigned>(w)) {
        buf[oh_offset(r, k, w)] = value;
      }
    }
  }
}

// One-hot rows of `valid` residue rows (ROWS at most, nwp words of four
// residues a row) into buf, rows of w lanes holding lanes [k0, k0 + w).
// When the buffer holds the one-hots of `prev` (the first batch of the
// last build into it) at the same lanes and width, and one batch covers
// a build, only the bytes prev set are cleared, by the threads that set
// them (a byte is one row's one position, so no other thread's item
// lands there), and the new ones set: 24 byte stores a thread at lpad 24 where a
// zeroed buffer would take 32 KB of stores. Else the buffer is zeroed
// with 16-byte stores first. first: this build's first batch. Ends with
// the writes visible to wgmma and the block synchronised.
template <int ROWS>
__device__ __forceinline__ void build_onehot(
    uint8_t* buf, int w, const uint32_t* __restrict__ res, int valid,
    int nwp, int lpad, int k0, const uint32_t (&first)[kBatch],
    bool clean, const uint32_t (&prev)[kBatch], int prev_k0, int prev_w) {
  if (clean && prev_k0 == k0 && prev_w == w &&
      ROWS * nwp <= kBatch * kThreads) {
    scatter_words<ROWS>(buf, prev_w, prev, nwp, lpad, prev_k0, 0, 0);
    scatter_words<ROWS>(buf, w, first, nwp, lpad, k0, 0, 1);
  } else {
    uint4* z = reinterpret_cast<uint4*>(buf);
    for (int i = threadIdx.x; i < ROWS * w / 16; i += kThreads) {
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    scatter_words<ROWS>(buf, w, first, nwp, lpad, k0, 0, 1);
    for (int base = kBatch * kThreads; base < ROWS * nwp;
         base += kBatch * kThreads) {
      uint32_t words[kBatch];
      load_words<ROWS>(words, res, valid, nwp, base);
      scatter_words<ROWS>(buf, w, words, nwp, lpad, k0, base, 1);
    }
  }
  fence_async_smem();
  __syncthreads();
}

// A one-hot buffer's content: the first batch of words of its last
// build, with that build's first lane and width (clean: there was one).
struct Held {
  uint32_t words[kBatch];
  int k0, w;
  bool clean;
};

// Build into the buffer `held` describes, and record the build there.
template <int ROWS>
__device__ __forceinline__ void rebuild(uint8_t* buf, Held& held, int w,
                                        const uint32_t* __restrict__ res,
                                        int valid, int nwp, int lpad,
                                        int k0) {
  uint32_t first[kBatch];
  load_words<ROWS>(first, res, valid, nwp, 0);
  build_onehot<ROWS>(buf, w, res, valid, nwp, lpad, k0, first, held.clean,
                     held.words, held.k0, held.w);
#pragma unroll
  for (int q = 0; q < kBatch; ++q) held.words[q] = first[q];
  held.k0 = k0;
  held.w = w;
  held.clean = true;
}

// A slice's epilogue: for every accumulator with acc >= need (a pair
// within the distance; rare) whose a row is real, the b row's rep and
// key from bm (the chunk's key, rep and count rows) and, on equal keys,
// the pair's score into its int64 cell. Accumulator x = 4 i + 2 h + e is
// slice row 16 warp + g + 8 h (row[3 h .. 3 h + 2]: rep, key, count) and
// chunk column 8 i + 2 tq + e. A thread whose largest count misses
// returns at once; the others form a bit mask, so that the rare hits run
// one short loop and not N / 2 predicated blocks.
template <int N>
__device__ __forceinline__ void epilogue(const int (&acc)[N / 2],
                                         const int (&row)[6],
                                         const int32_t* bm, int need, int tq,
                                         int mode, int r2p,
                                         unsigned long long* out) {
  int most = acc[0];
#pragma unroll
  for (int x = 1; x < N / 2; ++x) most = max(most, acc[x]);
  if (most < need) return;
  uint64_t hits = 0;
#pragma unroll
  for (int x = 0; x < N / 2; ++x) {
    hits |= static_cast<uint64_t>(acc[x] >= need) << x;
  }
  if (row[0] < 0) hits &= 0xCCCCCCCCCCCCCCCCull;  // keep h = 1
  if (row[3] < 0) hits &= 0x3333333333333333ull;  // keep h = 0
  while (hits) {
    const int x = __ffsll(static_cast<long long>(hits)) - 1;
    hits &= hits - 1;
    const bool h = (x >> 1) & 1;
    const int j = 8 * (x >> 2) + 2 * tq + (x & 1);
    const int rep_b = bm[N + j];
    if (rep_b >= 0 && bm[j] == (h ? row[4] : row[1])) {
      atomicAdd(out + static_cast<size_t>(h ? row[3] : row[0]) * r2p + rep_b,
                static_cast<unsigned long long>(
                    pair_score(mode, h ? row[5] : row[2], bm[2 * N + j])));
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2) dense_onehot_kernel(
    const uint32_t* __restrict__ a_res, const int32_t* __restrict__ a_key,
    const int32_t* __restrict__ a_rep, const int32_t* __restrict__ a_cnt,
    const int2* __restrict__ a_rng, const uint32_t* __restrict__ b_res,
    const int32_t* __restrict__ b_key, const int32_t* __restrict__ b_rep,
    const int32_t* __restrict__ b_cnt, const int2* __restrict__ b_rng,
    const int32_t* __restrict__ work, int npad_a, int npad_b, int tile_m,
    int tile_n, int lpad, int differences, int mode, int r2p,
    unsigned long long* __restrict__ out) {
  const int nwp = lpad / 4;                      // residue words a row
  const int kdim = onehot_width(lpad);           // one-hot lanes a row
  const int kst = min(kdim, kStageK);            // lanes an a stage

  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* b_oh = smem;                          // [N][kdim]
  uint8_t* a_oh = b_oh + N * kdim;               // [kSlice][kst]
  int32_t* b_meta = reinterpret_cast<int32_t*>(a_oh + kSlice * kst);

  const int t = blockIdx.x;
  const int a_start = work[2 * t];
  const int b0 = work[2 * t + 1];
  // block-uniform exits, before any barrier: invalid or ragged tiles
  if (a_start < 0 || b0 < 0 || a_start >= npad_a || b0 >= npad_b) return;
  const int ma = min(tile_m, npad_a - a_start);
  const int nb = min(tile_n, npad_b - b0);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;      // accumulator row in the warp's 8
  const int tq = lane & 3;      // accumulator column pair
  const int need = lpad - differences;  // matches a pair needs
  const uint32_t a_base = smem_addr(a_oh);
  const uint32_t b_base = smem_addr(b_oh);
  Held a_held, b_held;  // what the buffers hold: nothing yet
  a_held.clean = b_held.clean = false;

  for (int c0 = 0; c0 < nb; c0 += N) {
    const int nbc = min(N, nb - c0);
    const int2 br = rows_range(b_rng, b0 + c0, nbc);
    bool any = false;
    for (int s0 = 0; s0 < ma && !any; s0 += kSlice) {
      any = ranges_meet(rows_range(a_rng, a_start + s0, min(kSlice, ma - s0)),
                        br);
    }
    if (!any) continue;  // uniform: no slice meets this chunk

    __syncthreads();  // the last chunk's products and epilogue are done
    for (int j = threadIdx.x; j < N; j += kThreads) {
      const bool ok = j < nbc;
      b_meta[j] = ok ? b_key[b0 + c0 + j] : 0;
      b_meta[N + j] = ok ? b_rep[b0 + c0 + j] : -1;
      b_meta[2 * N + j] = ok ? b_cnt[b0 + c0 + j] : 0;
    }
    rebuild<N>(b_oh, b_held, kdim, b_res + static_cast<size_t>(b0 + c0) * nwp,
               nbc, nwp, lpad, 0);

    for (int s0 = 0; s0 < ma; s0 += kSlice) {
      const int a0 = a_start + s0;
      const int m = min(kSlice, ma - s0);
      if (!ranges_meet(rows_range(a_rng, a0, m), br)) continue;

      // this thread's two accumulator rows of the slice: rep, key, count
      int row[6];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        const bool ok = r < m;
        row[3 * h] = ok ? a_rep[a0 + r] : -1;
        row[3 * h + 1] = ok ? a_key[a0 + r] : 0;
        row[3 * h + 2] = ok ? a_cnt[a0 + r] : 0;
      }

      int acc[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0;
      for (int k0 = 0; k0 < kdim; k0 += kst) {
        const int kw = min(kst, kdim - k0);
        __syncthreads();  // the last product has read the stage
        rebuild<kSlice>(a_oh, a_held, kw,
                        a_res + static_cast<size_t>(a0) * nwp, m, nwp, lpad,
                        k0);
        wgmma_fence();
        for (int ks = 0; ks < kw / 32; ++ks) {
          wgmma_s8<N>(acc, smem_desc(a_base + 256u * ks, 128u, 8u * kw),
                      smem_desc(b_base + 8u * k0 + 256u * ks, 128u,
                                8u * kdim),
                      k0 + ks > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
      }
      epilogue<N>(acc, row, b_meta, need, tq, mode, r2p, out);
    }
  }
}

// The b chunk's width at this lpad and the block's shared memory: the
// widest N whose block fits twice on an SM, else the widest that fits
// once (a width of 0 when none does).
struct Shape {
  int n;
  int smem;
};

Shape onehot_shape(int lpad) {
  const int kdim = onehot_width(lpad);
  const int kst = kdim < kStageK ? kdim : kStageK;
  for (const int cap : {kTwoBlocks, kMaxSmem}) {
    for (const int n : {128, 64, 32, 16, 8}) {
      const int smem = n * kdim + kSlice * kst + 3 * 4 * n;
      if (smem <= cap) return {n, smem};
    }
  }
  return {0, 8 * kdim + kSlice * kst + 3 * 4 * 8};
}

template <int N>
cudaError_t launch(const Shape& sh, int n_tiles, cudaStream_t stream,
                   const uint32_t* a_res, const int32_t* a_key,
                   const int32_t* a_rep, const int32_t* a_cnt,
                   const int2* a_rng, const uint32_t* b_res,
                   const int32_t* b_key, const int32_t* b_rep,
                   const int32_t* b_cnt, const int2* b_rng,
                   const int32_t* work, int npad_a, int npad_b, int tile_m,
                   int tile_n, int lpad, int differences, int mode, int r2p,
                   unsigned long long* out) {
  if (sh.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_onehot_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        sh.smem);
    if (err != cudaSuccess) return err;
  }
  dense_onehot_kernel<N><<<n_tiles, kThreads, sh.smem, stream>>>(
      a_res, a_key, a_rep, a_cnt, a_rng, b_res, b_key, b_rep, b_cnt, b_rng,
      work, npad_a, npad_b, tile_m, tile_n, lpad, differences, mode, r2p,
      out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs at this lpad, in bytes (above the
// card's 232,448 when no b chunk width fits).
int dense_onehot_smem_bytes(int lpad) { return onehot_shape(lpad).smem; }

// Launch on `stream` over n_tiles worklist tiles (work: int32 [n_tiles, 2]
// element starts). Residue rows are int8 [npad, lpad] with lpad a multiple
// of 4 and every code below 21; key/rep/cnt rows are int32 [npad], pads
// with rep -1; tile_m and tile_n are multiples of 64; out is int64 [r1p,
// r2p], zeroed by the caller. The key ranges live in stream-ordered
// scratch memory of this call. Returns the first cudaError_t of the
// launch (0 on success).
int dense_onehot_launch(const void* a_res, const void* a_key,
                        const void* a_rep, const void* a_cnt,
                        const void* b_res, const void* b_key,
                        const void* b_rep, const void* b_cnt,
                        const void* work, int n_tiles, int npad_a, int npad_b,
                        int tile_m, int tile_n, int lpad, int differences,
                        int mode, int r2p, void* out, void* stream) {
  if (lpad <= 0 || lpad % 4 != 0 || tile_m <= 0 || tile_n <= 0 ||
      tile_m % kSlice != 0 || tile_n % kSlice != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles <= 0) return 0;
  const Shape sh = onehot_shape(lpad);
  if (sh.n == 0 || npad_a <= 0 || npad_b <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);

  // both sides' group ranges, one pass over a self-comparison's rows
  const bool same = a_key == b_key && a_rep == b_rep && npad_a == npad_b;
  const int ga = (npad_a + kGroup - 1) / kGroup;
  const int gb = same ? 0 : (npad_b + kGroup - 1) / kGroup;
  int2* a_rng = nullptr;
  cudaError_t err = cudaMallocAsync(reinterpret_cast<void**>(&a_rng),
                                    sizeof(int2) * (ga + gb), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int2* b_rng = same ? a_rng : a_rng + ga;
  const int per = kRangeThreads / 32;
  dense_onehot_kernel_ranges<<<(ga + per - 1) / per, kRangeThreads, 0, s>>>(
      static_cast<const int32_t*>(a_key), static_cast<const int32_t*>(a_rep),
      npad_a, a_rng);
  if (!same) {
    dense_onehot_kernel_ranges<<<(gb + per - 1) / per, kRangeThreads, 0, s>>>(
        static_cast<const int32_t*>(b_key),
        static_cast<const int32_t*>(b_rep), npad_b, a_rng + ga);
  }
  err = cudaGetLastError();
#define ONEHOT_ARGS                                                        \
  sh, n_tiles, s, static_cast<const uint32_t*>(a_res),                     \
      static_cast<const int32_t*>(a_key), static_cast<const int32_t*>(a_rep), \
      static_cast<const int32_t*>(a_cnt), static_cast<const int2*>(a_rng),  \
      static_cast<const uint32_t*>(b_res),                                 \
      static_cast<const int32_t*>(b_key), static_cast<const int32_t*>(b_rep), \
      static_cast<const int32_t*>(b_cnt), static_cast<const int2*>(b_rng),  \
      static_cast<const int32_t*>(work), npad_a, npad_b, tile_m, tile_n,   \
      lpad, differences, mode, r2p, static_cast<unsigned long long*>(out)
  switch (err == cudaSuccess ? sh.n : -1) {
    case -1:
      break;
    case 128:
      err = launch<128>(ONEHOT_ARGS);
      break;
    case 64:
      err = launch<64>(ONEHOT_ARGS);
      break;
    case 32:
      err = launch<32>(ONEHOT_ARGS);
      break;
    case 16:
      err = launch<16>(ONEHOT_ARGS);
      break;
    default:
      err = launch<8>(ONEHOT_ARGS);
      break;
  }
#undef ONEHOT_ARGS
  const cudaError_t freed = cudaFreeAsync(a_rng, s);
  return static_cast<int>(err != cudaSuccess ? err : freed);
}

const char* dense_onehot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
