// airr_parse: the AIRR TSV tokeniser on the card.
//
// Replaces no TPU kernel. The JAX package reads its input on the host
// (compairr_tpu/io/airr.py, and native/airr_parser.cpp, which the port
// shares), one thread at the CLI's default -t 1, about 150 MB/s. The
// port's card route of read_db (io/card.py) uploads a file's body once
// and runs these kernels over it. They compute what airr_parser.cpp
// computes, rows ignored under -u and -e included; a row that would be
// an error is counted, and its file goes back to the host parser whole
// (the host's message and line number are the result).
//
//   * line index: line_count_kernel counts the '\n' bytes of each 16 KB
//     tile (16-byte loads, __vcmpeq4), scan_kernel turns the counts into
//     each tile's first line, and line_starts_kernel writes every line's
//     start in file order (one block scan a 4 KB step of the tile);
//   * row pass (row_kernel, one thread a line; neighbouring threads read
//     neighbouring lines, so a line's bytes come through L1): the line's
//     tab-separated fields up to the last column read; the sequence
//     column's residues through the 256-entry table (build_map) and
//     their FNV-1a row hash; duplicate_count by parse_count's rules; the
//     repertoire, V and J tokens' FNV-1a hashes (under the try's offset
//     basis), each entered into an open-addressing table keyed by the
//     hash whose slot keeps the first line with that key (atomicMin);
//     sequence_id's offset and length; the rows that are an error, and
//     the rows ignored (-u, -e: length -1) with airr_parser.cpp's
//     counts; block reductions of the longest and shortest length, the
//     count sum and the residue count;
//   * verify: slot_tokens_kernel gives each slot its first line's token,
//     and verify_kernel compares every kept row's token byte for byte
//     with its slot's and counts the differences (hash collisions), so
//     that no id rests on a hash: the wrapper then hashes again under
//     the next try's basis;
//   * where rows were ignored, keep_index (block_sums_kernel,
//     scan_kernel and scan_write_kernel over the kept flags) numbers the
//     kept rows and compact_kernel moves their fields down to them;
//   * ids_kernel maps each row's slot to the id the host gave the slot
//     (first-appearance order; GeneTables' ids for V and J);
//   * pack_kernel writes the padded [n, lmax] int8 residue matrix;
//   * block_sums_kernel, scan_kernel and scan_write_kernel turn token
//     lengths into blob offsets, and gather_kernel copies the tokens
//     (sequence_id, the tables' names) into the blob.
//
// Bound on the card: the body read once and the returned arrays written
// once over 3.35 TB/s: 0.108 ms for a 144.6 MB keck20 file of 4.03M rows
// (217.9 MB written). Measured on one NVIDIA H100 80GB HBM3 (700 W),
// the kernels take 1.24 ms together (pack 0.43, row pass 0.39, verify
// 0.20, line index 0.15, the rest 0.07): each is one streaming pass, and
// the row pass and verify read a line's bytes one at a time. The route
// around them takes 0.12 to 0.20 s: the file's read into the staging
// buffers (25 to 60 ms) and the copy back (0.09 to 0.16 s, bound by the
// host faulting in 0.2 GB of fresh memory, not by PCIe). Block scans and
// reductions use shared memory only (blocks of kThreads threads, or
// kScanThreads for scan_kernel).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                     // 16-byte vectors a thread a tile
constexpr int kTileVecs = kThreads * kVecs;  // 16 KB a tile
constexpr int kScanThreads = 1024;           // scan_kernel's one block
constexpr int kScanItems = 8;                // elements a thread, row scans
constexpr int kScanChunk = kThreads * kScanItems;
constexpr int kMaxGrid = 132 * 16;           // grid-stride kernels

constexpr unsigned long long kFnvBasis = 1469598103934665603ULL;
constexpr unsigned long long kFnvPrime = 1099511628211ULL;
constexpr long long kCountMax = 1LL << 62;

// the fields a row pass reads, and the three interned kinds
enum { F_SEQ = 0, F_REP, F_SID, F_DC, F_V, F_J, kFields };
constexpr int kKinds = 3;  // repertoire, V, J

// stats words (unsigned 64-bit), written by init_kernel and the passes
enum {
  S_FLAGGED = 0,
  S_LONGEST,
  S_SHORTEST,
  S_TOTAL_DUP,
  S_RESIDUES,
  S_OCCUPIED,  // three words, one a kind
  S_OVERFLOW = S_OCCUPIED + kKinds,
  S_COLLISIONS,
  S_IGN_UNKNOWN,  // airr_parser.cpp's ignored_unknown: unknown symbols
  S_IGN_EMPTY,    // and ignored_empty, over the ignored rows
  S_IGNORED,      // rows ignored
  kStats,
};

// the spec as the wrapper lays it out (int64 words)
enum {
  P_COLS = 0,  // kFields 1-based column numbers, 0 = absent
  P_IGNORE_COUNTS = kFields,
  P_IGNORE_GENES,
  P_REQUIRE_SID,
  P_DEF_OFF,  // the default repertoire id's bytes in the buffer
  P_DEF_LEN,
  P_HASH_MASK,
  P_HASH_BASIS,  // the tokens' FNV-1a offset basis (the try's)
  P_IGNORE_UNKNOWN,
  P_IGNORE_EMPTY,
  kSpecWords,
};

struct Spec {
  int cols[kFields];
  int max_col;
  int ignore_counts, ignore_genes, require_sid, ignore_unknown, ignore_empty;
  long long def_off;
  int def_len;
  unsigned long long hash_mask, hash_basis;
};

struct Field {
  long long off;
  int len;  // < 0: the line has no such column
};

template <typename T>
struct Sum {
  __device__ T operator()(T a, T b) const { return a + b; }
};
template <typename T>
struct Max {
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};
template <typename T>
struct Min {
  __device__ T operator()(T a, T b) const { return a < b ? a : b; }
};

// every thread of the block gets op over the block's x
template <int N, typename T, typename Op>
__device__ T block_reduce(T x, Op op) {
  __shared__ T buf[N];
  buf[threadIdx.x] = x;
  __syncthreads();
  for (int s = N / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) buf[threadIdx.x] = op(buf[threadIdx.x],
                                                    buf[threadIdx.x + s]);
    __syncthreads();
  }
  const T r = buf[0];
  __syncthreads();
  return r;
}

// the block's exclusive prefix sum of x at this thread; *total the sum
template <int N, typename T>
__device__ T block_exclusive_scan(T x, T* total) {
  __shared__ T buf[2][N];
  const int t = threadIdx.x;
  int in = 0;
  buf[0][t] = x;
  __syncthreads();
  for (int off = 1; off < N; off <<= 1) {
    T v = buf[in][t];
    if (t >= off) v += buf[in][t - off];
    buf[in ^ 1][t] = v;
    in ^= 1;
    __syncthreads();
  }
  const T incl = buf[in][t];
  *total = buf[in][N - 1];
  __syncthreads();
  return incl - x;
}

__device__ __forceinline__ int newlines4(unsigned int w) {
  return __popc(__vcmpeq4(w, 0x0a0a0a0au)) >> 3;
}

__device__ __forceinline__ int newlines16(uint4 x) {
  return newlines4(x.x) + newlines4(x.y) + newlines4(x.z) + newlines4(x.w);
}

__device__ __forceinline__ unsigned long long fnv(unsigned long long h,
                                                  const unsigned char* p,
                                                  int len) {
  for (int k = 0; k < len; k++) h = (h ^ (unsigned long long)p[k]) * kFnvPrime;
  return h;
}

// line i is [*s, *e): its '\n' and one '\r' before it left out
__device__ __forceinline__ void line_of(const unsigned char* body,
                                        const long long* starts, long long i,
                                        long long* s, long long* e) {
  *s = starts[i];
  long long q = starts[i + 1] - 1;
  if (q > *s && body[q - 1] == '\r') q--;
  *e = q;
}

// the tab-separated fields the spec reads, as airr_parser.cpp's split
// and get give them
__device__ __forceinline__ void split_fields(const unsigned char* body,
                                             long long s, long long e,
                                             const Spec& sp, Field* f) {
#pragma unroll
  for (int k = 0; k < kFields; k++) {
    f[k].off = s;
    f[k].len = -1;
  }
  int col = 1;
  long long fs = s;
  for (long long p = s;; p++) {
    const bool end = (p == e);
    if (end || body[p] == '\t') {
#pragma unroll
      for (int k = 0; k < kFields; k++) {
        if (sp.cols[k] == col) {
          f[k].off = fs;
          f[k].len = (int)(p - fs);
        }
      }
      if (end || col >= sp.max_col) break;
      col++;
      fs = p + 1;
    }
  }
}

// the repertoire, V and J tokens of a row: a missing repertoire is the
// default id, a missing gene the empty string
__device__ __forceinline__ void kind_tokens(const Field* f, const Spec& sp,
                                            Field* tk) {
  tk[0] = f[F_REP];
  tk[1] = f[F_V];
  tk[2] = f[F_J];
  if (tk[0].len < 0) {
    tk[0].off = sp.def_off;
    tk[0].len = sp.def_len;
  }
  if (tk[1].len < 0) tk[1].len = 0;
  if (tk[2].len < 0) tk[2].len = 0;
}

// airr_parser.cpp parse_count: leading whitespace, a sign, digits to the
// end, at most 2^62, at least 1
__device__ bool parse_count(const unsigned char* p, int len, long long* out) {
  int i = 0;
  while (i < len && (p[i] == ' ' || p[i] == '\t' || p[i] == '\n' ||
                     p[i] == '\r' || p[i] == '\v' || p[i] == '\f'))
    i++;
  bool neg = false;
  if (i < len && (p[i] == '+' || p[i] == '-')) {
    neg = (p[i] == '-');
    i++;
  }
  if (i >= len) return false;
  long long v = 0;
  for (; i < len; i++) {
    if (p[i] < '0' || p[i] > '9') return false;
    v = v * 10 + (p[i] - '0');
    if (v > kCountMax) return false;
  }
  if (neg) v = -v;
  if (v < 1) return false;
  *out = v;
  return true;
}

// the slot of key in one kind's table, claiming an empty one; the slot
// keeps the least row with its key. -1 when the table is full.
__device__ int insert(unsigned long long key, int row,
                      unsigned long long* keys, int* rows, unsigned int mask,
                      unsigned long long* occupied,
                      unsigned long long* overflow) {
  unsigned int s = (unsigned int)(key ^ (key >> 32)) & mask;
  for (unsigned int probe = 0; probe <= mask; probe++, s = (s + 1) & mask) {
    unsigned long long k = *(volatile unsigned long long*)&keys[s];
    if (k == 0) {
      k = atomicCAS(&keys[s], 0ULL, key);
      if (k == 0) {
        atomicAdd(occupied, 1ULL);
        k = key;
      }
    }
    if (k == key) {
      if (*(volatile int*)&rows[s] > row) atomicMin(&rows[s], row);
      return (int)s;
    }
  }
  atomicExch(overflow, 1ULL);
  return -1;
}

__global__ void line_count_kernel(const uint4* __restrict__ body,
                                  long long n_vec,
                                  long long* __restrict__ tile_counts) {
  const long long v0 = (long long)blockIdx.x * kTileVecs;
  int c = 0;
  for (int k = 0; k < kVecs; k++) {
    const long long v = v0 + (long long)k * kThreads + threadIdx.x;
    if (v < n_vec) c += newlines16(body[v]);
  }
  const int total = block_reduce<kThreads>(c, Sum<int>());
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// out[0, n) the exclusive prefix sums of in[0, n), out[n] the total (in
// may be out); one block of kScanThreads
__global__ void scan_kernel(const long long* in, long long n,
                            long long* out) {
  const long long per = (n + kScanThreads - 1) / kScanThreads;
  long long lo = per * threadIdx.x;
  if (lo > n) lo = n;
  long long hi = lo + per;
  if (hi > n) hi = n;
  long long s = 0;
  for (long long i = lo; i < hi; i++) s += in[i];
  long long total;
  long long run = block_exclusive_scan<kScanThreads>(s, &total);
  for (long long i = lo; i < hi; i++) {
    const long long x = in[i];
    out[i] = run;
    run += x;
  }
  if (threadIdx.x == 0) out[n] = total;
}

// starts[0] = 0, starts[k + 1] one past the k-th '\n'; starts[newlines
// + 1] = open_end where the last line has no '\n' (open_end >= 0)
__global__ void line_starts_kernel(const uint4* __restrict__ body,
                                   long long n_vec,
                                   const long long* __restrict__ tile_first,
                                   long long newlines, long long open_end,
                                   long long* __restrict__ starts) {
  long long base = tile_first[blockIdx.x];
  const long long v0 = (long long)blockIdx.x * kTileVecs;
  for (int k = 0; k < kVecs; k++) {
    const long long v = v0 + (long long)k * kThreads + threadIdx.x;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (v < n_vec) x = body[v];
    const int c = newlines16(x);
    int total;
    const int ex = block_exclusive_scan<kThreads>(c, &total);
    if (c) {
      const unsigned int w[4] = {x.x, x.y, x.z, x.w};
      long long at = base + ex;
#pragma unroll
      for (int i = 0; i < 16; i++)
        if (((w[i >> 2] >> (8 * (i & 3))) & 0xffu) == '\n')
          starts[++at] = v * 16 + i + 1;
    }
    base += total;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    starts[0] = 0;
    if (open_end >= 0) starts[newlines + 1] = open_end;
  }
}

// empty tables (key 0, row INT32_MAX) and the stats' first values
__global__ void init_kernel(unsigned long long* keys, int* rows,
                            long long n_slots, unsigned long long* stats) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < n_slots; t += stride) {
    keys[t] = 0ULL;
    rows[t] = 0x7fffffff;
  }
  if (blockIdx.x == 0 && threadIdx.x < kStats)
    stats[threadIdx.x] = threadIdx.x == S_SHORTEST ? 0x7fffffffULL : 0ULL;
}

struct RowOut {
  int* lengths;  // -1 for an ignored row
  long long* counts;
  unsigned long long* row_hash;
  long long* seq_off;
  long long* sid_off;  // null without a sequence_id column
  int* sid_len;
  int* slots;  // [kKinds, n]
};

__global__ void __launch_bounds__(kThreads)
    row_kernel(const unsigned char* __restrict__ body,
               const long long* __restrict__ starts, long long n, Spec sp,
               const signed char* __restrict__ map_g, RowOut o,
               unsigned long long* keys, int* rows, unsigned int n_slots,
               unsigned long long* stats) {
  __shared__ signed char map[256];
  map[threadIdx.x] = map_g[threadIdx.x];
  __syncthreads();
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  bool keep = false;
  int len = 0;
  long long count = 0;
  if (i < n) {
    long long s, e;
    line_of(body, starts, i, &s, &e);
    Field f[kFields];
    split_fields(body, s, e, sp, f);
    // airr_parser.cpp's scan: a residue counts and hashes; an unknown
    // printable symbol is ignored under -u and an error without; any
    // other byte is an error; no residue is ignored under -e and an
    // error without
    unsigned long long h = kFnvBasis;
    int unknown = 0;
    bool bad = false;
    const Field q = f[F_SEQ];
    for (int k = 0; k < q.len; k++) {
      const unsigned char c = body[q.off + k];
      const int m = map[c];
      if (m >= 0) {
        len++;
        h = (h ^ (unsigned long long)(unsigned char)m) * kFnvPrime;
      } else if (c >= 32 && c <= 126 && sp.ignore_unknown) {
        unknown++;
      } else {
        bad = true;
        break;
      }
    }
    if (!bad && len == 0 && !sp.ignore_empty) bad = true;
    const bool skip = !bad && (unknown > 0 || len == 0);
    if (skip) {
      o.lengths[i] = -1;
      if (unknown) atomicAdd(&stats[S_IGN_UNKNOWN], (unsigned long long)unknown);
      if (len == 0) atomicAdd(&stats[S_IGN_EMPTY], 1ULL);
      atomicAdd(&stats[S_IGNORED], 1ULL);
    } else if (!bad) {
      if (sp.cols[F_SID]) {
        const int sl = f[F_SID].len > 0 ? f[F_SID].len : 0;
        if (!sl && sp.require_sid) bad = true;
        o.sid_off[i] = f[F_SID].off;
        o.sid_len[i] = sl;
      }
      if (f[F_DC].len > 0) {
        if (!parse_count(body + f[F_DC].off, f[F_DC].len, &count)) bad = true;
      } else if (sp.ignore_counts) {
        count = 1;
      } else {
        bad = true;
      }
      if (!sp.ignore_genes && (f[F_V].len <= 0 || f[F_J].len <= 0)) bad = true;
    }
    if (bad) {
      atomicAdd(&stats[S_FLAGGED], 1ULL);
    } else if (!skip) {
      keep = true;
      o.lengths[i] = len;
      o.counts[i] = count;
      o.row_hash[i] = h;
      o.seq_off[i] = q.off;
      Field tk[kKinds];
      kind_tokens(f, sp, tk);
      for (int k = 0; k < kKinds; k++) {
        unsigned long long key =
            fnv(sp.hash_basis, body + tk[k].off, tk[k].len) & sp.hash_mask;
        if (key == 0) key = 1;  // 0 marks an empty slot
        o.slots[k * n + i] =
            insert(key, (int)i, keys + (long long)k * n_slots,
                   rows + (long long)k * n_slots, n_slots - 1,
                   &stats[S_OCCUPIED + k], &stats[S_OVERFLOW]);
      }
    }
  }
  typedef unsigned long long u64;
  const u64 l = keep ? (u64)len : 0ULL;
  const u64 longest = block_reduce<kThreads>(l, Max<u64>());
  const u64 shortest =
      block_reduce<kThreads>(keep ? l : 0x7fffffffULL, Min<u64>());
  const u64 dup = block_reduce<kThreads>(keep ? (u64)count : 0ULL, Sum<u64>());
  const u64 res = block_reduce<kThreads>(l, Sum<u64>());
  if (threadIdx.x == 0) {
    atomicMax(&stats[S_LONGEST], longest);
    atomicMin(&stats[S_SHORTEST], shortest);
    atomicAdd(&stats[S_TOTAL_DUP], dup);
    atomicAdd(&stats[S_RESIDUES], res);
  }
}

// each used slot's token: its first row's
__global__ void slot_tokens_kernel(const unsigned char* __restrict__ body,
                                   const long long* __restrict__ starts,
                                   Spec sp,
                                   const unsigned long long* __restrict__ keys,
                                   const int* __restrict__ rows,
                                   unsigned int n_slots,
                                   long long* __restrict__ tok_off,
                                   int* __restrict__ tok_len) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)kKinds * n_slots) return;
  if (keys[t] == 0) {
    tok_off[t] = 0;
    tok_len[t] = -1;
    return;
  }
  long long s, e;
  line_of(body, starts, rows[t], &s, &e);
  Field f[kFields], tk[kKinds];
  split_fields(body, s, e, sp, f);
  kind_tokens(f, sp, tk);
  const int kind = (int)(t / n_slots);
  tok_off[t] = tk[kind].off;
  tok_len[t] = tk[kind].len;
}

// counts the kept rows whose token differs from their slot's
__global__ void verify_kernel(const unsigned char* __restrict__ body,
                              const long long* __restrict__ starts,
                              long long n, Spec sp,
                              const int* __restrict__ lengths,
                              const int* __restrict__ slots,
                              unsigned int n_slots,
                              const long long* __restrict__ tok_off,
                              const int* __restrict__ tok_len,
                              unsigned long long* stats) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || lengths[i] < 0) return;
  long long s, e;
  line_of(body, starts, i, &s, &e);
  Field f[kFields], tk[kKinds];
  split_fields(body, s, e, sp, f);
  kind_tokens(f, sp, tk);
  bool differ = false;
  for (int k = 0; k < kKinds; k++) {
    const long long slot = (long long)k * n_slots + slots[k * n + i];
    const int l = tok_len[slot];
    if (l != tk[k].len) {
      differ = true;
      continue;
    }
    const unsigned char* a = body + tk[k].off;
    const unsigned char* b = body + tok_off[slot];
    for (int c = 0; c < l; c++) {
      if (a[c] != b[c]) {
        differ = true;
        break;
      }
    }
  }
  if (differ) atomicAdd(&stats[S_COLLISIONS], 1ULL);
}

// slots[k, i] := slot_ids[k, slots[k, i]], in place
__global__ void ids_kernel(int* __restrict__ slots, long long n,
                           const int* __restrict__ slot_ids,
                           unsigned int n_slots) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)kKinds * n) return;
  const long long kind = t / n;
  slots[t] = slot_ids[kind * n_slots + slots[t]];
}

// the kept line i's fields to row index[i] of out (m kept rows)
__global__ void compact_kernel(long long n, const long long* __restrict__ index,
                               RowOut in, long long m, RowOut out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || in.lengths[i] < 0) return;
  const long long r = index[i];
  out.lengths[r] = in.lengths[i];
  out.counts[r] = in.counts[i];
  out.row_hash[r] = in.row_hash[i];
  out.seq_off[r] = in.seq_off[i];
  if (in.sid_off) {
    out.sid_off[r] = in.sid_off[i];
    out.sid_len[r] = in.sid_len[i];
  }
  for (int k = 0; k < kKinds; k++) out.slots[k * m + r] = in.slots[k * n + i];
}

// out [n, lmax]: each row's residue codes, then pad
__global__ void pack_kernel(const unsigned char* __restrict__ body,
                            const long long* __restrict__ seq_off,
                            const int* __restrict__ lengths, long long n,
                            int lmax, const signed char* __restrict__ map_g,
                            signed char pad, signed char* __restrict__ out) {
  __shared__ signed char map[256];
  map[threadIdx.x] = map_g[threadIdx.x];
  __syncthreads();
  const long long total = n * lmax;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
       t < total; t += stride) {
    const long long i = t / lmax;
    const int c = (int)(t - i * lmax);
    out[t] = c < lengths[i] ? map[body[seq_off[i] + c]] : pad;
  }
}

// what a length adds to a scan: itself (a negative one 0), or under
// kOnes 1 for a kept row (length >= 0) and 0 for an ignored one
template <bool kOnes>
__device__ __forceinline__ long long scan_value(int len) {
  if (kOnes) return len >= 0 ? 1 : 0;
  return len > 0 ? len : 0;
}

// sums[b]: the sum of chunk b's scan values
template <bool kOnes>
__global__ void block_sums_kernel(const int* __restrict__ len, long long n,
                                  long long* __restrict__ sums) {
  const long long base =
      (long long)blockIdx.x * kScanChunk + (long long)threadIdx.x * kScanItems;
  long long s = 0;
  for (int k = 0; k < kScanItems; k++) {
    const long long i = base + k;
    if (i < n) s += scan_value<kOnes>(len[i]);
  }
  s = block_reduce<kThreads>(s, Sum<long long>());
  if (threadIdx.x == 0) sums[blockIdx.x] = s;
}

// out[0, n) the exclusive prefix sums of the scan values, out[n] the
// total, from chunk_first (scan_kernel over block_sums_kernel's sums)
template <bool kOnes>
__global__ void scan_write_kernel(const int* __restrict__ len, long long n,
                                  const long long* __restrict__ chunk_first,
                                  long long* __restrict__ out) {
  const long long base =
      (long long)blockIdx.x * kScanChunk + (long long)threadIdx.x * kScanItems;
  long long s = 0;
  for (int k = 0; k < kScanItems; k++) {
    const long long i = base + k;
    if (i < n) s += scan_value<kOnes>(len[i]);
  }
  long long total;
  long long run = chunk_first[blockIdx.x] +
                  block_exclusive_scan<kThreads>(s, &total);
  for (int k = 0; k < kScanItems; k++) {
    const long long i = base + k;
    if (i < n) {
      out[i] = run;
      run += scan_value<kOnes>(len[i]);
    }
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0)
    out[n] = chunk_first[gridDim.x];
}

// dst[dst_off[t], +len[t]) := src[off[t], +len[t])
__global__ void gather_kernel(const unsigned char* __restrict__ src,
                              const long long* __restrict__ off,
                              const int* __restrict__ len,
                              const long long* __restrict__ dst_off,
                              long long n, unsigned char* __restrict__ dst) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const int l = len[t];
  const unsigned char* a = src + off[t];
  unsigned char* b = dst + dst_off[t];
  for (int c = 0; c < l; c++) b[c] = a[c];
}

Spec make_spec(const long long* w) {
  Spec sp;
  sp.max_col = 0;
  for (int k = 0; k < kFields; k++) {
    sp.cols[k] = (int)w[P_COLS + k];
    if (sp.cols[k] > sp.max_col) sp.max_col = sp.cols[k];
  }
  sp.ignore_counts = (int)w[P_IGNORE_COUNTS];
  sp.ignore_genes = (int)w[P_IGNORE_GENES];
  sp.require_sid = (int)w[P_REQUIRE_SID];
  sp.ignore_unknown = (int)w[P_IGNORE_UNKNOWN];
  sp.ignore_empty = (int)w[P_IGNORE_EMPTY];
  sp.def_off = w[P_DEF_OFF];
  sp.def_len = (int)w[P_DEF_LEN];
  sp.hash_mask = (unsigned long long)w[P_HASH_MASK];
  sp.hash_basis = (unsigned long long)w[P_HASH_BASIS];
  return sp;
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

// out int64 [n + 1]: the exclusive prefix sums of scan_value<kOnes> over
// len int32 [n], out[n] the total; scratch int64 [chunks + 1]
template <bool kOnes>
int scan_lengths(const void* len, long long n, void* scratch, void* out,
                 cudaStream_t st) {
  const long long chunks = (n + kScanChunk - 1) / kScanChunk;
  long long* sc = static_cast<long long*>(scratch);
  long long* o = static_cast<long long*>(out);
  if (chunks <= 0) {
    cudaMemsetAsync(o, 0, sizeof(long long), st);
    return last_error();
  }
  const int* l = static_cast<const int*>(len);
  block_sums_kernel<kOnes><<<(unsigned int)chunks, kThreads, 0, st>>>(l, n, sc);
  scan_kernel<<<1, kScanThreads, 0, st>>>(sc, chunks, sc);
  scan_write_kernel<kOnes><<<(unsigned int)chunks, kThreads, 0, st>>>(l, n, sc,
                                                                     o);
  return last_error();
}

}  // namespace

extern "C" {

const char* airr_parse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The stats words' count (the wrapper's int64 buffer).
int airr_stats_words() { return kStats; }

// Line index, pass 1. body: n_bytes bytes, the buffer zero-padded to a
// 16-byte multiple; tile_first: int64 [n_tiles + 1], n_tiles =
// ceil(n_bytes / 16 KB): each tile's first line ('\n' bytes before it),
// and at [n_tiles] the count of '\n' bytes.
int airr_line_count_launch(const void* body, long long n_bytes,
                           void* tile_first, void* stream) {
  const long long n_vec = (n_bytes + 15) / 16;
  const long long n_tiles = (n_vec + kTileVecs - 1) / kTileVecs;
  if (n_tiles <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* tf = static_cast<long long*>(tile_first);
  line_count_kernel<<<(unsigned int)n_tiles, kThreads, 0, st>>>(
      static_cast<const uint4*>(body), n_vec, tf);
  scan_kernel<<<1, kScanThreads, 0, st>>>(tf, n_tiles, tf);
  return last_error();
}

// Line index, pass 2: starts int64 [newlines + 2] (see
// line_starts_kernel); open_end = n_bytes + 1 when the last byte is not
// '\n', else -1.
int airr_line_starts_launch(const void* body, long long n_bytes,
                            const void* tile_first, long long newlines,
                            long long open_end, void* starts, void* stream) {
  const long long n_vec = (n_bytes + 15) / 16;
  const long long n_tiles = (n_vec + kTileVecs - 1) / kTileVecs;
  if (n_tiles <= 0) return 0;
  line_starts_kernel<<<(unsigned int)n_tiles, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(body), n_vec,
      static_cast<const long long*>(tile_first), newlines, open_end,
      static_cast<long long*>(starts));
  return last_error();
}

// Row pass over n lines (starts from the line index). spec: int64
// [kSpecWords] on the host (see the P_ words); map: the 256-entry
// residue table (int8, -1 for a byte that is no residue) on the card.
// Outputs int32 lengths (-1 for an ignored row), int64 counts, uint64
// row_hash, int64 seq_off, int64 sid_off and int32 sid_len (null
// without a sequence_id column), int32 slots [3, n]; tables keys uint64
// and rows int32 [3, n_slots] (n_slots a power of two), emptied first;
// stats uint64 [kStats].
int airr_rows_launch(const void* body, const void* starts, long long n,
                     const long long* spec, const void* map,
                     void* lengths, void* counts, void* row_hash,
                     void* seq_off, void* sid_off, void* sid_len, void* slots,
                     void* keys, void* rows, int n_slots, void* stats,
                     void* stream) {
  if (n_slots <= 0 || (n_slots & (n_slots - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)kKinds * n_slots;
  unsigned int g = blocks_for(total);
  if (g > (unsigned int)kMaxGrid) g = kMaxGrid;
  init_kernel<<<g, kThreads, 0, st>>>(
      static_cast<unsigned long long*>(keys), static_cast<int*>(rows), total,
      static_cast<unsigned long long*>(stats));
  if (n <= 0) return last_error();
  RowOut o = {static_cast<int*>(lengths),
              static_cast<long long*>(counts),
              static_cast<unsigned long long*>(row_hash),
              static_cast<long long*>(seq_off),
              static_cast<long long*>(sid_off),
              static_cast<int*>(sid_len),
              static_cast<int*>(slots)};
  row_kernel<<<blocks_for(n), kThreads, 0, st>>>(
      static_cast<const unsigned char*>(body),
      static_cast<const long long*>(starts), n, make_spec(spec),
      static_cast<const signed char*>(map), o,
      static_cast<unsigned long long*>(keys), static_cast<int*>(rows),
      (unsigned int)n_slots, static_cast<unsigned long long*>(stats));
  return last_error();
}

// Each used slot's token (tok_off int64, tok_len int32 [3, n_slots];
// -1 for an empty slot), then the kept rows (lengths >= 0) whose token
// differs from their slot's, counted into stats.
int airr_verify_launch(const void* body, const void* starts, long long n,
                       const long long* spec, const void* lengths,
                       const void* slots, const void* keys, const void* rows,
                       int n_slots, void* tok_off, void* tok_len, void* stats,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Spec sp = make_spec(spec);
  const unsigned char* b = static_cast<const unsigned char*>(body);
  const long long* s = static_cast<const long long*>(starts);
  slot_tokens_kernel<<<blocks_for((long long)kKinds * n_slots), kThreads, 0,
                       st>>>(
      b, s, sp, static_cast<const unsigned long long*>(keys),
      static_cast<const int*>(rows), (unsigned int)n_slots,
      static_cast<long long*>(tok_off), static_cast<int*>(tok_len));
  if (n > 0)
    verify_kernel<<<blocks_for(n), kThreads, 0, st>>>(
        b, s, n, sp, static_cast<const int*>(lengths),
        static_cast<const int*>(slots), (unsigned int)n_slots,
        static_cast<const long long*>(tok_off),
        static_cast<const int*>(tok_len),
        static_cast<unsigned long long*>(stats));
  return last_error();
}

// The kept rows of a row pass over n lines (lengths >= 0), m of them,
// moved into the out arrays (the row pass's layout with m rows): index
// int64 [n + 1] and scratch int64 [airr_offset_chunks(n) + 1] are the
// caller's, index[n] = m.
int airr_compact_launch(long long n, const void* lengths, const void* counts,
                        const void* row_hash, const void* seq_off,
                        const void* sid_off, const void* sid_len,
                        const void* slots, void* scratch, void* index,
                        long long m, void* o_lengths, void* o_counts,
                        void* o_row_hash, void* o_seq_off, void* o_sid_off,
                        void* o_sid_len, void* o_slots, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = scan_lengths<true>(lengths, n, scratch, index, st);
  if (err || n <= 0) return err;
  RowOut in = {const_cast<int*>(static_cast<const int*>(lengths)),
               const_cast<long long*>(static_cast<const long long*>(counts)),
               const_cast<unsigned long long*>(
                   static_cast<const unsigned long long*>(row_hash)),
               const_cast<long long*>(static_cast<const long long*>(seq_off)),
               const_cast<long long*>(static_cast<const long long*>(sid_off)),
               const_cast<int*>(static_cast<const int*>(sid_len)),
               const_cast<int*>(static_cast<const int*>(slots))};
  RowOut out = {static_cast<int*>(o_lengths),
                static_cast<long long*>(o_counts),
                static_cast<unsigned long long*>(o_row_hash),
                static_cast<long long*>(o_seq_off),
                static_cast<long long*>(o_sid_off),
                static_cast<int*>(o_sid_len),
                static_cast<int*>(o_slots)};
  compact_kernel<<<blocks_for(n), kThreads, 0, st>>>(
      n, static_cast<const long long*>(index), in, m, out);
  return last_error();
}

// slots int32 [3, n] := slot_ids int32 [3, n_slots] at each slot.
int airr_ids_launch(void* slots, long long n, const void* slot_ids,
                    int n_slots, void* stream) {
  if (n <= 0) return 0;
  ids_kernel<<<blocks_for((long long)kKinds * n), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(slots), n, static_cast<const int*>(slot_ids),
      (unsigned int)n_slots);
  return last_error();
}

// out int8 [n, lmax]: the rows' residue codes through map, then pad.
int airr_pack_launch(const void* body, const void* seq_off,
                     const void* lengths, long long n, int lmax,
                     const void* map, int pad, void* out, void* stream) {
  if (n <= 0 || lmax <= 0) return 0;
  unsigned int g = blocks_for(n * lmax);
  if (g > (unsigned int)kMaxGrid) g = kMaxGrid;
  pack_kernel<<<g, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(body),
      static_cast<const long long*>(seq_off),
      static_cast<const int*>(lengths), n, lmax,
      static_cast<const signed char*>(map), (signed char)pad,
      static_cast<signed char*>(out));
  return last_error();
}

// The chunk count of airr_offsets_launch's scratch (int64 [chunks + 1]).
long long airr_offset_chunks(long long n) {
  return (n + kScanChunk - 1) / kScanChunk;
}

// out int64 [n + 1]: the exclusive prefix sums of len int32 [n]
// (negative lengths count 0), out[n] the total.
int airr_offsets_launch(const void* len, long long n, void* scratch,
                        void* out, void* stream) {
  return scan_lengths<false>(len, n, scratch, out,
                             static_cast<cudaStream_t>(stream));
}

// dst[dst_off[t], +len[t]) := src[off[t], +len[t]) for t < n.
int airr_gather_launch(const void* src, const void* off, const void* len,
                       const void* dst_off, long long n, void* dst,
                       void* stream) {
  if (n <= 0) return 0;
  gather_kernel<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src),
      static_cast<const long long*>(off), static_cast<const int*>(len),
      static_cast<const long long*>(dst_off), n,
      static_cast<unsigned char*>(dst));
  return last_error();
}

}  // extern "C"
