// Segmented prefix-OR over a row-major (n, K) int8 plane, inclusive or
// exclusive, in one launch and one pass with decoupled look-back.
//
// Replaces: jepsen_tpu/ops/pallas_scan.py, `_scan_kernel` (launched by
// `_seg_or_pallas_padded`).  Inclusive: out[i, k] = OR of v[j, k] over j
// from the last row <= i whose start flag is set (or row 0) through i.
// Exclusive: the same OR strictly before row i, so a start row gets 0 (the
// cycle sweep's chain pass asks for this one).
//
// Bound on an H100: memory.  The function must read n*K value bytes and n
// start bytes and write n*K bytes: 2 x 256 MiB + 2 MiB at the sweep's
// (2^21, 128), 0.161 ms at 3.35 TB/s.  This kernel reads each value and
// start byte from device memory once and writes each output byte once.
// Besides that it moves one state word and K bytes of aggregate per tile
// (about 1/256 of the plane, in L2), and reads back those of the tiles its
// look-back spans, usually one.
//
// Ordered grid steps: the TPU kernel walks row blocks in order and carries
// the open segment's OR in VMEM scratch.  CUDA blocks run in no order, so
// the carry is a scan across tiles under the associative operator on
// (start seen, OR since the last start), left operand first:
//   (fa, va) + (fb, vb) = (fa | fb, fb ? vb : va | vb),
// done in a single pass with decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016):
//   - A tile is `runs * ITEMS` rows by a block of `cbw` column words (a
//     power of two, at most 256): 256 x 128 bytes at K = 128.  When the
//     words are 16 bytes it comes into shared memory by bulk asynchronous
//     copies (TMA, completing on an mbarrier), so a waiting block holds no
//     registers for its tile and several tiles are in flight on an SM.
//     Each thread owns one column word (16, 4 or 1 packed bytes: OR is
//     bitwise) and a run of ITEMS rows; neighbour threads take neighbour
//     words of a row, so each output store instruction covers whole
//     128-byte lines.  The runs' aggregates are scanned by warp shuffles
//     within a warp and through shared memory across the warps.  Runs that
//     lie after the tile's first start do not need the carry and write
//     their output before the tile looks back.  A look-back that spans
//     many aggregates (one segment over many tiles) spreads their reads
//     over the runs.
//   - Each tile publishes one state word (0 not yet, 1 aggregate,
//     2 inclusive prefix), stored with release after its K bytes of value
//     (aggregate or inclusive prefix, in two arrays) are fenced, and loaded
//     with acquire.  A tile that has seen a start publishes its aggregate
//     as its inclusive prefix at once: under the operator nothing before
//     the start reaches past it.  One state word per tile, not one per
//     column, keeps the look-back's reads small: a warp reads 32
//     predecessors' states in one load.
//   - Look-back finds the nearest predecessor that is an inclusive prefix
//     once every tile between has published its aggregate; the carry is
//     that prefix ORed with those aggregates (none have seen a start).  A
//     tile whose first row is a start needs no carry and does not look
//     back.
// Why the spin cannot deadlock: a block takes its tile id from a global
// atomic counter once it runs, not from blockIdx, so the predecessors it
// waits on took theirs earlier and are running or done.  A tile publishes
// its aggregate before it looks back, and the tiles of row tile 0 publish
// inclusive prefixes, which bounds every walk.  The wrapper zeroes the
// states and the counter on the stream before each launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;  // rows per thread run (ops/scan.py mirrors it)
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned AGGREGATE = 1;  // tile states; 0: not published yet
constexpr unsigned INCLUSIVE = 2;

// A column word: 16, 4 or 1 packed bytes of the plane.
template <typename W> struct Word;
template <> struct Word<uint4> {
  __device__ static uint4 shfl_xor(uint4 w, int d) {
    return make_uint4(__shfl_xor_sync(FULL, w.x, d),
                      __shfl_xor_sync(FULL, w.y, d),
                      __shfl_xor_sync(FULL, w.z, d),
                      __shfl_xor_sync(FULL, w.w, d));
  }
  __device__ static uint4 zero() { return make_uint4(0, 0, 0, 0); }
  __device__ static uint4 bor(uint4 a, uint4 b) {
    return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
  }
  __device__ static uint4 shfl_up(uint4 w, int d) {
    return make_uint4(__shfl_up_sync(FULL, w.x, d),
                      __shfl_up_sync(FULL, w.y, d),
                      __shfl_up_sync(FULL, w.z, d),
                      __shfl_up_sync(FULL, w.w, d));
  }
};
template <> struct Word<uint32_t> {
  __device__ static uint32_t shfl_xor(uint32_t w, int d) {
    return __shfl_xor_sync(FULL, w, d);
  }
  __device__ static uint32_t zero() { return 0u; }
  __device__ static uint32_t bor(uint32_t a, uint32_t b) { return a | b; }
  __device__ static uint32_t shfl_up(uint32_t w, int d) {
    return __shfl_up_sync(FULL, w, d);
  }
};
template <> struct Word<uint8_t> {
  __device__ static uint8_t shfl_xor(uint8_t w, int d) {
    return (uint8_t)__shfl_xor_sync(FULL, (uint32_t)w, d);
  }
  __device__ static uint8_t zero() { return 0; }
  __device__ static uint8_t bor(uint8_t a, uint8_t b) { return a | b; }
  __device__ static uint8_t shfl_up(uint8_t w, int d) {
    return (uint8_t)__shfl_up_sync(FULL, (uint32_t)w, d);
  }
};

// Segmented OR state: `seen` a start, `v` the OR since the last one.
template <typename W> struct Seg {
  bool seen;
  W v;
};
template <typename W>
__device__ __forceinline__ Seg<W> combine(Seg<W> a, Seg<W> b) {
  return {a.seen || b.seen, b.seen ? b.v : Word<W>::bor(a.v, b.v)};
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The row tile of the nearest predecessor of row tile rt (in column block
// cb) that has published its inclusive prefix, once every tile between has
// published its aggregate.  One warp reads 32 predecessors' states at
// once; every lane returns the result.
__device__ long long nearest_inclusive(const unsigned* state, long long rt,
                                       int cb, int col_blocks, int lane) {
  long long base = rt - 1;
  while (true) {
    const long long p = base - lane;
    const unsigned st =
        p >= 0 ? ld_acquire(state + p * col_blocks + cb) : INCLUSIVE;
    const unsigned done = __ballot_sync(FULL, st != 0);
    const unsigned incl = __ballot_sync(FULL, st == INCLUSIVE);
    // lanes 0 through the nearest inclusive prefix (all 32 if none)
    const unsigned span = incl ? ((incl & (0u - incl)) << 1) - 1u : FULL;
    if ((done & span) != span) continue;  // a needed state is not out yet
    if (incl) return base - (__ffs(incl) - 1);
    base -= 32;  // 32 aggregates
  }
}

// cbw is a power of two; a warp holds 32 / cbw runs of one column word
// each (cbw < 32) or 32 column words of one run.  state: (tiles,) words;
// agg, incl: (tiles, cbw) words; tile id = row tile * col_blocks + cb.
template <typename W>
__global__ void __launch_bounds__(THREADS)
seg_or_lookback(const W* __restrict__ v, const uint8_t* __restrict__ starts,
                W* __restrict__ out, unsigned* __restrict__ counter,
                unsigned* __restrict__ state, W* __restrict__ agg,
                W* __restrict__ incl, long long n, int nw, int cbw, int runs,
                int col_blocks, int exclusive) {
  using Wd = Word<W>;
  constexpr bool BULK = sizeof(W) == 16;
  __shared__ alignas(128) W tile_v[THREADS * ITEMS];  // rows of `width`
  __shared__ W grp_val[THREADS];    // (run group, column): its OR
  __shared__ bool grp_seen[WARPS];  // run group holds a start
  __shared__ unsigned s_id;
  __shared__ long long s_term;      // nearest inclusive predecessor
  __shared__ alignas(8) unsigned long long loaded;  // mbarrier of the copy

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  if (t == 0) {
    s_id = atomicAdd(counter, 1u);
    if (BULK) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem(&loaded))
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();
  const unsigned id = s_id;
  const long long rt = id / col_blocks;
  const int cb = (int)(id % col_blocks);
  const int c = t % cbw, r = t / cbw;
  const int rpw = cbw < 32 ? 32 / cbw : 1;  // runs per warp
  const int g = r / rpw, rl = r % rpw;       // run group, run within it
  const int width = min(cbw, nw - cb * cbw);  // words in this column block
  const long long col = (long long)cb * cbw + c;
  const bool mine = c < width;
  const long long tile_row = rt * runs * ITEMS;
  const int rows = (int)min((long long)runs * ITEMS, n - tile_row);

  // bring the tile into shared memory: one bulk copy (a row each when
  // the column block is narrower than the plane), or the threads' loads
  if (BULK) {
    if (t == 0) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
              smem(&loaded)),
          "r"((unsigned)(rows * width * sizeof(W)))
          : "memory");
      const int copies = width == nw ? 1 : rows;
      const unsigned bytes =
          (unsigned)((width == nw ? rows : 1) * width * sizeof(W));
      for (int q = 0; q < copies; ++q)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];" ::"r"(smem(tile_v + q * width)),
            "l"(v + (tile_row + q) * nw + (long long)cb * cbw), "r"(bytes),
            "r"(smem(&loaded))
            : "memory");
    }
  } else if (mine) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int row = r * ITEMS + i;
      if (row < rows) tile_v[row * width + c] = v[(tile_row + row) * nw + col];
    }
  }
  unsigned flags = 0;  // bit i: row r * ITEMS + i of the tile is a start
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int row = r * ITEMS + i;
    if (row < rows && starts[tile_row + row]) flags |= 1u << i;
  }
  if (BULK) {
    asm volatile(
        "{\n .reg .pred done;\n"
        "WAIT_%=:\n"
        " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
        " @!done bra WAIT_%=;\n}" ::"r"(smem(&loaded))
        : "memory");
  } else {
    __syncthreads();
  }

  // x(i): the thread's value in row r * ITEMS + i of the tile (0 past n)
  auto x = [&](int i) {
    const int row = r * ITEMS + i;
    return mine && row < rows ? tile_v[row * width + c] : Wd::zero();
  };
  Seg<W> run{flags != 0, Wd::zero()};
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    run.v = (flags >> i) & 1u ? x(i) : Wd::bor(run.v, x(i));

  // scan the runs: within the warp by shuffles, then across run groups
  Seg<W> inc = run;
  for (int d = 1; d < rpw; d <<= 1) {
    const Seg<W> up{__shfl_up_sync(FULL, inc.seen, d * cbw) != 0,
                    Wd::shfl_up(inc.v, d * cbw)};
    if (rl >= d) inc = combine(up, inc);
  }
  Seg<W> pre{false, Wd::zero()};  // the runs before this one in its group
  if (rpw > 1) {
    pre = {__shfl_up_sync(FULL, inc.seen, cbw) != 0,
           Wd::shfl_up(inc.v, cbw)};
    if (rl == 0) pre = {false, Wd::zero()};
  }
  if (rl == rpw - 1 && mine) grp_val[g * cbw + c] = inc.v;
  if (rl == rpw - 1 && c == 0) grp_seen[g] = inc.seen;
  __syncthreads();
  Seg<W> before{false, Wd::zero()};  // the run groups before this one
  for (int q = 0; q < g; ++q)
    before = combine(before, Seg<W>{grp_seen[q], grp_val[q * cbw + c]});
  pre = combine(before, pre);
  bool tile_seen = false;  // block-uniform
  for (int q = 0; q < runs / rpw; ++q) tile_seen |= grp_seen[q];

  // the tile's last run holds its aggregate: write it out first
  const Seg<W> tile = combine(pre, run);
  const bool published_inclusive = tile_seen || rt == 0;
  const bool last = mine && r == runs - 1;
  if (last) {
    (published_inclusive ? incl : agg)[(long long)id * cbw + c] = tile.v;
    __threadfence();
  }

  // walk the run from `acc` (what reaches its first row), resetting at
  // starts, and write the output
  auto write = [&](W acc) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int row = r * ITEMS + i;
      const bool s = (flags >> i) & 1u;
      const W xi = x(i);
      W o;
      if (exclusive) {
        o = s ? Wd::zero() : acc;
        acc = s ? xi : Wd::bor(acc, xi);
      } else {
        acc = s ? xi : Wd::bor(acc, xi);
        o = acc;
      }
      if (row < rows) out[(tile_row + row) * nw + col] = o;
    }
  };
  // a run after the tile's first start does not need the carry: its
  // stores go out while the tile looks back
  if (mine && pre.seen) write(pre.v);
  __syncthreads();

  const bool need = rt > 0 && !starts[tile_row];
  if (warp == 0) {
    if (lane == 0)
      st_release(state + id, published_inclusive ? INCLUSIVE : AGGREGATE);
    if (need) {
      const long long term =
          nearest_inclusive(state, rt, cb, col_blocks, lane);
      if (lane == 0) s_term = term;
    }
  }
  __syncthreads();

  // the carry: the nearest inclusive prefix ORed with the aggregates
  // between.  The values were fenced before their states were released;
  // read them past L1, which holds no copy of a line another SM wrote.
  W cin = Wd::zero();
  if (need) {
    const long long term = s_term;
    auto incl_at = [&](long long p) {
      return __ldcg(&incl[(p * col_blocks + cb) * cbw + c]);
    };
    if (term == rt - 1) {
      if (mine) cin = incl_at(term);
    } else {
      // a long span (one segment over many tiles): the runs take the
      // aggregates in turn, then OR across the warp and the run groups
      W a = Wd::zero();
      if (mine) {
        for (long long p = term + 1 + r; p < rt; p += runs)
          a = Wd::bor(a, __ldcg(&agg[(p * col_blocks + cb) * cbw + c]));
        if (r == 0) a = Wd::bor(a, incl_at(term));
      }
      for (int d = cbw; d < 32; d <<= 1)
        a = Wd::bor(a, Wd::shfl_xor(a, d));
      if (rl == 0 && mine) grp_val[g * cbw + c] = a;
      __syncthreads();
      if (mine)
        for (int q = 0; q < runs / rpw; ++q)
          cin = Wd::bor(cin, grp_val[q * cbw + c]);
    }
  }
  if (need && !tile_seen) {  // publish the inclusive prefix
    if (last) {
      incl[(long long)id * cbw + c] = Wd::bor(cin, tile.v);
      __threadfence();
    }
    __syncthreads();
    if (t == 0) st_release(state + id, INCLUSIVE);
  }
  if (mine && !pre.seen) write(Wd::bor(cin, pre.v));
}

template <typename W>
void launch(const void* v, const uint8_t* starts, void* out,
            unsigned* counter, unsigned* state, void* values, long long n,
            int nw, int cbw, int runs, long long tiles, int col_blocks,
            int exclusive, cudaStream_t s) {
  W* agg = (W*)values;
  seg_or_lookback<W><<<(unsigned)tiles, THREADS, 0, s>>>(
      (const W*)v, starts, (W*)out, counter, state, agg, agg + tiles * cbw,
      n, nw, cbw, runs, col_blocks, exclusive);
}

}  // namespace

extern "C" {

// word: bytes per column word (16, 4 or 1); K % word == 0 and the value
// and output pointers are word-aligned.  cbw: words per column block;
// runs: row runs of ITEMS rows per tile; tiles = row tiles * col_blocks.
// states: 1 + tiles uint32 (the tile counter, then the tiles' states),
// zeroed here before the launch; values: 2 * tiles * cbw words.
// ops/scan.py's `seg_or_geometry` computes all of these.
int jt_seg_or_int8(const void* v, const uint8_t* starts, void* out,
                   unsigned* states, void* values, long long n, int k,
                   int word, int cbw, int runs, long long tiles,
                   int col_blocks, int exclusive, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(states, 0, (1 + tiles) * 4, s);
  if (e != cudaSuccess) return (int)e;
  const int nw = k / word;
  if (word == 16)
    launch<uint4>(v, starts, out, states, states + 1, values, n, nw, cbw,
                  runs, tiles, col_blocks, exclusive, s);
  else if (word == 4)
    launch<uint32_t>(v, starts, out, states, states + 1, values, n, nw, cbw,
                     runs, tiles, col_blocks, exclusive, s);
  else
    launch<uint8_t>(v, starts, out, states, states + 1, values, n, nw, cbw,
                    runs, tiles, col_blocks, exclusive, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
