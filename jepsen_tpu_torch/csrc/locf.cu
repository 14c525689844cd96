// Flat forward-fill (LOCF, "last observation carried forward") of int32,
// in one launch and one pass with decoupled look-back.
//
// Replaces: jepsen_tpu/ops/pallas_fill.py, `_fill_kernel` (launched by
// `_locf_pallas_padded`).  out[i] = x[j] for the largest j <= i with
// x[j] != -1 (the hole), else -1.
//
// Bound on an H100: memory.  The function must read n int32 and write n
// int32: 128 MiB at n = 2^24, 0.040 ms at 3.35 TB/s; it does no arithmetic
// worth counting.  This kernel reads each element from device memory once
// (16-byte loads, each warp's load instruction one contiguous 512-byte
// span) and writes each once; besides that it moves one uint64 status word
// per 4096-element tile (32 KiB at 2^24, in L2).
//
// Ordered grid steps: the TPU kernel walks its grid in order and carries
// the running value from block to block in VMEM scratch.  CUDA blocks run
// in no order, so the carry is a scan across tiles under the associative
// operator "the right operand wins unless it is a hole", done in a single
// pass with decoupled look-back (Merrill and Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", 2016):
//   - Each thread fills its own 16 elements, a warp-shuffle scan joins the
//     threads of a warp, and one shared-memory exchange of the 8 warp
//     totals joins the warps of the tile.
//   - Each tile has one uint64 status: the value in the low 32 bits, the
//     state in the high 32 (0 not published yet, 1 aggregate, 2 inclusive
//     prefix), stored with release and loaded with acquire.  A tile that
//     holds a non-hole publishes its last one as its inclusive prefix at
//     once: it wins over everything before it.  So an aggregate is always
//     all holes, and a tile's carry is the value of its nearest
//     predecessor that is an inclusive prefix.
//   - One warp reads 32 predecessors' statuses at once and finds that
//     predecessor with `__ballot_sync`.  A tile whose first element is not
//     a hole needs no carry and does not look back.  An all-hole tile
//     publishes its inclusive prefix (the carry) as soon as it knows it,
//     so an all-hole history's walks stay short, and tile 0's inclusive
//     prefix bounds every walk.
// Why the spin cannot deadlock: a block takes its tile id from a global
// atomic counter once it runs, not from blockIdx, so the predecessors it
// waits on took theirs earlier and are running or done, and each publishes
// before it looks back.  The wrapper zeroes the status words and the
// counter on the stream before each launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HOLE = -1;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 4;                         // int32 per 16-byte access
constexpr int GROUPS = 4;                      // 16-byte accesses per thread
constexpr int WARP_SPAN = 32 * VEC * GROUPS;   // 512 elements
constexpr int TILE = WARPS * WARP_SPAN;        // 4096 (ops/fill.py mirrors it)
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long AGGREGATE = 1ull << 32;
constexpr unsigned long long INCLUSIVE = 2ull << 32;

__device__ __forceinline__ int locf_op(int left, int right) {
  return right != HOLE ? right : left;
}

__device__ __forceinline__ unsigned long long packed(unsigned long long state,
                                                     int value) {
  return state | (uint32_t)value;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// The value of the nearest predecessor of `tile` that is an inclusive
// prefix.  One warp; every lane returns the result.
__device__ int look_back(const unsigned long long* status, long long tile,
                         int lane) {
  long long base = tile - 1;
  while (true) {
    const long long p = base - lane;
    const unsigned long long s =
        p >= 0 ? ld_acquire(status + p) : packed(INCLUSIVE, HOLE);
    const unsigned state = (unsigned)(s >> 32);
    const unsigned done = __ballot_sync(FULL, state != 0);
    const unsigned incl = __ballot_sync(FULL, state == 2);
    // lanes 0 through the nearest inclusive prefix (all 32 if none)
    const unsigned span = incl ? ((incl & (0u - incl)) << 1) - 1u : FULL;
    if ((done & span) != span) continue;  // a needed status is not out yet
    if (incl) return __shfl_sync(FULL, (int)(uint32_t)s, __ffs(incl) - 1);
    base -= 32;  // 32 all-hole aggregates
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
locf_lookback(const int* __restrict__ x, int* __restrict__ out,
              unsigned long long* __restrict__ status,
              unsigned* __restrict__ counter, long long n) {
  __shared__ int warp_total[WARPS];
  __shared__ int s_carry;
  __shared__ unsigned s_tile;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long base = tile * TILE + (long long)warp * WARP_SPAN;

  int val[GROUPS][VEC];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const long long i = base + (long long)(g * 32 + lane) * VEC;
    if (ALIGNED && i + VEC <= n) {
      const int4 q = __ldcs(reinterpret_cast<const int4*>(x + i));
      val[g][0] = q.x; val[g][1] = q.y; val[g][2] = q.z; val[g][3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) val[g][e] = i + e < n ? x[i + e] : HOLE;
    }
  }

  // fill from the start of the warp's span: holes stay holes until the
  // span's first non-hole
  int run = HOLE;  // fill value at the end of the warp's earlier groups
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    int mine = HOLE;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      mine = locf_op(mine, val[g][e]);
      val[g][e] = mine;
    }
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl = locf_op(up, incl);
    }
    int excl = __shfl_up_sync(FULL, incl, 1);
    excl = locf_op(run, lane == 0 ? HOLE : excl);
#pragma unroll
    for (int e = 0; e < VEC; ++e) val[g][e] = locf_op(excl, val[g][e]);
    run = locf_op(run, __shfl_sync(FULL, incl, 31));
  }
  if (lane == 0) warp_total[warp] = run;
  __syncthreads();

  int agg = HOLE, before = HOLE;  // the tile's; the warps' before this one
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (w == warp) before = agg;
    agg = locf_op(agg, warp_total[w]);
  }
  if (warp == 0) {
    if (lane == 0)
      st_release(status + tile,
                 packed(agg != HOLE || tile == 0 ? INCLUSIVE : AGGREGATE, agg));
    // lane 0's first element, still its own value
    const bool need = tile > 0 && __shfl_sync(FULL, val[0][0], 0) == HOLE;
    int carry = HOLE;
    if (need) {
      carry = look_back(status, tile, lane);
      if (lane == 0 && agg == HOLE)
        st_release(status + tile, packed(INCLUSIVE, carry));
    }
    if (lane == 0) s_carry = carry;
  }
  __syncthreads();

  const int cin = locf_op(s_carry, before);
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const long long i = base + (long long)(g * 32 + lane) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) val[g][e] = locf_op(cin, val[g][e]);
    if (ALIGNED && i + VEC <= n) {
      __stcs(reinterpret_cast<int4*>(out + i),
             make_int4(val[g][0], val[g][1], val[g][2], val[g][3]));
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (i + e < n) out[i + e] = val[g][e];
    }
  }
}

}  // namespace

extern "C" {

// scratch: 1 + ceil(n / 4096) uint64 words, zeroed here before the launch
// (the first holds the tile counter).  aligned: x and out are 16-byte
// aligned.  ops/fill.py's `locf_geometry` computes the scratch size.
int jt_locf_int32(const int* x, int* out, unsigned long long* scratch,
                  long long n, int aligned, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (n + TILE - 1) / TILE;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (1 + tiles) * 8, s);
  if (e != cudaSuccess) return (int)e;
  unsigned* counter = (unsigned*)scratch;
  if (aligned)
    locf_lookback<true><<<(unsigned)tiles, THREADS, 0, s>>>(
        x, out, scratch + 1, counter, n);
  else
    locf_lookback<false><<<(unsigned)tiles, THREADS, 0, s>>>(
        x, out, scratch + 1, counter, n);
  return (int)cudaGetLastError();
}

const char* jt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
