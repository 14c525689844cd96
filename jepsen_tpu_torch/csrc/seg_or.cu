// Inclusive segmented prefix-OR over a row-major (n, K) int8 plane.
//
// Replaces: jepsen_tpu/ops/pallas_scan.py, `_scan_kernel` (launched by
// `_seg_or_pallas_padded`).  out[i, k] = OR of v[j, k] over j from the last
// row <= i whose start flag is set (or row 0) through i.
//
// Bound on an H100: memory.  The function must read n*K bytes of values and
// n start bytes and write n*K bytes (256 MiB each way at the sweep's
// (2^21, 128)).  This design reads the values twice (passes 1 and 3), so it
// moves about 1.5x that; the per-chunk aggregates are n*K / chunk_rows bytes.
//
// Ordered grid steps: the TPU kernel walks row blocks in order and carries
// the open segment's OR in VMEM scratch.  CUDA blocks run in no order, so
// the carry becomes a real scan across chunks of rows, done as
// reduce-then-scan in three launches over the associative operator on
// (start seen, OR since the last start):
//   (fa, va) + (fb, vb) = (fa | fb, fb ? vb : va | vb).
//   1. seg_or_reduce - per (chunk, column word): the chunk's aggregate;
//   2. seg_or_carry  - per column word, one block scans the chunk aggregates
//                      into an exclusive carry per chunk;
//   3. seg_or_apply  - per (chunk, column word): walk the rows again from the
//                      carry, resetting at starts, and write the output.
// OR is bitwise, so one thread owns a column word of 16, 4 or 1 packed bytes
// and ORs them as one; consecutive threads take consecutive words of a row,
// so loads and stores coalesce.  Any K >= 1 is taken: the wrapper picks the
// widest word that divides K and the alignment of the pointers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CARRY_THREADS = 1024;

__device__ __forceinline__ uint4 word_or(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint32_t word_or(uint32_t a, uint32_t b) { return a | b; }
__device__ __forceinline__ uint8_t word_or(uint8_t a, uint8_t b) { return a | b; }

template <typename W> __device__ __forceinline__ W word_zero();
template <> __device__ __forceinline__ uint4 word_zero<uint4>() { return make_uint4(0, 0, 0, 0); }
template <> __device__ __forceinline__ uint32_t word_zero<uint32_t>() { return 0u; }
template <> __device__ __forceinline__ uint8_t word_zero<uint8_t>() { return 0; }

// v, out: (n, nw) words; starts: (n,) bytes; agg: (n_chunks, nw) words;
// seen: (n_chunks,) bytes.
template <typename W>
__global__ void seg_or_reduce(const W* __restrict__ v,
                              const uint8_t* __restrict__ starts,
                              W* __restrict__ agg, uint8_t* __restrict__ seen,
                              long long n, int nw, int chunk_rows,
                              long long n_chunks) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= n_chunks * nw) return;
  const long long c = tid / nw;
  const int w = (int)(tid % nw);
  const long long r0 = c * chunk_rows;
  const long long r1 = r0 + chunk_rows < n ? r0 + chunk_rows : n;
  W acc = word_zero<W>();
  uint8_t f = 0;
  for (long long r = r0; r < r1; ++r) {
    W x = v[r * nw + w];
    if (starts[r]) { acc = x; f = 1; } else { acc = word_or(acc, x); }
  }
  agg[c * nw + w] = acc;
  if (w == 0) seen[c] = f;
}

// One block per column word: carry[c, w] = OR of the segment open at the
// end of chunk c - 1 (0 for chunk 0).
template <typename W>
__global__ void seg_or_carry(const W* __restrict__ agg,
                             const uint8_t* __restrict__ seen,
                             W* __restrict__ carry, long long n_chunks, int nw) {
  __shared__ W sv[CARRY_THREADS];
  __shared__ uint8_t sf[CARRY_THREADS];
  const int w = blockIdx.x;
  const int t = threadIdx.x;
  const long long per = (n_chunks + blockDim.x - 1) / blockDim.x;
  const long long c0 = t * per;
  const long long c1 = c0 + per < n_chunks ? c0 + per : n_chunks;
  W acc = word_zero<W>();
  uint8_t f = 0;
  for (long long c = c0; c < c1; ++c) {
    W x = agg[c * nw + w];
    if (seen[c]) { acc = x; f = 1; } else { acc = word_or(acc, x); }
  }
  sv[t] = acc;
  sf[t] = f;
  __syncthreads();
  // inclusive Hillis-Steele scan of the per-thread aggregates
  for (int d = 1; d < blockDim.x; d <<= 1) {
    W lv = word_zero<W>();
    uint8_t lf = 0;
    if (t >= d) { lv = sv[t - d]; lf = sf[t - d]; }
    __syncthreads();
    if (t >= d && !sf[t]) { sv[t] = word_or(lv, sv[t]); sf[t] = lf; }
    __syncthreads();
  }
  W run = t > 0 ? sv[t - 1] : word_zero<W>();
  for (long long c = c0; c < c1; ++c) {
    carry[c * nw + w] = run;
    W x = agg[c * nw + w];
    run = seen[c] ? x : word_or(run, x);
  }
}

template <typename W>
__global__ void seg_or_apply(const W* __restrict__ v,
                             const uint8_t* __restrict__ starts,
                             const W* __restrict__ carry, W* __restrict__ out,
                             long long n, int nw, int chunk_rows,
                             long long n_chunks) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= n_chunks * nw) return;
  const long long c = tid / nw;
  const int w = (int)(tid % nw);
  const long long r0 = c * chunk_rows;
  const long long r1 = r0 + chunk_rows < n ? r0 + chunk_rows : n;
  W acc = carry[c * nw + w];
  for (long long r = r0; r < r1; ++r) {
    W x = v[r * nw + w];
    acc = starts[r] ? x : word_or(acc, x);
    out[r * nw + w] = acc;
  }
}

template <typename W>
void launch(const void* v, const uint8_t* starts, void* out, void* agg,
            void* carry, uint8_t* seen, long long n, int nw, int chunk_rows,
            cudaStream_t s) {
  const long long n_chunks = (n + chunk_rows - 1) / chunk_rows;
  const long long work = n_chunks * nw;
  const unsigned grid = (unsigned)((work + THREADS - 1) / THREADS);
  seg_or_reduce<W><<<grid, THREADS, 0, s>>>(
      (const W*)v, starts, (W*)agg, seen, n, nw, chunk_rows, n_chunks);
  seg_or_carry<W><<<nw, CARRY_THREADS, 0, s>>>(
      (const W*)agg, seen, (W*)carry, n_chunks, nw);
  seg_or_apply<W><<<grid, THREADS, 0, s>>>(
      (const W*)v, starts, (const W*)carry, (W*)out, n, nw, chunk_rows,
      n_chunks);
}

}  // namespace

extern "C" {

// word: bytes per column word (16, 4 or 1); K % word == 0 and every pointer
// is word-aligned (the wrapper checks).  agg and carry hold
// ceil(n / chunk_rows) * K bytes each, seen ceil(n / chunk_rows) bytes.
int jt_seg_or_int8(const void* v, const uint8_t* starts, void* out, void* agg,
                   void* carry, uint8_t* seen, long long n, int k, int word,
                   int chunk_rows, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int nw = k / word;
  if (word == 16)
    launch<uint4>(v, starts, out, agg, carry, seen, n, nw, chunk_rows, s);
  else if (word == 4)
    launch<uint32_t>(v, starts, out, agg, carry, seen, n, nw, chunk_rows, s);
  else
    launch<uint8_t>(v, starts, out, agg, carry, seen, n, nw, chunk_rows, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
