// Flat forward-fill (LOCF, "last observation carried forward") of int32.
//
// Replaces: jepsen_tpu/ops/pallas_fill.py, `_fill_kernel` (launched by
// `_locf_pallas_padded`).  out[i] = x[j] for the largest j <= i with
// x[j] != -1 (the hole), else -1.
//
// Bound on an H100: memory.  The function must read n int32 and write n
// int32 (128 MiB at n = 2^24); it does no arithmetic worth counting.  This
// design moves 1.5x that: pass 1 reads x, pass 3 reads x again and writes
// out (pass 2 touches one int per 4096 elements).
//
// Ordered grid steps: the TPU kernel walks its grid in order and carries
// the running value from block to block in VMEM scratch.  CUDA blocks run
// in no order, so the carry becomes a real scan across blocks, done as
// reduce-then-scan in three launches over the associative operator
// "the right operand wins unless it is a hole":
//   1. locf_chunk_last  - each block writes its chunk's last non-hole value;
//   2. locf_chunk_carry - one block scans those into an exclusive carry per
//                         chunk;
//   3. locf_fill        - each block fills its chunk, starting from its carry.
// Any n >= 0 is taken; the ragged tail of the last chunk is masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HOLE = -1;
constexpr int THREADS = 256;
constexpr int ITEMS = 16;                      // per thread, contiguous in pass 3
constexpr int CHUNK = THREADS * ITEMS;         // 4096 elements per block
constexpr int CARRY_THREADS = 1024;

__device__ __forceinline__ int locf_op(int left, int right) {
  return right != HOLE ? right : left;
}

// Shared-memory index with one pad word per 32, so that thread t reading
// element t * ITEMS + j (its own contiguous run) hits distinct banks.
__device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

// Inclusive Hillis-Steele scan of s[0..blockDim.x) under locf_op.
__device__ void block_scan_locf(int* s) {
  const int t = threadIdx.x;
  for (int d = 1; d < blockDim.x; d <<= 1) {
    int left = t >= d ? s[t - d] : HOLE;
    __syncthreads();
    if (t >= d) s[t] = locf_op(left, s[t]);
    __syncthreads();
  }
}

__global__ void locf_chunk_last(const int* __restrict__ x,
                                int* __restrict__ chunk_last, long long n) {
  __shared__ long long best[THREADS];
  const long long base = (long long)blockIdx.x * CHUNK;
  long long mine = -1;
  for (int j = 0; j < ITEMS; ++j) {
    long long i = base + (long long)j * THREADS + threadIdx.x;
    if (i < n && x[i] != HOLE) mine = i;        // i grows with j
  }
  best[threadIdx.x] = mine;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half && best[threadIdx.x + half] > best[threadIdx.x])
      best[threadIdx.x] = best[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) chunk_last[blockIdx.x] = best[0] >= 0 ? x[best[0]] : HOLE;
}

// One block: chunk_carry[c] = LOCF of chunk_last[0..c), HOLE for c = 0.
__global__ void locf_chunk_carry(const int* __restrict__ chunk_last,
                                 int* __restrict__ chunk_carry,
                                 long long n_chunks) {
  __shared__ int s[CARRY_THREADS];
  const int t = threadIdx.x;
  const long long per = (n_chunks + blockDim.x - 1) / blockDim.x;
  const long long c0 = t * per;
  const long long c1 = c0 + per < n_chunks ? c0 + per : n_chunks;
  int local = HOLE;
  for (long long c = c0; c < c1; ++c) local = locf_op(local, chunk_last[c]);
  s[t] = local;
  __syncthreads();
  block_scan_locf(s);
  int run = t > 0 ? s[t - 1] : HOLE;
  for (long long c = c0; c < c1; ++c) {
    chunk_carry[c] = run;
    run = locf_op(run, chunk_last[c]);
  }
}

__global__ void locf_fill(const int* __restrict__ x,
                          const int* __restrict__ chunk_carry,
                          int* __restrict__ out, long long n) {
  __shared__ int vals[CHUNK + CHUNK / 32];
  __shared__ int agg[THREADS];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * CHUNK;
  // coalesced load into shared memory
  for (int j = 0; j < ITEMS; ++j) {
    int p = j * THREADS + t;
    long long i = base + p;
    vals[skew(p)] = i < n ? x[i] : HOLE;
  }
  __syncthreads();
  // each thread owns the contiguous run [t * ITEMS, (t + 1) * ITEMS)
  int last = HOLE;
  for (int j = 0; j < ITEMS; ++j) last = locf_op(last, vals[skew(t * ITEMS + j)]);
  agg[t] = last;
  __syncthreads();
  block_scan_locf(agg);
  int run = locf_op(chunk_carry[blockIdx.x], t > 0 ? agg[t - 1] : HOLE);
  for (int j = 0; j < ITEMS; ++j) {
    int p = skew(t * ITEMS + j);
    run = locf_op(run, vals[p]);
    vals[p] = run;
  }
  __syncthreads();
  for (int j = 0; j < ITEMS; ++j) {
    int p = j * THREADS + t;
    long long i = base + p;
    if (i < n) out[i] = vals[skew(p)];
  }
}

}  // namespace

extern "C" {

// Scratch: chunk_last and chunk_carry hold jt_locf_chunks(n) ints each.
long long jt_locf_chunks(long long n) { return (n + CHUNK - 1) / CHUNK; }

int jt_locf_int32(const int* x, int* out, int* chunk_last, int* chunk_carry,
                  long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_chunks = jt_locf_chunks(n);
  locf_chunk_last<<<(unsigned)n_chunks, THREADS, 0, s>>>(x, chunk_last, n);
  locf_chunk_carry<<<1, CARRY_THREADS, 0, s>>>(chunk_last, chunk_carry, n_chunks);
  locf_fill<<<(unsigned)n_chunks, THREADS, 0, s>>>(x, chunk_carry, out, n);
  return (int)cudaGetLastError();
}

const char* jt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
