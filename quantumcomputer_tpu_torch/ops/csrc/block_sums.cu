// Per-block probability sums of a planar state vector, for Hopper (sm_90a).
//
// Replaces quantumcomputer_tpu/ops/pallas_measure.py::_block_sums_kernel:
// out[b] = sum over block b of re^2 + im^2, for nblocks <= 1024 contiguous
// blocks (the JAX package's _block_geom, ported in ops/measure.py).  The
// two-level inverse-CDF pick that follows is torch glue, as it is XLA glue
// in the JAX package.
//
// What bounds it: device-memory bandwidth.  One read of the state, 2 flops
// per value, nblocks values written.  The design keeps it one pass with no
// probability vector in device memory: each CUDA block streams its
// measurement block with strided loads, accumulates per thread, and
// reduces in shared memory with a fixed tree, so the result is the same
// from run to run (no atomics).  f32 states accumulate in f32, f64 states
// in f64, and bf16 ("complex32") states in f32 with f32 sums out, as the JAX
// kernel does (pallas_measure.py:60-63, :101): each bf16 value widens
// exactly on load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;

__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }

// S: the plane type, T: the accumulation and output type.
template <typename S, typename T>
__global__ void __launch_bounds__(THREADS)
block_sums_kernel(const S* __restrict__ re, const S* __restrict__ im, T* __restrict__ out,
                  int64_t block) {
  __shared__ T partial[THREADS];
  const int64_t start = (int64_t)blockIdx.x * block;
  T acc = 0;
  for (int64_t i = threadIdx.x; i < block; i += THREADS) {
    const T r = widen(re[start + i]), m = widen(im[start + i]);
    acc += r * r + m * m;
  }
  partial[threadIdx.x] = acc;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) partial[threadIdx.x] += partial[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = partial[0];
}

template <typename S, typename T>
int launch_block_sums(const void* re, const void* im, void* out, int64_t nblocks, int64_t block,
                      void* stream) {
  if (nblocks < 1 || nblocks > (int64_t(1) << 30) || block < 1) return (int)cudaErrorInvalidValue;
  block_sums_kernel<S, T><<<(unsigned int)nblocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const S*)re, (const S*)im, (T*)out, block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qc_block_sums_f32(void* re, void* im, void* out, int64_t nblocks, int64_t block,
                                 void* stream) {
  return launch_block_sums<float, float>(re, im, out, nblocks, block, stream);
}

extern "C" int qc_block_sums_f64(void* re, void* im, void* out, int64_t nblocks, int64_t block,
                                 void* stream) {
  return launch_block_sums<double, double>(re, im, out, nblocks, block, stream);
}

// bf16 planes in, float32 sums out.
extern "C" int qc_block_sums_bf16(void* re, void* im, void* out, int64_t nblocks, int64_t block,
                                  void* stream) {
  return launch_block_sums<__nv_bfloat16, float>(re, im, out, nblocks, block, stream);
}
