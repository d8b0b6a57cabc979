// Probe kernels of the chunk-gather and lane-rotate microbenchmarks, for
// Hopper (sm_90a).  float32 only, as the TPU probes are.
//
// Replaces the Pallas probes of scripts/prof_chunkgather.py (_copy_kernel,
// _roll2_kernel, _mxuroll_kernel) and scripts/prof_rowperm.py (kern, kern2).
// x is a flat plane of `dim` floats; a chunk probe writes NC chunks of W
// floats, chunk i from start s_i (int32), every start first clamped into
// [0, dim - W] (the plain versions in ops/probes.py clamp the same way):
//
//   copy     out[i*W + e] = x[(s_i >> 10 << 10) + e]   (1024-aligned tiles)
//   roll2    out[i*W + e] = x[s_i + e]                 (any start)
//   mxuroll  the same function as roll2
//   dynroll  (B, 8, 128): out[b,k,l] = x[b,k,(l + c_b) mod 128]
//   rowroll  (B, 8, 128): out[b,k,l] = x[b,k,(l + c_{8b+k}) mod 128]
//
// What bounds them: device-memory bandwidth; each output element is one
// read and one write, nothing else.  The designs answer what each TPU probe
// asked of its hardware, in the card's terms:
//
//   * copy: the TPU's DMA ceiling.  16-byte streaming loads and stores from
//     the rounded-down start; one block per 1024-float tile of a chunk.
//   * roll2: "DMA aligned tiles, realign on chip".  The block stages the
//     16-byte aligned window [s - s mod 4, s + 1024 + 4) of its tile in
//     shared memory with float4 loads, then writes the tile shifted by
//     s mod 4 with float4 stores.
//   * mxuroll: the lane rotation done by the matrix unit.  Output row p of
//     a chunk is x row p + row0 rotated by r = s mod 128, except that lanes
//     k < r come from the row after it: out row p = X'_p P, with X'_p[k] =
//     x[row0 + p + (k < r)][k] and the 0/1 permutation matrix P[k][q] =
//     (k - r) mod 128 == q, a tensor-core product (mma.sync.m16n8k8 in
//     float64 on values widened from float32: one term of each sum is 1 * x
//     and the rest 0 * y, so the product is exact for finite inputs and
//     narrows back to the same float32; TF32 would drop mantissa bits).
//     One block walks MX_ROWS = 128 output rows (16 tiles) of a chunk: it
//     stages those rows and the one after them (when r > 0) once, no row
//     twice, by one 512-byte cp.async.bulk a row into padded shared rows
//     (pitch 132 floats: the 8 rows of a fragment on distinct banks), with
//     an mbarrier a 16-row step, all issued at the start, so every copy of
//     the block is in flight before the first product.  A step is 16
//     output rows: each warp takes two 8-column blocks, each two k-steps of
//     8 (the 16 source lanes that hold its nonzeros), with P generated in
//     registers; the row after a step is the next step's first, already
//     staged.  Each thread swaps half of its results with its neighbour
//     (one shuffle) and writes 4 consecutive floats of one row with a
//     16-byte streaming store, straight from registers.
//   * dynroll, rowroll: one warp per 128-float row, each lane reading
//     x[(l + c) & 127] for its 4 lanes; a warp's loads cover the row once.
//
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 1024;      // floats of one chunk tile: one float4 per thread
constexpr int LANE = 128;
constexpr int TILE_ROWS = TILE / LANE;  // 8 output rows per tile
constexpr int MX_ROWS = 128;            // mxuroll: output rows of a block (16 tiles)
constexpr int MX_STEP = 16;             // output rows of one m16 product step
constexpr int MX_PITCH = LANE + 4;      // staged row pitch, floats
constexpr int MX_BARS = MX_ROWS / MX_STEP;
constexpr size_t MX_SMEM = (size_t)(MX_ROWS + 1) * MX_PITCH * sizeof(float) + MX_BARS * sizeof(uint64_t);

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(THREADS)
copy_kernel(const float* __restrict__ x, const int32_t* __restrict__ starts, float* __restrict__ out,
            int64_t dim, int64_t W) {
  const int64_t i = blockIdx.x;
  const int64_t e = (int64_t)blockIdx.y * TILE + threadIdx.x * 4;
  const int64_t base = clamp64(((int64_t)starts[i] >> 10) * 1024, 0, dim - W);
  const float4 v = __ldcs(reinterpret_cast<const float4*>(x + base + e));
  __stcs(reinterpret_cast<float4*>(out + i * W + e), v);
}

__global__ void __launch_bounds__(THREADS)
roll2_kernel(const float* __restrict__ x, const int32_t* __restrict__ starts, float* __restrict__ out,
             int64_t dim, int64_t W) {
  __shared__ float4 stage[TILE / 4 + 1];
  const int64_t i = blockIdx.x;
  const int64_t t0 = (int64_t)blockIdx.y * TILE;
  const int64_t s = clamp64(starts[i], 0, dim - W);
  const int shift = (int)(s & 3);
  const int64_t a = s - shift + t0;  // 16-byte aligned window start
  for (int v = threadIdx.x; v < TILE / 4 + 1; v += THREADS) {
    const int64_t at = a + 4 * (int64_t)v;
    stage[v] = at < dim ? *reinterpret_cast<const float4*>(x + at) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  const float* st = reinterpret_cast<const float*>(stage) + shift + threadIdx.x * 4;
  __stcs(reinterpret_cast<float4*>(out + i * W + t0 + threadIdx.x * 4), make_float4(st[0], st[1], st[2], st[3]));
}

// d (16 x 8) += a (16 x 8) b (8 x 8), float64.  Fragments (as .tf32's
// m16n8k8): a0..a3 at (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b0, b1 at
// (t, g), (t + 4, g); d0..d3 at (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1),
// for lane = 4 g + t.
__device__ __forceinline__ void mma_f64_m16n8k8(double (&d)[4], const double (&a)[4], const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Block (i, y): chunk i's output rows [128 y, 128 y + rows) (see the header).
__global__ void __launch_bounds__(THREADS)
mxuroll_kernel(const float* __restrict__ x, const int32_t* __restrict__ starts, float* __restrict__ out,
               int64_t dim, int64_t W) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);  // staged row k at stage + k * MX_PITCH
  const uint32_t bars = smem_u32(smem + (size_t)(MX_ROWS + 1) * MX_PITCH * sizeof(float));
  const int64_t i = blockIdx.x;
  const int64_t s = clamp64(starts[i], 0, dim - W);
  const int r = (int)(s & (LANE - 1));
  const int64_t orow0 = (int64_t)blockIdx.y * MX_ROWS;  // the block's first output row in the chunk
  const int rows = (int)(W / LANE - orow0 < MX_ROWS ? W / LANE - orow0 : MX_ROWS);  // a multiple of 8
  const int nsteps = (rows + MX_STEP - 1) / MX_STEP;
  const int staged = rows + (r > 0);  // the row after the last is read only for lanes k < r
  const float* src = x + ((s >> 7) + orow0) * LANE;

  // Step j's barrier counts the bytes of staged rows [16 j, 16 j + 16), the
  // last step's also the row after them.
  if (threadIdx.x == 0) {
    for (int j = 0; j < nsteps; ++j) mbar_init(bars + 8 * j, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < nsteps; ++j) {
      const int hi = j == nsteps - 1 ? staged : MX_STEP * (j + 1);
      mbar_expect_tx(bars + 8 * j, (uint32_t)(hi - MX_STEP * j) * LANE * sizeof(float));
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    for (int k = threadIdx.x; k < staged; k += 32) {
      const int j = k / MX_STEP < nsteps ? k / MX_STEP : nsteps - 1;
      bulk_copy(smem_u32(stage + k * MX_PITCH), src + (int64_t)k * LANE, LANE * sizeof(float), bars + 8 * j);
    }
  }

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
  float* dst = out + i * W + orow0 * LANE;
  for (int j = 0; j < nsteps; ++j) {
    mbar_wait(bars + 8 * j, 0);
    if (j + 1 < nsteps) mbar_wait(bars + 8 * (j + 1), 0);  // its first row is this step's row 16
    const float* st = stage + MX_STEP * j * MX_PITCH;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q0 = 16 * w + 8 * h;  // this 8-column block
      const int k0 = ((q0 + r) & (LANE - 1)) & ~7;  // its nonzeros lie in k-steps k0, k0 + 8
      double d[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int ka = ((k0 + 8 * ks) & (LANE - 1)) + t, kb = ka + 4;
        const int ra = g + (ka < r), rb = g + (kb < r);  // lanes below r: the next row
        const double a[4] = {st[ra * MX_PITCH + ka], st[(ra + 8) * MX_PITCH + ka], st[rb * MX_PITCH + kb],
                             st[(rb + 8) * MX_PITCH + kb]};
        const double b[2] = {((ka - r) & (LANE - 1)) == q0 + g ? 1.0 : 0.0,
                             ((kb - r) & (LANE - 1)) == q0 + g ? 1.0 : 0.0};
        mma_f64_m16n8k8(d, a, b);
      }
      // Even t keeps row g, columns 2t, 2t + 1, and takes 2t + 2, 2t + 3 from
      // its neighbour; odd t keeps row g + 8, columns 2t, 2t + 1, and takes 2t - 2, 2t - 1.
      const float x0 = (float)(odd ? d[0] : d[2]), x1 = (float)(odd ? d[1] : d[3]);
      const float y0 = __shfl_xor_sync(0xffffffffu, x0, 1), y1 = __shfl_xor_sync(0xffffffffu, x1, 1);
      const int p = MX_STEP * j + g + (odd ? 8 : 0);
      const int q = q0 + 2 * t - (odd ? 2 : 0);
      const float4 v = odd ? make_float4(y0, y1, (float)d[2], (float)d[3])
                           : make_float4((float)d[0], (float)d[1], y0, y1);
      if (p < rows) __stcs(reinterpret_cast<float4*>(dst + (int64_t)p * LANE + q), v);
    }
  }
}

template <bool PER_ROW>
__global__ void __launch_bounds__(THREADS)
roll_kernel(const float* __restrict__ x, const int32_t* __restrict__ shifts, float* __restrict__ out,
            int64_t rows) {
  const int64_t row = (int64_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int c = PER_ROW ? shifts[row] : shifts[row >> 3];
  const float* src = x + row * LANE;
  float* dst = out + row * LANE;
#pragma unroll
  for (int k = 0; k < LANE / 32; ++k) {
    const int l = lane + 32 * k;
    dst[l] = src[(l + c) & (LANE - 1)];
  }
}

bool chunk_args_ok(int64_t dim, int64_t nc, int64_t W) {
  return W > 0 && W % TILE == 0 && W / TILE <= 65535 && dim % TILE == 0 && dim >= W && nc >= 1 &&
         nc <= 0x7fffffff;
}

template <typename K>
int launch_chunk(K kernel, const void* x, const void* starts, void* out, int64_t dim, int64_t nc, int64_t W,
                 void* stream) {
  if (!chunk_args_ok(dim, nc, W)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)nc, (unsigned int)(W / TILE));
  kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>((const float*)x, (const int32_t*)starts, (float*)out, dim, W);
  return (int)cudaGetLastError();
}

// mxuroll: one block a 128-row group of a chunk, its staged rows in dynamic shared memory.
int launch_mxuroll(const void* x, const void* starts, void* out, int64_t dim, int64_t nc, int64_t W, void* stream) {
  if (!chunk_args_ok(dim, nc, W)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mxuroll_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)nc, (unsigned int)((W / LANE + MX_ROWS - 1) / MX_ROWS));
  mxuroll_kernel<<<grid, THREADS, MX_SMEM, (cudaStream_t)stream>>>((const float*)x, (const int32_t*)starts,
                                                                  (float*)out, dim, W);
  return (int)cudaGetLastError();
}

template <bool PER_ROW>
int launch_roll(const void* x, const void* shifts, void* out, int64_t B, void* stream) {
  if (B < 1 || B > 0x7fffffff) return (int)cudaErrorInvalidValue;
  roll_kernel<PER_ROW><<<(unsigned int)B, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int32_t*)shifts, (float*)out, B * TILE_ROWS);
  return (int)cudaGetLastError();
}

}  // namespace

// Chunk probes: x float[dim], starts int32[nc], out float[nc * W].
extern "C" int qc_probe_copy(void* x, void* starts, void* out, int64_t dim, int64_t nc, int64_t W, void* stream) {
  return launch_chunk(copy_kernel, x, starts, out, dim, nc, W, stream);
}

extern "C" int qc_probe_roll2(void* x, void* starts, void* out, int64_t dim, int64_t nc, int64_t W, void* stream) {
  return launch_chunk(roll2_kernel, x, starts, out, dim, nc, W, stream);
}

extern "C" int qc_probe_mxuroll(void* x, void* starts, void* out, int64_t dim, int64_t nc, int64_t W, void* stream) {
  return launch_mxuroll(x, starts, out, dim, nc, W, stream);
}

// Roll probes: x, out float[B][8][128]; shifts int32[B] (dynroll) or
// int32[8 * B] (rowroll).
extern "C" int qc_probe_dynroll(void* x, void* shifts, void* out, int64_t B, void* stream) {
  return launch_roll<false>(x, shifts, out, B, stream);
}

extern "C" int qc_probe_rowroll(void* x, void* shifts, void* out, int64_t B, void* stream) {
  return launch_roll<true>(x, shifts, out, B, stream);
}
