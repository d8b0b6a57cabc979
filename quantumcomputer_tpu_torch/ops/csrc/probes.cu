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
//   * mxuroll: the lane rotation done by the matrix unit.  The block stages
//     the 9 whole 128-float rows that hold its 8 output rows, then rotates
//     every row by r = s mod 128 as a tensor-core product with the 0/1
//     permutation matrix P[k][q] = (k - r) mod 128 == q, using
//     mma.sync.m8n8k4 in float64 on values widened from float32: one term
//     of each sum is 1 * x and the rest 0 * y, so the product is exact for
//     finite inputs and narrows back to the same float32 (TF32 would drop
//     mantissa bits).  P is generated in registers; each 8-wide output
//     column block needs only the 3 k-steps that hold its nonzeros.
//   * dynroll, rowroll: one warp per 128-float row, each lane reading
//     x[(l + c) & 127] for its 4 lanes; a warp's loads cover the row once.
//
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 1024;      // floats of one chunk tile: one float4 per thread
constexpr int LANE = 128;
constexpr int TILE_ROWS = TILE / LANE;  // 8 output rows per tile
constexpr int STAGE_ROWS = 16;          // two 8-row mma groups; rows >= 9 stay zero

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

__device__ __forceinline__ void mma_f64_m8n8k4(double& d0, double& d1, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

__global__ void __launch_bounds__(THREADS)
mxuroll_kernel(const float* __restrict__ x, const int32_t* __restrict__ starts, float* __restrict__ out,
               int64_t dim, int64_t W) {
  __shared__ float4 stage4[STAGE_ROWS * LANE / 4];
  __shared__ float rot[STAGE_ROWS][LANE];
  float(*stage)[LANE] = reinterpret_cast<float(*)[LANE]>(stage4);
  const int64_t i = blockIdx.x;
  const int64_t s = clamp64(starts[i], 0, dim - W);
  const int r = (int)(s & (LANE - 1));
  const int64_t row0 = (s >> 7) + (int64_t)blockIdx.y * TILE_ROWS;  // first staged row of x

  // Stage rows row0 .. row0 + 8 (the 8 output rows need one more); the
  // second mma group's rows 9..15 are zero.
  for (int v = threadIdx.x; v < STAGE_ROWS * LANE / 4; v += THREADS) {
    const int k = v / (LANE / 4);
    const int64_t at = (row0 + k) * LANE + 4 * (int64_t)(v % (LANE / 4));
    stage4[v] = (k <= TILE_ROWS && at < dim) ? *reinterpret_cast<const float4*>(x + at)
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // rot = stage @ P, 8 rows x 8 columns per mma tile: warp w takes row group
  // w & 1 and column blocks 4*(w >> 1) .. +3.  Fragments of m8n8k4 (f64):
  // A[lane >> 2][lane & 3], B[lane & 3][lane >> 2], D[lane >> 2][2*(lane & 3) + {0,1}].
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int arow = (warp & 1) * 8 + (lane >> 2);
  for (int nt = (warp >> 1) * 4; nt < (warp >> 1) * 4 + 4; ++nt) {
    const int q0 = nt * 8;
    const int kbase = ((q0 + r) & (LANE - 1)) & ~3;
    double d0 = 0.0, d1 = 0.0;
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) {
      const int k = ((kbase + 4 * ks) & (LANE - 1)) + (lane & 3);
      const double a = (double)stage[arow][k];
      const double b = ((k - r) & (LANE - 1)) == q0 + (lane >> 2) ? 1.0 : 0.0;
      mma_f64_m8n8k4(d0, d1, a, b);
    }
    rot[arow][q0 + 2 * (lane & 3)] = (float)d0;
    rot[arow][q0 + 2 * (lane & 3) + 1] = (float)d1;
  }
  __syncthreads();

  // out row p, lane q: rot[p][q] = x row p at lane (q + r) mod 128, which is
  // element s + 128 p + q while q < 128 - r; past that it lies one row on.
  const int p = threadIdx.x / (LANE / 4);
  const int q = (threadIdx.x % (LANE / 4)) * 4;
  float o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = q + e < LANE - r ? rot[p][q + e] : rot[p + 1][q + e];
  __stcs(reinterpret_cast<float4*>(out + i * W + (int64_t)blockIdx.y * TILE + threadIdx.x * 4),
         make_float4(o[0], o[1], o[2], o[3]));
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
  return launch_chunk(mxuroll_kernel, x, starts, out, dim, nc, W, stream);
}

// Roll probes: x, out float[B][8][128]; shifts int32[B] (dynroll) or
// int32[8 * B] (rowroll).
extern "C" int qc_probe_dynroll(void* x, void* shifts, void* out, int64_t B, void* stream) {
  return launch_roll<false>(x, shifts, out, B, stream);
}

extern "C" int qc_probe_rowroll(void* x, void* shifts, void* out, int64_t B, void* stream) {
  return launch_roll<true>(x, shifts, out, B, stream);
}
