// A run of in-place controlled modular multiplies (m_high layout) in one
// pass, through column strips staged in shared memory, for Hopper (sm_90a).
//
// Replaces quantumcomputer_tpu/ops/pallas_oracle.py::_cycle_kernel (:274,
// and its bf16 instance, :389-392) and, where a run ends in one,
// _ladder_kernel (:101): where the TPU kernels walk one gate's cycles in
// place, gate after gate, and gather a fused ladder into a second state,
// this kernel applies a run of K adjacent plan entries at once, in place
// (the engine's strip_run: cycle walks and out-of-place ladders, bf16 or
// float32, where ops/oracle.strip_pays).  Over the (rows = 2^M,
// rest = 2^(n-M)) row-major view of each plane (element (j, col) at
// j * rest + col):
//
//   x[j, col] <- x[src(j, col), col]
//   src(j, col) = j < C ? (mu(col) * j) mod C : j
//   mu(col)     = prod over the gates k whose control bit c_k of col is set
//                 of ainv_k (mod C)
//
// ainv_k being gate k's inverse multiplier.  The gates commute, so this is
// the composed gather of the ladder (oracle_ladder.cu), applied in place.
//
// What bounds it: device-memory bandwidth, one read and one write of the
// moved columns (those with a control bit set; rows 0 and j >= C of every
// column are fixed points and are not written): 0.641 ms for the complex32
// n = 28 oracle stage and 1.282 ms for the complex64 one at 3.35 TB/s.  A
// gate permutes rows within each column and never mixes columns, so one
// block holds whole columns in shared memory and the permutation is in
// place:
//
//   * A strip is SB consecutive bytes (SB = 16 or 32) of rows 0 .. C-1 of
//     one plane: at SB = 16, 8 bf16 (4 float32) columns, C x 16 bytes =
//     128 KB at C = 8191, in dynamic shared memory.  One block a strip; the
//     grid is (strips, 2 planes), neighbouring strips in neighbouring blocks.
//     A strip whose 32-byte sector has mu = 1 in every column (no control
//     bit set) is left alone: its block returns before it loads.  A 16-byte
//     strip beside a moved one is written back even so, so that the L2
//     writes whole sectors (skipping it alone read 2.18 against 1.62 ms for
//     a lone gate at control 3 on an H100).
//   * Loading: every 16-byte row piece is copied with cp.async, all in
//     flight before the one wait, each asking the L2 for its whole 128-byte
//     line (the neighbouring strips' blocks read the rest of it).
//   * Writing back: every thread keeps its columns' running source rows,
//     advanced by (mu * rows) mod C with a compare-and-subtract (no 64-bit
//     remainder an element).  A 16-byte strip: a thread takes whole rows,
//     its W columns with one streaming 16-byte store.  A 32-byte strip: W
//     consecutive threads take the W elements of one row, so a warp stores
//     32 / W rows of whole sectors.  No cycle schedule, segment cut,
//     scratch row or second state is needed, and a run of K gates costs
//     one pass, not K.
//   * Elements move as raw bits: bf16 is neither widened nor rounded.
//
// The caller (ops/oracle.py, strip_bytes) takes SB = 32, a warp storing
// whole 32-byte sectors, where C x 32 bytes fit shared memory, else
// SB = 16; qc_oracle_strip_room reports the shared memory it decides from.
// What holds it back (PERF.md): a strip touches SB bytes of each of C rows
// 2^(n-M) elements apart, so every load and store instruction of a warp
// fans out to many rows, and a 128-KB block fills an SM, so no block's
// loads overlap another's stores.  The stores cost the most: on an H100 at
// n = 28 (float32, C = 8191) the loads alone take 1.37 of the pass's
// 3.2 ms, and stores alone to lines the L2 does not hold 4.5 ms.  With a
// warp storing 8 rows of 4-byte elements a store, the 16-byte pass took
// 3.22-3.28 ms at n = 28 and 75.7 ms at n = 32 (rows 2 MiB apart); with one
// 16-byte streaming store a thread and the loads' 128-byte L2 lines, 3.10
// and 67.5 (bf16: 1.62 and 25.7, against 1.65-1.69 and 30.2).  The 32-byte
// pass keeps its scalar stores, which beat the 16-byte stores there
// (bf16 at M = 12: 1.22 against 1.37 ms at n = 28), and takes the 128-byte
// lines (f32 2.27 against 2.45 ms).
// A cluster form (two or four blocks a strip, 16- or 32-byte strips, each
// block holding part of the rows and reading the rest through distributed
// shared memory, so that two or three blocks share an SM) was 1.4-2.6 times
// slower at n = 28 and 32, at float32 and bf16, and was not kept.
//
// Limits (cudaErrorInvalidValue otherwise): planes 16-byte aligned; C x SB
// bytes within qc_oracle_strip_room (C <= 8192 at SB = 16, M <= 13); rows
// of at least one strip; C^2 < 2^31; 1 <= K <= n - M.  The wrapper, which
// builds the table, holds the controls to distinct column bits below n - M.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MIN_THREADS = 128;
constexpr int MAX_RUN = 40;
// Shared memory kept back from a block's opt-in limit for the kernel's
// static arrays (at most 16 multipliers, 64 bytes).
constexpr int STATIC_RESERVE = 1024;

__device__ __forceinline__ void async_copy16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// tab: int32[2K], the run's inverse multipliers then its controls.
template <typename T, int SB>
__global__ void __launch_bounds__(MAX_THREADS)
strip_kernel(T* re, T* im, const int32_t* __restrict__ tab, int K, int64_t C, int log_rest) {
  constexpr int W = SB / (int)sizeof(T);  // columns of a strip
  constexpr int S = 32 / (int)sizeof(T);  // columns of a 32-byte sector (a strip's or two strips')
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint32_t s_mu[W];

  const int t = threadIdx.x, nt = blockDim.x;
  const int64_t rest = int64_t(1) << log_rest;
  const int64_t col0 = (int64_t)blockIdx.x * W;
  T* x = blockIdx.y ? im : re;

  // The multipliers of the 32-byte sector's columns; the strip keeps its own.
  int64_t mu = 1;
  if (t < S) {
    const int64_t col = (col0 & ~int64_t(S - 1)) + t;
    for (int k = 0; k < K; ++k) {
      if ((col >> tab[K + k]) & 1) mu = mu * tab[k] % C;
    }
    if (col >= col0 && col < col0 + W) s_mu[col - col0] = (uint32_t)mu;
  }
  if (!__syncthreads_or(mu != 1)) return;  // every column of the sector stays

  // Stage rows 0 .. C-1 of the strip, every copy in flight before the wait.
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  for (int64_t r = t; r < C; r += nt) {
    const T* src = x + r * rest + col0;
#pragma unroll
    for (int v = 0; v < SB / 16; ++v) async_copy16(base + (uint32_t)r * SB + 16 * v, src + v * (16 / sizeof(T)));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Write back, each thread keeping its columns' running source rows.
  const T* strip = reinterpret_cast<const T*>(smem);
  const uint32_t c = (uint32_t)C;
  if constexpr (SB == 16) {
    // A thread takes whole rows: one streaming 16-byte store a row.
    uint32_t src[W], step[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int64_t m = s_mu[w];
      step[w] = (uint32_t)(m * nt % C);
      src[w] = (uint32_t)(m * (1 + t) % C);
    }
    for (int64_t j = 1 + t; j < C; j += nt) {
      alignas(16) T row[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        row[w] = strip[src[w] * W + w];
        src[w] += step[w];
        if (src[w] >= c) src[w] -= c;
      }
      __stcs(reinterpret_cast<uint4*>(x + j * rest + col0), *reinterpret_cast<const uint4*>(row));
    }
  } else {
    // W consecutive threads take the W elements of one row.
    const int w = t % W, rows = nt / W;
    const int64_t m = s_mu[w];
    const uint32_t step = (uint32_t)(m * rows % C);
    uint32_t src = (uint32_t)(m * (1 + t / W) % C);
    for (int64_t j = 1 + t / W; j < C; j += rows) {
      x[j * rest + col0 + w] = strip[src * W + w];
      src += step;
      if (src >= c) src -= c;
    }
  }
}

// Threads a block: a 16-byte strip's thread writes about 32 rows (at most
// 256 threads), a 32-byte strip's W threads of a row about 8.
int threads_for(int64_t C, int strip_bytes) {
  const int64_t per_thread = strip_bytes == 16 ? 32 : 8, most = strip_bytes == 16 ? 256 : MAX_THREADS;
  int64_t nt = MIN_THREADS;
  while (nt < most && nt * per_thread < C) nt *= 2;
  return (int)nt;
}

// The dynamic shared memory a strip block may take on the current device.
cudaError_t strip_room(int64_t* bytes) {
  int dev = 0, cap = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess) return err;
  *bytes = (int64_t)cap - STATIC_RESERVE;
  return cudaSuccess;
}

template <typename T, int SB>
int launch(void* re, void* im, const void* tab, int64_t K, int64_t C, int64_t log_rest, void* stream) {
  constexpr int W = SB / (int)sizeof(T);
  const int64_t strips = (int64_t(1) << log_rest) / W;
  const size_t smem = (size_t)C * SB;
  auto kern = strip_kernel<T, SB>;
  int64_t room = 0;
  cudaError_t err;
  if ((err = strip_room(&room)) != cudaSuccess) return (int)err;
  if (strips < 1 || strips > 0x7fffffff || (int64_t)smem > room) return (int)cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) != cudaSuccess) {
    return (int)err;
  }
  kern<<<dim3((unsigned int)strips, 2, 1), threads_for(C, SB), smem, (cudaStream_t)stream>>>(
      (T*)re, (T*)im, (const int32_t*)tab, (int)K, C, (int)log_rest);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_strip(void* re, void* im, const void* tab, int64_t K, int64_t C, int64_t log_rows, int64_t log_rest,
                 int64_t strip_bytes, void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(re) % 16) == 0 && (reinterpret_cast<uintptr_t>(im) % 16) == 0 &&
                       (reinterpret_cast<uintptr_t>(tab) % 4) == 0;
  if (!aligned || K < 1 || K > log_rest || K > MAX_RUN || C < 2 || C > (int64_t(1) << log_rows) ||
      C * C >= (int64_t(1) << 31) || log_rows < 1 || log_rest < 1 || log_rows + log_rest > 40) {
    return (int)cudaErrorInvalidValue;
  }
  switch (strip_bytes) {
    case 16:
      return launch<T, 16>(re, im, tab, K, C, log_rest, stream);
    case 32:
      return launch<T, 32>(re, im, tab, K, C, log_rest, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// re, im: the planes, 2^(log_rows + log_rest) elements each, in place;
// tab: int32[2K] on the device, the inverse multipliers then the controls
// (distinct column bits below log_rest); strip_bytes: 16 or 32.
extern "C" int qc_oracle_strip_bf16(void* re, void* im, void* tab, int64_t K, int64_t C, int64_t log_rows,
                                    int64_t log_rest, int64_t strip_bytes, void* stream) {
  return launch_strip<uint16_t>(re, im, tab, K, C, log_rows, log_rest, strip_bytes, stream);
}

extern "C" int qc_oracle_strip_f32(void* re, void* im, void* tab, int64_t K, int64_t C, int64_t log_rows,
                                   int64_t log_rest, int64_t strip_bytes, void* stream) {
  return launch_strip<float>(re, im, tab, K, C, log_rows, log_rest, strip_bytes, stream);
}

// *bytes: the shared memory (bytes) a strip of C rows may take on the
// current device, which the caller's choice of strip width reads.
extern "C" int qc_oracle_strip_room(int64_t* bytes) { return (int)strip_room(bytes); }
