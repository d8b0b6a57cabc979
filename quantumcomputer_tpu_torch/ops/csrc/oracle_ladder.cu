// Composed run of controlled modular multiplies (m_high layout), out of
// place, for Hopper (sm_90a).
//
// Replaces quantumcomputer_tpu/ops/pallas_oracle.py::_ladder_kernel (the TPU
// kernel behind apply_camodc_ladder_high_planar).  Over the (rows = 2^M,
// rest = 2^(n-M)) row-major view of each plane (element (j, col) at
// j * rest + col):
//
//   out[j, col] = in[src(j, mask(col)), col]
//   src(j, m)   = j < C ? (combo[m] * j) mod C : j
//
// mask(col) packs the bits of col at the K <= 8 control positions (bit k of
// the mask = control k), and combo[m] is the composed inverse multiplier of
// the gates whose control bits are set in m (ops/gates.py,
// modexp_combo_multipliers).  The K gates commute, so one gather applies
// all of them.
//
// What bounds it: device-memory bandwidth.  It is pure data movement: one
// read and one write of both planes, no arithmetic per element.  The design
// keeps the per-element work to an address: one CUDA block owns one output
// row j and a chunk of CHUNK columns; it first computes src(j, m) for all
// 2^K masks into shared memory (2^K 64-bit products and remainders per
// block, not per element), then streams its chunk, ITEMS independent loads
// of each plane in flight per thread before it stores any.  Neighbouring
// threads take neighbouring columns, so a warp reads and writes 32
// consecutive elements of one row.  (16-byte vectors per thread measured no
// faster on the H100.)  The TPU kernel's DMA slabs, banks and 8-row strips
// do not carry over.  bf16 ("complex32") planes move as 2-byte elements
// (qc_oracle_ladder_bf16): the gather is exact at any element width.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;  // columns in flight per thread
constexpr int CHUNK = THREADS * ITEMS;
constexpr int MAX_K = 8;

template <typename T>
__global__ void __launch_bounds__(THREADS)
ladder_kernel(const T* __restrict__ in_re, const T* __restrict__ in_im, T* __restrict__ out_re,
              T* __restrict__ out_im, const int32_t* __restrict__ combo, int K,
              uint64_t controls_packed, int64_t C, int log_rest, int log_chunks) {
  __shared__ int64_t src_of_mask[1 << MAX_K];
  const int64_t j = (int64_t)blockIdx.x >> log_chunks;
  const int64_t rest = int64_t(1) << log_rest;
  const int64_t chunk_cols = rest >> log_chunks;
  const int64_t col0 = ((int64_t)blockIdx.x & ((int64_t(1) << log_chunks) - 1)) * chunk_cols;
  for (int m = threadIdx.x; m < (1 << K); m += THREADS) {
    src_of_mask[m] = j < C ? ((int64_t)combo[m] * j) % C : j;
  }
  __syncthreads();

  for (int64_t c0 = threadIdx.x; c0 < chunk_cols; c0 += CHUNK) {
    T r[ITEMS], i[ITEMS];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int64_t c = c0 + (int64_t)it * THREADS;
      if (c < chunk_cols) {
        const int64_t col = col0 + c;
        int mask = 0;
        for (int k = 0; k < K; ++k) {
          mask |= (int)((col >> ((controls_packed >> (8 * k)) & 0xff)) & 1) << k;
        }
        const int64_t at = src_of_mask[mask] * rest + col;
        r[it] = in_re[at];
        i[it] = in_im[at];
      }
    }
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int64_t c = c0 + (int64_t)it * THREADS;
      if (c < chunk_cols) {
        const int64_t at = j * rest + col0 + c;
        out_re[at] = r[it];
        out_im[at] = i[it];
      }
    }
  }
}

template <typename T>
int launch_ladder(const void* in_re, const void* in_im, void* out_re, void* out_im, const void* combo,
                  int64_t K, int64_t controls_packed, int64_t C, int64_t log_rows, int64_t log_rest,
                  void* stream) {
  if (K < 1 || K > MAX_K || C < 1 || log_rows < 0 || log_rest < 0 || log_rows + log_rest > 40 ||
      C > (int64_t(1) << log_rows)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int k = 0; k < K; ++k) {
    if (int64_t((controls_packed >> (8 * k)) & 0xff) >= log_rest) return (int)cudaErrorInvalidValue;
  }
  // Chunks per row: as many as keep a chunk within CHUNK columns.
  int64_t log_chunks = 0;
  while ((int64_t(1) << (log_rest - log_chunks)) > CHUNK) ++log_chunks;
  const int64_t blocks = int64_t(1) << (log_rows + log_chunks);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  ladder_kernel<T><<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)in_re, (const T*)in_im, (T*)out_re, (T*)out_im, (const int32_t*)combo, (int)K,
      (uint64_t)controls_packed, C, (int)log_rest, (int)log_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// in_re/in_im -> out_re/out_im (distinct buffers); combo: int32[2^K] on the
// device; controls_packed: control k's column bit in byte k.
extern "C" int qc_oracle_ladder_f32(void* in_re, void* in_im, void* out_re, void* out_im,
                                    void* combo, int64_t K, int64_t controls_packed, int64_t C,
                                    int64_t log_rows, int64_t log_rest, void* stream) {
  return launch_ladder<float>(in_re, in_im, out_re, out_im, combo, K, controls_packed, C, log_rows,
                              log_rest, stream);
}

extern "C" int qc_oracle_ladder_f64(void* in_re, void* in_im, void* out_re, void* out_im,
                                    void* combo, int64_t K, int64_t controls_packed, int64_t C,
                                    int64_t log_rows, int64_t log_rest, void* stream) {
  return launch_ladder<double>(in_re, in_im, out_re, out_im, combo, K, controls_packed, C, log_rows,
                               log_rest, stream);
}

extern "C" int qc_oracle_ladder_bf16(void* in_re, void* in_im, void* out_re, void* out_im,
                                     void* combo, int64_t K, int64_t controls_packed, int64_t C,
                                     int64_t log_rows, int64_t log_rest, void* stream) {
  return launch_ladder<uint16_t>(in_re, in_im, out_re, out_im, combo, K, controls_packed, C, log_rows,
                                 log_rest, stream);
}
