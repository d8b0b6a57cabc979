// Controlled modular multiply, one gate out of place (m_high layout), for
// Hopper (sm_90a).
//
// Replaces quantumcomputer_tpu/ops/pallas_oracle.py::_kernel (the blocked
// pure/mixed row gather behind apply_camodc_high_planar).  Over the
// (rows = 2^M, rest = 2^(n-M)) row-major view of each plane (element
// (j, col) at j * rest + col):
//
//   out[j, col] = bit(col, c) ? in[ginv[j], col] : in[j, col]
//
// What bounds it: device-memory bandwidth.  It only moves data: one read and
// one write of both planes, 4.29 GB at n = 28 in float32, so at least 1.28 ms
// at 3.35 TB/s.  The TPU kernel DMAs (CB2, 128) slabs of whole rows and,
// where the control bit falls inside a column block ("mixed"), fetches BOTH
// candidate rows and blends them, reading up to twice.  On the card each
// output element has exactly one source row, ctrl ? ginv[j] : j, so the
// kernel reads each element once:
//
//   * one block per (output row j, chunk of columns); the block loads
//     ginv[j] itself (the TPU kernel's scalar prefetch);
//   * 16-byte vectors along the contiguous columns (float4 for f32, double2
//     for f64, eight 2-byte elements for bf16), neighbouring threads on neighbouring vectors, ITEMS vectors
//     in flight per thread before any store;
//   * with the control bit at or above the vector width (c >= 2 for f32,
//     c >= 1 for f64, c >= 3 for bf16) all elements of a vector share one control value, so
//     one vector load from one source row;
//   * below that, the elements of a vector alternate between the two rows:
//     each is loaded alone from its own row and the vector is stored whole.
//
// A run of one control value shorter than a 64-byte DRAM access (c < 4 for
// f32, c < 3 for f64) shares its bytes with the run of the other value,
// which another output row reads; such controls then move up to twice the
// minimum whatever the load width (on the H100 at n = 28 f32, c = 0 and 3
// take about 1.5x the time of c = 14).
//
// The pure/mixed split, the 8-row strips and the double-buffered DMA banks
// of the TPU kernel have no counterpart.  Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;  // vectors in flight per thread

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int N = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int N = 2;
};
// bf16 planes ("complex32") move as raw 2-byte elements: the gather never
// converts, so it is exact.
template <>
struct Vec<uint16_t> {
  using type = uint4;
  static constexpr int N = 8;
};

template <typename T, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const T* __restrict__ in_re, const T* __restrict__ in_im, T* __restrict__ out_re,
              T* __restrict__ out_im, const int32_t* __restrict__ ginv, int log_rest,
              int log_chunks, int c_phys) {
  using V = typename Vec<T>::type;
  constexpr int N = Vec<T>::N;
  const int64_t j = (int64_t)blockIdx.x >> log_chunks;
  const int64_t rest = int64_t(1) << log_rest;
  const int64_t chunk_cols = rest >> log_chunks;
  const int64_t chunk_vecs = chunk_cols / N;
  const int64_t col0 = ((int64_t)blockIdx.x & ((int64_t(1) << log_chunks) - 1)) * chunk_cols;
  const int64_t row_j = j * rest;
  const int64_t row_g = (int64_t)ginv[j] * rest;

  for (int64_t v0 = threadIdx.x; v0 < chunk_vecs; v0 += (int64_t)THREADS * ITEMS) {
    V r[ITEMS], i[ITEMS];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int64_t v = v0 + (int64_t)it * THREADS;
      if (v < chunk_vecs) {
        const int64_t col = col0 + v * N;
        if (!SPLIT) {
          const int64_t at = (((col >> c_phys) & 1) ? row_g : row_j) + col;
          r[it] = *reinterpret_cast<const V*>(in_re + at);
          i[it] = *reinterpret_cast<const V*>(in_im + at);
        } else {
          T* rs = reinterpret_cast<T*>(&r[it]);
          T* is = reinterpret_cast<T*>(&i[it]);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const int64_t at = ((((col + e) >> c_phys) & 1) ? row_g : row_j) + col + e;
            rs[e] = in_re[at];
            is[e] = in_im[at];
          }
        }
      }
    }
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int64_t v = v0 + (int64_t)it * THREADS;
      if (v < chunk_vecs) {
        const int64_t at = row_j + col0 + v * N;
        *reinterpret_cast<V*>(out_re + at) = r[it];
        *reinterpret_cast<V*>(out_im + at) = i[it];
      }
    }
  }
}

template <typename T>
int launch_gather(const void* in_re, const void* in_im, void* out_re, void* out_im, const void* ginv,
                  int64_t log_rows, int64_t log_rest, int64_t c_phys, void* stream) {
  constexpr int N = Vec<T>::N;
  constexpr int64_t CHUNK = (int64_t)THREADS * ITEMS * N;
  // The JAX function's limits: >= 8 rows of >= 1024 columns.
  if (log_rows < 3 || log_rest < 10 || log_rows + log_rest > 40 || c_phys < 0 || c_phys >= log_rest) {
    return (int)cudaErrorInvalidValue;
  }
  int64_t log_chunks = 0;
  while ((int64_t(1) << (log_rest - log_chunks)) > CHUNK) ++log_chunks;
  const int64_t blocks = int64_t(1) << (log_rows + log_chunks);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const bool split = (int64_t(1) << c_phys) < N;
  auto kernel = split ? gather_kernel<T, true> : gather_kernel<T, false>;
  kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)in_re, (const T*)in_im, (T*)out_re, (T*)out_im, (const int32_t*)ginv, (int)log_rest,
      (int)log_chunks, (int)c_phys);
  return (int)cudaGetLastError();
}

}  // namespace

// in_re/in_im -> out_re/out_im (distinct buffers, 16-byte aligned); ginv:
// int32[2^log_rows] on the device.
extern "C" int qc_oracle_gather_f32(void* in_re, void* in_im, void* out_re, void* out_im, void* ginv,
                                    int64_t log_rows, int64_t log_rest, int64_t c_phys, void* stream) {
  return launch_gather<float>(in_re, in_im, out_re, out_im, ginv, log_rows, log_rest, c_phys, stream);
}

extern "C" int qc_oracle_gather_f64(void* in_re, void* in_im, void* out_re, void* out_im, void* ginv,
                                    int64_t log_rows, int64_t log_rest, int64_t c_phys, void* stream) {
  return launch_gather<double>(in_re, in_im, out_re, out_im, ginv, log_rows, log_rest, c_phys, stream);
}

// bf16 planes (the TPU kernel at bf16 storage), moved as uint16_t.
extern "C" int qc_oracle_gather_bf16(void* in_re, void* in_im, void* out_re, void* out_im, void* ginv,
                                     int64_t log_rows, int64_t log_rest, int64_t c_phys, void* stream) {
  return launch_gather<uint16_t>(in_re, in_im, out_re, out_im, ginv, log_rows, log_rest, c_phys, stream);
}
