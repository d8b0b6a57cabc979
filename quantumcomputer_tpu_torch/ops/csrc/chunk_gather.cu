// Chunk gather of the structured stride permutation (ops/chunkgather.py).
//
// Replaces quantumcomputer_tpu/ops/pallas_chunkgather.py:_gather_kernel and
// its four entry points.  x is (B, P) contiguous, out is (B, NC, W):
//
//   gather  (mode 0): out[b,c,e] = x[b, s[c] + e]
//   src2    (mode 1): the same, read from x2 (B, P2) where flag[c] != 0
//   blend   (mode 2): out[b,c,e] = x[b, s0[c] + e]  if e < istar[c]
//                                  x[b, s1[c] + e]  otherwise
//   rowlaw  (mode 3): blend with s0, s1, istar computed from the chunk index
//                     c by the row-compaction law (W = Wt):
//                       f0 = c*Wt; q0 = f0 / v; t0 = f0 - q0*v
//                       istar = clamp(v - t0, 0, Wt)
//                       s0 = clamp(q0*vpad + t0, 0, P - Wt)
//                       s1 = clamp((q0 + 1)*vpad - istar, 0, P - Wt)
//
// Every start is clamped into [0, P - W] of the buffer it reads (P2 - W for
// x2).  The permutation's deal leg gathers rows whose windows start before
// 0 or end past P and then overwrites them; the clamp keeps those reads
// inside the buffer, and the plain version clamps the same way, so both
// agree on the whole output.  The law and its clamps are part of the
// semantics, as in the JAX package.
//
// Bound: bytes (each output element is one read and one write).  Design:
// one CUDA block per (chunk, plane); its threads stride over the W
// elements, four loads in flight each before their stores.  A GPU reads
// an unaligned contiguous run coalesced, so the TPU kernel's row-granular
// slab DMAs and in-register lane rolls (_extract) have no counterpart.
// Offsets are 64-bit: with B = 2 at M = 30, b*P + s + e passes 2^31.
// bf16 ("complex32") planes move as 2-byte elements (qc_chunk_gather_bf16).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
chunk_gather_kernel(const T* __restrict__ x, const T* __restrict__ x2, T* __restrict__ out,
                    const int64_t* __restrict__ a0, const int64_t* __restrict__ a1,
                    const int64_t* __restrict__ a2, int64_t P, int64_t P2, int64_t NC, int64_t W,
                    int64_t v, int64_t vpad) {
  const int64_t c = blockIdx.x;
  const int64_t b = blockIdx.y;
  const T* src = x + b * P;
  int64_t s0, s1 = 0, ist = W;
  if (MODE == 0) {
    s0 = clamp64(a0[c], 0, P - W);
  } else if (MODE == 1) {
    if (a1[c] != 0) {
      src = x2 + b * P2;
      s0 = clamp64(a0[c], 0, P2 - W);
    } else {
      s0 = clamp64(a0[c], 0, P - W);
    }
  } else if (MODE == 2) {
    s0 = clamp64(a0[c], 0, P - W);
    s1 = clamp64(a1[c], 0, P - W);
    ist = a2[c];
  } else {
    const int64_t f0 = c * W;
    const int64_t q0 = f0 / v;
    const int64_t t0 = f0 - q0 * v;
    ist = clamp64(v - t0, 0, W);
    s0 = clamp64(q0 * vpad + t0, 0, P - W);
    s1 = clamp64((q0 + 1) * vpad - ist, 0, P - W);
  }
  T* o = out + (b * NC + c) * W;
  const int64_t step = THREADS;
  int64_t e = threadIdx.x;
  for (; e + (UNROLL - 1) * step < W; e += UNROLL * step) {
    T val[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int64_t ek = e + k * step;
      val[k] = ek < ist ? src[s0 + ek] : src[s1 + ek];
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) o[e + k * step] = val[k];
  }
  for (; e < W; e += step) o[e] = e < ist ? src[s0 + e] : src[s1 + e];
}

template <typename T>
int launch(const void* x, const void* x2, void* out, const void* a0, const void* a1, const void* a2, int64_t mode,
           int64_t B, int64_t P, int64_t P2, int64_t NC, int64_t W, int64_t v, int64_t vpad, void* stream) {
  if (B <= 0 || B > 65535 || NC <= 0 || NC > 0x7fffffffLL || W <= 0 || P < W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((mode == 1 && P2 < W) || (mode == 3 && (v <= 0 || vpad < v))) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(NC), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xs = static_cast<const T*>(x);
  const T* x2s = static_cast<const T*>(x2);
  T* o = static_cast<T*>(out);
  const int64_t* i0 = static_cast<const int64_t*>(a0);
  const int64_t* i1 = static_cast<const int64_t*>(a1);
  const int64_t* i2 = static_cast<const int64_t*>(a2);
  switch (mode) {
    case 0: chunk_gather_kernel<T, 0><<<grid, THREADS, 0, s>>>(xs, x2s, o, i0, i1, i2, P, P2, NC, W, v, vpad); break;
    case 1: chunk_gather_kernel<T, 1><<<grid, THREADS, 0, s>>>(xs, x2s, o, i0, i1, i2, P, P2, NC, W, v, vpad); break;
    case 2: chunk_gather_kernel<T, 2><<<grid, THREADS, 0, s>>>(xs, x2s, o, i0, i1, i2, P, P2, NC, W, v, vpad); break;
    case 3: chunk_gather_kernel<T, 3><<<grid, THREADS, 0, s>>>(xs, x2s, o, i0, i1, i2, P, P2, NC, W, v, vpad); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qc_chunk_gather_f32(const void* x, const void* x2, void* out, const void* a0, const void* a1,
                                   const void* a2, int64_t mode, int64_t B, int64_t P, int64_t P2, int64_t NC,
                                   int64_t W, int64_t v, int64_t vpad, void* stream) {
  return launch<float>(x, x2, out, a0, a1, a2, mode, B, P, P2, NC, W, v, vpad, stream);
}

extern "C" int qc_chunk_gather_f64(const void* x, const void* x2, void* out, const void* a0, const void* a1,
                                   const void* a2, int64_t mode, int64_t B, int64_t P, int64_t P2, int64_t NC,
                                   int64_t W, int64_t v, int64_t vpad, void* stream) {
  return launch<double>(x, x2, out, a0, a1, a2, mode, B, P, P2, NC, W, v, vpad, stream);
}

extern "C" int qc_chunk_gather_bf16(const void* x, const void* x2, void* out, const void* a0, const void* a1,
                                    const void* a2, int64_t mode, int64_t B, int64_t P, int64_t P2, int64_t NC,
                                    int64_t W, int64_t v, int64_t vpad, void* stream) {
  return launch<uint16_t>(x, x2, out, a0, a1, a2, mode, B, P, P2, NC, W, v, vpad, stream);
}
