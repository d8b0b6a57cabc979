// The semiclassical step's epilogue in two passes over the work state
// (ops/sc_step.py; algorithms/semiclassical.py calls it on the card).
//
// Replaces no TPU kernel: the JAX package leaves this epilogue to XLA, which
// fuses it (quantumcomputer_tpu/algorithms/semiclassical.py).  Eager PyTorch
// runs it op by op, a dozen kernels for each 2^22-element block, so it is
// written here by hand.  With w = (wr, wi) the work state, (gr, gi) the
// permuted planes U w before the 1/sqrt2 scale, ct = cos theta,
// st = sin theta and s2 = 1/sqrt2, all in the plane type T:
//
//   g  = (gr s2, gi s2)              a1 = (ct g_r - st g_i, st g_r + ct g_i)
//   a0 = w s2                        b0 = (a0 + a1) s2,   b1 = (a0 - a1) s2
//   A: one (sum |b0|^2, sum |b1|^2) pair per block, in float64
//   B: p0, p1 from the pairs; bit = (r (p0 + p1) >= p0), or the forced bit;
//      p = p_bit; w' = (sign a1 + a0) s2 / sqrt(p) written over w, with
//      sign = 1 - 2 bit; block 0 writes the bit and p / (p0 + p1).
//
// a1 is never stored: B recomputes it from w, gr and gi.  Every elementwise
// operation is one IEEE operation rounded to nearest (the _rn intrinsics,
// which nvcc never contracts into an FMA), in the order of the plain PyTorch
// composition (the scale, semiclassical._rotate, _branch_sums and
// collapse_from_a1), so given the same p0 and p1 the state equals the plain
// one bit for bit; only the sums' order differs.  Each element's |b|^2 is
// formed in T, as the plain code forms it, then accumulated in float64.
// The sums are deterministic: no atomics; A's per-block pairs are summed in
// every block of B in one fixed order (thread t takes pairs t, t + THREADS,
// ..., then a halving tree), which sc_step.reduce_partials repeats.
//
// What bounds it: bytes.  A reads 2S (S the state's bytes: w, gr and gi),
// B reads 2S and writes S, at a few flops a byte, far below the card's
// balance, so the design only keeps enough loads in flight: 16-byte vector
// loads and stores (float4 / double2) with streaming hints, a grid-stride
// loop on a persistent grid of a few blocks per SM (the wrapper's grid), a
// scalar tail for a plane that is no multiple of the vector, and in A a
// warp-shuffle then shared-memory reduction.  TMA and wgmma buy nothing for
// a pure stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ void narrow(double x, float& y) { y = __double2float_rn(x); }
__device__ __forceinline__ void narrow(double x, double& y) { y = x; }

// 16 bytes of a plane: N elements, loaded and stored with streaming hints.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&x)[4]) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&x)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  }
};

template <>
struct Vec<double> {
  static constexpr int N = 2;
  static __device__ __forceinline__ void load(const double* p, double (&x)[2]) {
    const double2 v = __ldcs(reinterpret_cast<const double2*>(p));
    x[0] = v.x;
    x[1] = v.y;
  }
  static __device__ __forceinline__ void store(double* p, const double (&x)[2]) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(x[0], x[1]));
  }
};

template <typename T>
struct Coeffs {
  T ct, st, s2;
};

// a0 = w s2 and a1 = e^{i theta} (g s2) of one element.
template <typename T>
__device__ __forceinline__ void branches(T wr, T wi, T gr, T gi, const Coeffs<T>& c, T& a0r, T& a0i, T& a1r,
                                         T& a1i) {
  const T g_r = mul_rn(gr, c.s2), g_i = mul_rn(gi, c.s2);
  a1r = sub_rn(mul_rn(g_r, c.ct), mul_rn(g_i, c.st));
  a1i = add_rn(mul_rn(g_r, c.st), mul_rn(g_i, c.ct));
  a0r = mul_rn(wr, c.s2);
  a0i = mul_rn(wi, c.s2);
}

template <typename T>
__device__ __forceinline__ void accumulate(T wr, T wi, T gr, T gi, const Coeffs<T>& c, double& acc0,
                                           double& acc1) {
  T a0r, a0i, a1r, a1i;
  branches(wr, wi, gr, gi, c, a0r, a0i, a1r, a1i);
  const T b0r = mul_rn(add_rn(a0r, a1r), c.s2), b0i = mul_rn(add_rn(a0i, a1i), c.s2);
  const T b1r = mul_rn(sub_rn(a0r, a1r), c.s2), b1i = mul_rn(sub_rn(a0i, a1i), c.s2);
  acc0 += static_cast<double>(add_rn(mul_rn(b0r, b0r), mul_rn(b0i, b0i)));
  acc1 += static_cast<double>(add_rn(mul_rn(b1r, b1r), mul_rn(b1i, b1i)));
}

// w' of one element given the branch's sign and scale.
template <typename T>
__device__ __forceinline__ void collapse_one(T wr, T wi, T gr, T gi, const Coeffs<T>& c, T sign, T scale, T& yr,
                                             T& yi) {
  T a0r, a0i, a1r, a1i;
  branches(wr, wi, gr, gi, c, a0r, a0i, a1r, a1i);
  yr = div_rn(mul_rn(add_rn(mul_rn(sign, a1r), a0r), c.s2), scale);
  yi = div_rn(mul_rn(add_rn(mul_rn(sign, a1i), a0i), c.s2), scale);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Kernel A: partials[2 b], partials[2 b + 1] = block b's sums of |b0|^2 and |b1|^2.
template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
sc_branch_sums_kernel(const T* __restrict__ wr, const T* __restrict__ wi, const T* __restrict__ gr,
                      const T* __restrict__ gi, const T* __restrict__ ctp, const T* __restrict__ stp, T s2,
                      double* __restrict__ partials, int64_t n) {
  constexpr int V = Vec<T>::N;
  const Coeffs<T> c{*ctp, *stp, s2};
  double acc0 = 0.0, acc1 = 0.0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t nvec = n / V;
  for (int64_t i = first; i < nvec; i += stride) {
    T xr[V], xi[V], yr[V], yi[V];
    Vec<T>::load(wr + i * V, xr);
    Vec<T>::load(wi + i * V, xi);
    Vec<T>::load(gr + i * V, yr);
    Vec<T>::load(gi + i * V, yi);
#pragma unroll
    for (int k = 0; k < V; ++k) accumulate(xr[k], xi[k], yr[k], yi[k], c, acc0, acc1);
  }
  for (int64_t j = nvec * V + first; j < n; j += stride) accumulate(wr[j], wi[j], gr[j], gi[j], c, acc0, acc1);

  __shared__ double s0[WARPS], s1[WARPS];
  acc0 = warp_sum(acc0);
  acc1 = warp_sum(acc1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s0[warp] = acc0;
    s1[warp] = acc1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double t0 = 0.0, t1 = 0.0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      t0 += s0[k];
      t1 += s1[k];
    }
    partials[2 * blockIdx.x] = t0;
    partials[2 * blockIdx.x + 1] = t1;
  }
}

// Kernel B: the measurement from A's pairs, then w' over w.
template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
sc_collapse_kernel(T* __restrict__ wr, T* __restrict__ wi, const T* __restrict__ gr, const T* __restrict__ gi,
                   const T* __restrict__ ctp, const T* __restrict__ stp, T s2,
                   const double* __restrict__ partials, int64_t nparts, const T* __restrict__ rp, int64_t force,
                   int64_t* __restrict__ bit_out, T* __restrict__ pcond_out, int64_t n) {
  __shared__ double s0[THREADS], s1[THREADS];
  double t0 = 0.0, t1 = 0.0;
  for (int64_t k = threadIdx.x; k < nparts; k += THREADS) {
    t0 += partials[2 * k];
    t1 += partials[2 * k + 1];
  }
  s0[threadIdx.x] = t0;
  s1[threadIdx.x] = t1;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      s0[threadIdx.x] += s0[threadIdx.x + s];
      s1[threadIdx.x] += s1[threadIdx.x + s];
    }
    __syncthreads();
  }
  T p0, p1;
  narrow(s0[0], p0);
  narrow(s1[0], p1);
  const T total = add_rn(p0, p1);
  const int64_t bit = force >= 0 ? force : (mul_rn(*rp, total) >= p0 ? 1 : 0);
  const T pb = bit ? p1 : p0;
  const T sign = bit ? T(-1) : T(1);
  const T scale = sqrt_rn(pb);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *bit_out = bit;
    *pcond_out = div_rn(pb, total);
  }

  constexpr int V = Vec<T>::N;
  const Coeffs<T> c{*ctp, *stp, s2};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t nvec = n / V;
  for (int64_t i = first; i < nvec; i += stride) {
    T xr[V], xi[V], yr[V], yi[V], outr[V], outi[V];
    Vec<T>::load(wr + i * V, xr);
    Vec<T>::load(wi + i * V, xi);
    Vec<T>::load(gr + i * V, yr);
    Vec<T>::load(gi + i * V, yi);
#pragma unroll
    for (int k = 0; k < V; ++k) collapse_one(xr[k], xi[k], yr[k], yi[k], c, sign, scale, outr[k], outi[k]);
    Vec<T>::store(wr + i * V, outr);
    Vec<T>::store(wi + i * V, outi);
  }
  for (int64_t j = nvec * V + first; j < n; j += stride) {
    T yr, yi;
    collapse_one(wr[j], wi[j], gr[j], gi[j], c, sign, scale, yr, yi);
    wr[j] = yr;
    wi[j] = yi;
  }
}

bool bad_grid(int64_t grid, int64_t n) { return grid < 1 || grid > 65535 || n < 1; }

template <typename T>
int launch_branch_sums(const void* wr, const void* wi, const void* gr, const void* gi, const void* ct,
                       const void* st, double s2, void* partials, int64_t grid, int64_t n, void* stream) {
  if (bad_grid(grid, n)) return static_cast<int>(cudaErrorInvalidValue);
  sc_branch_sums_kernel<T><<<static_cast<unsigned>(grid), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(wr), static_cast<const T*>(wi), static_cast<const T*>(gr), static_cast<const T*>(gi),
      static_cast<const T*>(ct), static_cast<const T*>(st), static_cast<T>(s2), static_cast<double*>(partials), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_collapse(void* wr, void* wi, const void* gr, const void* gi, const void* ct, const void* st, double s2,
                    const void* partials, int64_t nparts, const void* r, int64_t force, void* bit, void* pcond,
                    int64_t grid, int64_t n, void* stream) {
  if (bad_grid(grid, n) || nparts < 1 || force > 1) return static_cast<int>(cudaErrorInvalidValue);
  sc_collapse_kernel<T><<<static_cast<unsigned>(grid), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(wr), static_cast<T*>(wi), static_cast<const T*>(gr), static_cast<const T*>(gi),
      static_cast<const T*>(ct), static_cast<const T*>(st), static_cast<T>(s2),
      static_cast<const double*>(partials), nparts, static_cast<const T*>(r), force, static_cast<int64_t*>(bit),
      static_cast<T*>(pcond), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wr, wi, gr, gi, ct, st, s2, partials, grid, n, stream
extern "C" int qc_sc_branch_sums_f32(void* wr, void* wi, void* gr, void* gi, void* ct, void* st, double s2,
                                     void* partials, int64_t grid, int64_t n, void* stream) {
  return launch_branch_sums<float>(wr, wi, gr, gi, ct, st, s2, partials, grid, n, stream);
}

extern "C" int qc_sc_branch_sums_f64(void* wr, void* wi, void* gr, void* gi, void* ct, void* st, double s2,
                                     void* partials, int64_t grid, int64_t n, void* stream) {
  return launch_branch_sums<double>(wr, wi, gr, gi, ct, st, s2, partials, grid, n, stream);
}

// wr, wi, gr, gi, ct, st, s2, partials, nparts, r, force, bit, pcond, grid, n, stream
extern "C" int qc_sc_collapse_f32(void* wr, void* wi, void* gr, void* gi, void* ct, void* st, double s2,
                                  void* partials, int64_t nparts, void* r, int64_t force, void* bit, void* pcond,
                                  int64_t grid, int64_t n, void* stream) {
  return launch_collapse<float>(wr, wi, gr, gi, ct, st, s2, partials, nparts, r, force, bit, pcond, grid, n, stream);
}

extern "C" int qc_sc_collapse_f64(void* wr, void* wi, void* gr, void* gi, void* ct, void* st, double s2,
                                  void* partials, int64_t nparts, void* r, int64_t force, void* bit, void* pcond,
                                  int64_t grid, int64_t n, void* stream) {
  return launch_collapse<double>(wr, wi, gr, gi, ct, st, s2, partials, nparts, r, force, bit, pcond, grid, n, stream);
}
