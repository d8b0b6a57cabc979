// The QAOA step's diagonal cost layer and its gradient's reductions, for
// Hopper (sm_90a) (ops/qaoa.py; algorithms/variational.qaoa_step calls them
// on the card).
//
// Replaces no TPU kernel: the JAX package evolves QAOA in XLA with a cost
// vector built on the host and differentiates the whole evolution with
// autograd.  The port's card route takes the gradient by the adjoint method
// instead (ops/qaoa.py's docstring), so its state never holds more than two
// 2^n vectors, psi and lambda; these four kernels are that route's passes
// other than the mixer's RX layers, which run as fused segments.
//
// The cost diagonal.  A MaxCut cut value c(x) is an integer (the edges'
// weights are whole numbers, their sum under 256), stored as one uint8 level
// an amplitude (`cost`, built on the card).  `vals[k]` is level k's value in
// float64 and `ph` the (K, 2) table exp(-+i gamma k) in the compute type,
// computed on the host in float64 and rounded once, so no amplitude needs a
// transcendental.  S is the plane type (float, double, bf16), T the compute
// type (float for float and bf16 planes, double for double): every product
// is formed in T and a bf16 amplitude is rounded once, at its store.
//
//   qaoa_phase_kernel       psi *= ph[c]                       (the cost layer)
//   qaoa_expect_kernel      sum |psi|^2 vals[c] in float64;    (the expected cut,
//                           lambda = vals[c] psi when asked     and the adjoint's seed)
//   qaoa_cost_grad_kernel   sum vals[c] Im(conj(lambda) psi);  (d/dgamma, then the
//                           psi *= ph[c], lambda *= ph[c]       cost layer undone)
//   qaoa_mixer_grad_kernel  sum over qubits q of a tile's set of
//                           Im(conj(lambda_i) psi_j + conj(lambda_j) psi_i),
//                           j = i with bit q set                (d/dbeta)
//
// Sums are per block of a persistent grid, in float64, written to
// `partials` (no atomics: the same inputs give the same sums); the wrapper
// adds them.  The elementwise kernels form each product behind a sum in
// float64 from the widened amplitudes; the mixer's reduction forms its
// products in T and sums a tile's in T before float64.
//
// What bounds them: bytes.  The three elementwise kernels stream the planes
// (16-byte loads of four amplitudes and their four levels) at a few flops a
// byte.  The mixer's reduction reads a tile of psi and lambda as the fused
// kernel stages a tile: the low t index bits (contiguous) and up to five
// "axis" bits above them, so one pass reads the pairs of every qubit of the
// tile once.  A tile of 2^12 amplitudes (2^11 at double) sits in the
// registers of 256 threads, 16 (8) a thread and plane, and pairs meet by
// warp shuffles, through 32 KB of shared memory or in a thread's registers
// (qaoa_mixer_grad_kernel), so a 30-qubit state takes five passes (qubits
// 0-11, then five axes at a time).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LEVELS = 256;

template <typename S>
struct Compute {
  using T = float;
};
template <>
struct Compute<double> {
  using T = double;
};

__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }

template <typename S>
__device__ __forceinline__ S narrow(typename Compute<S>::T x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ double narrow<double>(double x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// Four consecutive amplitudes of a plane, widened to T.
template <typename S>
struct Quad;

template <>
struct Quad<float> {
  static __device__ __forceinline__ void load(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct Quad<double> {
  static __device__ __forceinline__ void load(const double* p, double (&x)[4]) {
    const double2 a = reinterpret_cast<const double2*>(p)[0], b = reinterpret_cast<const double2*>(p)[1];
    x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
  }
  static __device__ __forceinline__ void store(double* p, const double (&x)[4]) {
    reinterpret_cast<double2*>(p)[0] = make_double2(x[0], x[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(x[2], x[3]);
  }
};

template <>
struct Quad<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[4]) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    x[0] = __low2float(a), x[1] = __high2float(a), x[2] = __low2float(b), x[3] = __high2float(b);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&x)[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]), b = __floats2bfloat162_rn(x[2], x[3]);
    uint2 v;
    v.x = *reinterpret_cast<const uint32_t*>(&a);
    v.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = v;
  }
};

__device__ __forceinline__ void levels4(const uint8_t* cost, int64_t i, int (&c)[4]) {
  const uchar4 v = reinterpret_cast<const uchar4*>(cost)[i];
  c[0] = v.x, c[1] = v.y, c[2] = v.z, c[3] = v.w;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block b's sum into partials[b] (a fixed order: warps, then warp 0's sums in turn).
__device__ __forceinline__ void block_sum_out(double acc, double* partials) {
  __shared__ double warps[WARPS];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s += warps[k];
    partials[blockIdx.x] = s;
  }
}

// x * (pr + i pi), in T.
template <typename T>
__device__ __forceinline__ void rotate(T& xr, T& xi, T pr, T pi) {
  const T r = xr * pr - xi * pi;
  xi = xr * pi + xi * pr;
  xr = r;
}

template <typename S>
__global__ void __launch_bounds__(THREADS)
qaoa_phase_kernel(S* __restrict__ re, S* __restrict__ im, const uint8_t* __restrict__ cost,
                  const typename Compute<S>::T* __restrict__ ph, int levels, int64_t n) {
  using T = typename Compute<S>::T;
  __shared__ T tab[2 * MAX_LEVELS];
  for (int k = threadIdx.x; k < 2 * levels; k += THREADS) tab[k] = ph[k];
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t nq = n / 4;
  for (int64_t i = first; i < nq; i += stride) {
    T xr[4], xi[4];
    int c[4];
    Quad<S>::load(re + 4 * i, xr);
    Quad<S>::load(im + 4 * i, xi);
    levels4(cost, i, c);
#pragma unroll
    for (int k = 0; k < 4; ++k) rotate(xr[k], xi[k], tab[2 * c[k]], tab[2 * c[k] + 1]);
    Quad<S>::store(re + 4 * i, xr);
    Quad<S>::store(im + 4 * i, xi);
  }
  for (int64_t j = 4 * nq + first; j < n; j += stride) {
    T xr = widen(re[j]), xi = widen(im[j]);
    rotate(xr, xi, tab[2 * cost[j]], tab[2 * cost[j] + 1]);
    re[j] = narrow<S>(xr);
    im[j] = narrow<S>(xi);
  }
}

template <typename S>
__global__ void __launch_bounds__(THREADS)
qaoa_expect_kernel(const S* __restrict__ re, const S* __restrict__ im, const uint8_t* __restrict__ cost,
                   const double* __restrict__ vals, S* __restrict__ lre, S* __restrict__ lim,
                   double* __restrict__ partials, int levels, int64_t n) {
  using T = typename Compute<S>::T;
  __shared__ double v[MAX_LEVELS];
  for (int k = threadIdx.x; k < levels; k += THREADS) v[k] = vals[k];
  __syncthreads();
  const bool seed = lre != nullptr;
  double acc = 0.0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t nq = n / 4;
  for (int64_t i = first; i < nq; i += stride) {
    T xr[4], xi[4];
    int c[4];
    Quad<S>::load(re + 4 * i, xr);
    Quad<S>::load(im + 4 * i, xi);
    levels4(cost, i, c);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const double r = xr[k], m = xi[k];
      acc += (r * r + m * m) * v[c[k]];
      const T w = static_cast<T>(v[c[k]]);
      xr[k] *= w;
      xi[k] *= w;
    }
    if (seed) {
      Quad<S>::store(lre + 4 * i, xr);
      Quad<S>::store(lim + 4 * i, xi);
    }
  }
  for (int64_t j = 4 * nq + first; j < n; j += stride) {
    const T xr = widen(re[j]), xi = widen(im[j]);
    const double r = xr, m = xi;
    acc += (r * r + m * m) * v[cost[j]];
    if (seed) {
      const T w = static_cast<T>(v[cost[j]]);
      lre[j] = narrow<S>(xr * w);
      lim[j] = narrow<S>(xi * w);
    }
  }
  block_sum_out(acc, partials);
}

template <typename S>
__global__ void __launch_bounds__(THREADS)
qaoa_cost_grad_kernel(S* __restrict__ re, S* __restrict__ im, S* __restrict__ lre, S* __restrict__ lim,
                      const uint8_t* __restrict__ cost, const double* __restrict__ vals,
                      const typename Compute<S>::T* __restrict__ ph, double* __restrict__ partials, int levels,
                      int write, int64_t n) {
  using T = typename Compute<S>::T;
  __shared__ double v[MAX_LEVELS];
  __shared__ T tab[2 * MAX_LEVELS];
  for (int k = threadIdx.x; k < levels; k += THREADS) {
    v[k] = vals[k];
    tab[2 * k] = ph[2 * k];
    tab[2 * k + 1] = ph[2 * k + 1];
  }
  __syncthreads();
  double acc = 0.0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t nq = n / 4;
  for (int64_t i = first; i < nq; i += stride) {
    T xr[4], xi[4], yr[4], yi[4];
    int c[4];
    Quad<S>::load(re + 4 * i, xr);
    Quad<S>::load(im + 4 * i, xi);
    Quad<S>::load(lre + 4 * i, yr);
    Quad<S>::load(lim + 4 * i, yi);
    levels4(cost, i, c);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc += v[c[k]] * (static_cast<double>(yr[k]) * xi[k] - static_cast<double>(yi[k]) * xr[k]);
      rotate(xr[k], xi[k], tab[2 * c[k]], tab[2 * c[k] + 1]);
      rotate(yr[k], yi[k], tab[2 * c[k]], tab[2 * c[k] + 1]);
    }
    if (write) {
      Quad<S>::store(re + 4 * i, xr);
      Quad<S>::store(im + 4 * i, xi);
      Quad<S>::store(lre + 4 * i, yr);
      Quad<S>::store(lim + 4 * i, yi);
    }
  }
  for (int64_t j = 4 * nq + first; j < n; j += stride) {
    T xr = widen(re[j]), xi = widen(im[j]), yr = widen(lre[j]), yi = widen(lim[j]);
    const int c = cost[j];
    acc += v[c] * (static_cast<double>(yr) * xi - static_cast<double>(yi) * xr);
    if (write) {
      rotate(xr, xi, tab[2 * c], tab[2 * c + 1]);
      rotate(yr, yi, tab[2 * c], tab[2 * c + 1]);
      re[j] = narrow<S>(xr), im[j] = narrow<S>(xi), lre[j] = narrow<S>(yr), lim[j] = narrow<S>(yi);
    }
  }
  block_sum_out(acc, partials);
}

// Global index of tile element e: the low t bits as they are, bit t + k of e
// at axis k's position, and the tile's own index spread over the other bits.
struct TileMap {
  int t, naxes;
  int axes[16];
  int64_t low_mask;

  __device__ __forceinline__ int64_t element(int64_t base, int64_t e) const {
    int64_t g = base | (e & low_mask);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < naxes) g |= ((e >> (t + k)) & 1) << axes[k];
    }
    return g;
  }
  // Bits of `tile` deposited, lowest first, into the positions >= t that are no axis.
  __device__ __forceinline__ int64_t base(int64_t tile) const {
    int64_t g = 0;
    int pos = t;
    for (int64_t rest = tile; rest; rest >>= 1, ++pos) {
#pragma unroll
      for (int k = 0; k < 16; ++k) pos += (k < naxes && pos == axes[k]);
      g |= (rest & 1) << pos;
    }
    return g;
  }
};

// sum over the tile's elements i and the tile-local bits p of `qmask` of
// Im(conj(lambda_i) psi_(i ^ 2^p)), over the tiles a block takes.  Thread
// `tid` holds elements e = tid + THREADS r, r < R, of the four planes in
// registers: bits 0-4 of e are its lane, 5-7 its warp, 8 and up r.  So a
// partner across bit p < 5 comes by a warp shuffle, across bits 5-7 from
// psi staged in shared memory, and across bits >= 8 from the thread's own
// registers.  Each element pairs with its partner once, so every pair's two
// terms are summed.  A thread sums a tile's products in T and adds that to
// its float64 sum: a conversion an element and position to float64 would
// hold the pass at the card's conversion rate (15-18 ms a pass at n = 30,
// three times its bound).
template <typename S, int R>
__global__ void __launch_bounds__(THREADS)
qaoa_mixer_grad_kernel(const S* __restrict__ re, const S* __restrict__ im, const S* __restrict__ lre,
                       const S* __restrict__ lim, double* __restrict__ partials, TileMap map, int64_t qmask,
                       int64_t ntiles) {
  using T = typename Compute<S>::T;
  extern __shared__ unsigned char smem_raw[];
  T* sr = reinterpret_cast<T*>(smem_raw);
  T* si = sr + THREADS * R;
  const int tid = threadIdx.x;
  const int64_t tile = int64_t(1) << (map.t + map.naxes);
  const bool staged = (qmask & 0xe0) != 0;
  // Element e = tid + THREADS r sits at base | element(0, tid) | element(0, THREADS r):
  // the bits of tid and of r land on disjoint positions.
  __shared__ int64_t roff[R];
  if (tid < R) roff[tid] = map.element(0, int64_t(THREADS) * tid);
  const int64_t toff = map.element(0, tid);
  __syncthreads();
  double acc = 0.0;
  for (int64_t tl = blockIdx.x; tl < ntiles; tl += gridDim.x) {
    T part = T(0);
    const int64_t base = map.base(tl);
    T xr[R], xi[R], yr[R], yi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t e = tid + int64_t(THREADS) * r;
      if (e < tile) {
        const int64_t g = base | toff | roff[r];
        xr[r] = widen(re[g]), xi[r] = widen(im[g]), yr[r] = widen(lre[g]), yi[r] = widen(lim[g]);
      } else {
        xr[r] = xi[r] = yr[r] = yi[r] = T(0);
      }
    }
    if (staged) {
#pragma unroll
      for (int r = 0; r < R; ++r) sr[tid + THREADS * r] = xr[r], si[tid + THREADS * r] = xi[r];
      __syncthreads();
    }
#pragma unroll
    for (int p = 0; p < 5; ++p) {
      if (!((qmask >> p) & 1)) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T pr = __shfl_xor_sync(0xffffffffu, xr[r], 1 << p), pi = __shfl_xor_sync(0xffffffffu, xi[r], 1 << p);
        part += yr[r] * pi - yi[r] * pr;
      }
    }
    if (staged) {
#pragma unroll
      for (int p = 5; p < 8; ++p) {
        if (!((qmask >> p) & 1)) continue;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int e = (tid ^ (1 << p)) + THREADS * r;
          part += yr[r] * si[e] - yi[r] * sr[e];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int b = 0; (1 << b) < R; ++b) {
      if (!((qmask >> (8 + b)) & 1)) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int q = r ^ (1 << b);
        part += yr[r] * xi[q] - yi[r] * xr[q];
      }
    }
    acc += static_cast<double>(part);
  }
  block_sum_out(acc, partials);
}

bool bad(int64_t grid, int64_t n, int levels) {
  return grid < 1 || grid > (int64_t(1) << 31) - 1 || n < 1 || levels < 1 || levels > MAX_LEVELS;
}

template <typename S>
int launch_phase(void* re, void* im, const void* cost, const void* ph, int64_t levels, int64_t grid, int64_t n,
                 void* stream) {
  using T = typename Compute<S>::T;
  if (bad(grid, n, static_cast<int>(levels))) return static_cast<int>(cudaErrorInvalidValue);
  qaoa_phase_kernel<S><<<static_cast<unsigned>(grid), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<S*>(re), static_cast<S*>(im), static_cast<const uint8_t*>(cost), static_cast<const T*>(ph),
      static_cast<int>(levels), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_expect(const void* re, const void* im, const void* cost, const void* vals, void* lre, void* lim,
                  void* partials, int64_t levels, int64_t grid, int64_t n, void* stream) {
  if (bad(grid, n, static_cast<int>(levels))) return static_cast<int>(cudaErrorInvalidValue);
  qaoa_expect_kernel<S><<<static_cast<unsigned>(grid), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(re), static_cast<const S*>(im), static_cast<const uint8_t*>(cost),
      static_cast<const double*>(vals), static_cast<S*>(lre), static_cast<S*>(lim), static_cast<double*>(partials),
      static_cast<int>(levels), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_cost_grad(void* re, void* im, void* lre, void* lim, const void* cost, const void* vals, const void* ph,
                     void* partials, int64_t levels, int64_t write, int64_t grid, int64_t n, void* stream) {
  using T = typename Compute<S>::T;
  if (bad(grid, n, static_cast<int>(levels))) return static_cast<int>(cudaErrorInvalidValue);
  qaoa_cost_grad_kernel<S><<<static_cast<unsigned>(grid), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<S*>(re), static_cast<S*>(im), static_cast<S*>(lre), static_cast<S*>(lim),
      static_cast<const uint8_t*>(cost), static_cast<const double*>(vals), static_cast<const T*>(ph),
      static_cast<double*>(partials), static_cast<int>(levels), static_cast<int>(write != 0), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_mixer_grad(const void* re, const void* im, const void* lre, const void* lim, void* partials, int64_t nq,
                      int64_t t, int64_t naxes, int64_t axes_packed, int64_t qmask, int64_t grid, void* stream) {
  using T = typename Compute<S>::T;
  if (t < 0 || naxes < 0 || naxes > 16 || t + naxes > nq || nq > 62 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TileMap map;
  map.t = static_cast<int>(t);
  map.naxes = static_cast<int>(naxes);
  map.low_mask = (int64_t(1) << t) - 1;
  for (int k = 0; k < 16; ++k) map.axes[k] = k < naxes ? static_cast<int>((axes_packed >> (8 * k)) & 0xff) : 0;
  for (int k = 0; k < naxes; ++k) {
    if (map.axes[k] < t || map.axes[k] >= nq || (k > 0 && map.axes[k] <= map.axes[k - 1])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int64_t ntiles = int64_t(1) << (nq - t - naxes);
  const int tb = static_cast<int>(t + naxes);
  const int rbits = tb > 8 ? tb - 8 : 0;
  if (rbits > 4 || (qmask >> tb) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(T) * 2 * THREADS * (size_t(1) << rbits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const S* args[4] = {static_cast<const S*>(re), static_cast<const S*>(im), static_cast<const S*>(lre),
                      static_cast<const S*>(lim)};
  double* out = static_cast<double*>(partials);
  const unsigned g = static_cast<unsigned>(grid);
  switch (rbits) {
    case 0: qaoa_mixer_grad_kernel<S, 1><<<g, THREADS, smem, st>>>(args[0], args[1], args[2], args[3], out, map, qmask, ntiles); break;
    case 1: qaoa_mixer_grad_kernel<S, 2><<<g, THREADS, smem, st>>>(args[0], args[1], args[2], args[3], out, map, qmask, ntiles); break;
    case 2: qaoa_mixer_grad_kernel<S, 4><<<g, THREADS, smem, st>>>(args[0], args[1], args[2], args[3], out, map, qmask, ntiles); break;
    case 3: qaoa_mixer_grad_kernel<S, 8><<<g, THREADS, smem, st>>>(args[0], args[1], args[2], args[3], out, map, qmask, ntiles); break;
    default: qaoa_mixer_grad_kernel<S, 16><<<g, THREADS, smem, st>>>(args[0], args[1], args[2], args[3], out, map, qmask, ntiles); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define QC_QAOA_ENTRIES(SUFFIX, S)                                                                                 \
  /* re, im, cost, ph, levels, grid, n, stream */                                                                 \
  extern "C" int qc_qaoa_phase_##SUFFIX(void* re, void* im, void* cost, void* ph, int64_t levels, int64_t grid,  \
                                        int64_t n, void* stream) {                                               \
    return launch_phase<S>(re, im, cost, ph, levels, grid, n, stream);                                           \
  }                                                                                                               \
  /* re, im, cost, vals, lre, lim, partials, levels, grid, n, stream */                                           \
  extern "C" int qc_qaoa_expect_##SUFFIX(void* re, void* im, void* cost, void* vals, void* lre, void* lim,       \
                                         void* partials, int64_t levels, int64_t grid, int64_t n, void* stream) { \
    return launch_expect<S>(re, im, cost, vals, lre, lim, partials, levels, grid, n, stream);                    \
  }                                                                                                               \
  /* re, im, lre, lim, cost, vals, ph, partials, levels, write, grid, n, stream */                                \
  extern "C" int qc_qaoa_cost_grad_##SUFFIX(void* re, void* im, void* lre, void* lim, void* cost, void* vals,    \
                                            void* ph, void* partials, int64_t levels, int64_t write,             \
                                            int64_t grid, int64_t n, void* stream) {                             \
    return launch_cost_grad<S>(re, im, lre, lim, cost, vals, ph, partials, levels, write, grid, n, stream);      \
  }                                                                                                               \
  /* re, im, lre, lim, partials, nq, t, naxes, axes_packed, qmask, grid, stream */                                \
  extern "C" int qc_qaoa_mixer_grad_##SUFFIX(void* re, void* im, void* lre, void* lim, void* partials,           \
                                             int64_t nq, int64_t t, int64_t naxes, int64_t axes_packed,          \
                                             int64_t qmask, int64_t grid, void* stream) {                        \
    return launch_mixer_grad<S>(re, im, lre, lim, partials, nq, t, naxes, axes_packed, qmask, grid, stream);     \
  }

QC_QAOA_ENTRIES(f32, float)
QC_QAOA_ENTRIES(f64, double)
QC_QAOA_ENTRIES(bf16, __nv_bfloat16)
