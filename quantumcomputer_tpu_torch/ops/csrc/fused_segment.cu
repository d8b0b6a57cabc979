// Fused gate segment on a planar state vector, for Hopper (sm_90a).
//
// Replaces quantumcomputer_tpu/ops/pallas_fused.py::_fused_kernel (the TPU
// kernel behind apply_fused): one pass that reads every amplitude once,
// applies a planned segment of gate ops to it on chip, and writes it back
// once, in place.  Op kinds (ops/fused.py builds the descriptors):
//   u1q   dense 2x2 on one qubit
//   diag1 diagonal 2-vector on one qubit
//   diag2 diagonal 4-vector on two qubits
//   iqft  H(l), then exp(i*pi*(i & (2^l - 2^M)) / 2^l) on the bit-l == 1 half
//   u2q   dense 4x4 on two qubits
//
// What bounds it: device-memory bandwidth.  Each op is a few flops per
// amplitude, so a one-op pass moves 2 x 2 x sizeof(T) bytes per amplitude
// for almost no arithmetic.  The design answer is the TPU kernel's: fuse a
// whole segment into one pass, so G gates cost one read and one write of
// the state instead of G of each.  Within the pass, each thread issues
// LOAD_BATCH independent loads before it stores any of them to shared
// memory, so enough bytes are in flight to stream device memory.
//
// Tiling.  A CUDA block owns one disjoint tile of 2^(t+k) amplitudes: the
// low t index bits (contiguous, so loads and stores coalesce) plus k
// exposed "axis" bits >= t, one per butterfly target above the low bits.
// Every butterfly partner of every op in the segment therefore lies in the
// same tile, which sits in shared memory while the ops run.  Diagonal ops
// and the iQFT phase need only the element's global index: 64-bit (n may
// reach 31), from a per-block table of the 2^k axis combinations OR'd with
// the element's low bits.  The iQFT angle is formed from the
// exact integer (i & mask) in double precision with sincospi: in float,
// (i & mask) would round once it exceeds the 24-bit mantissa (l > 24).
//
// The op list arrives as two small device arrays: ops_i (int32 records of
// OPI_STRIDE: kind, qa, qb, pa, pb, unused; pa/pb are the tile-local bit
// positions of the targets) and ops_f (float64 records of OPF_STRIDE).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OP_U1Q = 0;
constexpr int OP_DIAG1 = 1;
constexpr int OP_DIAG2 = 2;
constexpr int OP_IQFT = 3;
constexpr int OP_U2Q = 4;
constexpr int OPI_STRIDE = 6;
constexpr int OPF_STRIDE = 32;  // a 4x4 complex matrix: 16 re, then 16 im
constexpr int MAX_AXES = 8;
constexpr int THREADS = 256;
constexpr int LOAD_BATCH = 8;  // loads in flight per thread while filling a tile

struct Geom {
  int t;               // low contiguous index bits of a tile
  int k;               // exposed axis bits
  int axes[MAX_AXES];  // ascending global bit positions, each >= t
};

__device__ __forceinline__ int64_t insert_zero(int64_t x, int p) {
  const int64_t low = x & ((int64_t(1) << p) - 1);
  return ((x >> p) << (p + 1)) | low;
}

// At most 64 registers a thread, so four blocks fit an SM and one block's
// loads overlap another's shared-memory work.
template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
fused_segment_kernel(T* __restrict__ re, T* __restrict__ im, const int* __restrict__ ops_i,
                     const double* __restrict__ ops_f, int nops, Geom g, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  // Global index of tile element j: hi[j >> t] | (j & low_mask), where
  // hi[c] is the tile base with axis bits set from the combination c.
  __shared__ int64_t hi[1 << MAX_AXES];
  const int tile = 1 << (g.t + g.k);
  const int64_t low_mask = (int64_t(1) << g.t) - 1;
  T* sre = reinterpret_cast<T*>(smem);
  T* sim = sre + tile;

  if (threadIdx.x < (1 << g.k)) {
    // Tile base: the block index spread over the bits that are neither low
    // nor exposed (zeros inserted at the axis positions, ascending).
    int64_t base = (int64_t)blockIdx.x << g.t;
    for (int a = 0; a < g.k; ++a) base = insert_zero(base, g.axes[a]);
    for (int a = 0; a < g.k; ++a) base |= (int64_t)((threadIdx.x >> a) & 1) << g.axes[a];
    hi[threadIdx.x] = base;
  }
  __syncthreads();
#define GLOBAL_INDEX(j) (hi[(j) >> g.t] | ((int64_t)(j) & low_mask))

  // Load: LOAD_BATCH independent loads per thread in flight before any
  // shared-memory store, so enough bytes are outstanding to stream HBM.
  for (int j0 = threadIdx.x; j0 < tile; j0 += THREADS * LOAD_BATCH) {
    T r[LOAD_BATCH], m[LOAD_BATCH];
#pragma unroll
    for (int v = 0; v < LOAD_BATCH; ++v) {
      const int j = j0 + v * THREADS;
      if (j < tile) {
        const int64_t idx = GLOBAL_INDEX(j);
        r[v] = re[idx];
        m[v] = im[idx];
      }
    }
#pragma unroll
    for (int v = 0; v < LOAD_BATCH; ++v) {
      const int j = j0 + v * THREADS;
      if (j < tile) {
        sre[j] = r[v];
        sim[j] = m[v];
      }
    }
  }
  __syncthreads();

  for (int o = 0; o < nops; ++o) {
    const int* oi = ops_i + OPI_STRIDE * o;
    const double* of = ops_f + OPF_STRIDE * o;
    const int kind = oi[0];
    if (kind == OP_U1Q) {
      const int p = oi[3];
      const T u00r = of[0], u01r = of[1], u10r = of[2], u11r = of[3];
      const T u00i = of[4], u01i = of[5], u10i = of[6], u11i = of[7];
      for (int k2 = threadIdx.x; k2 < tile / 2; k2 += THREADS) {
        const int j0 = (int)insert_zero(k2, p);
        const int j1 = j0 | (1 << p);
        const T ar = sre[j0], ai = sim[j0], br = sre[j1], bi = sim[j1];
        sre[j0] = (u00r * ar - u00i * ai) + (u01r * br - u01i * bi);
        sim[j0] = (u00r * ai + u00i * ar) + (u01r * bi + u01i * br);
        sre[j1] = (u10r * ar - u10i * ai) + (u11r * br - u11i * bi);
        sim[j1] = (u10r * ai + u10i * ar) + (u11r * bi + u11i * br);
      }
    } else if (kind == OP_DIAG1) {
      const int q = oi[1];
      for (int j = threadIdx.x; j < tile; j += THREADS) {
        const int b = (int)((GLOBAL_INDEX(j) >> q) & 1);
        const T pr = of[2 * b], pi = of[2 * b + 1];
        const T xr = sre[j], xi = sim[j];
        sre[j] = xr * pr - xi * pi;
        sim[j] = xr * pi + xi * pr;
      }
    } else if (kind == OP_DIAG2) {
      const int qh = oi[1], ql = oi[2];
      for (int j = threadIdx.x; j < tile; j += THREADS) {
        const int64_t idx = GLOBAL_INDEX(j);
        const int d = (int)(2 * ((idx >> qh) & 1) + ((idx >> ql) & 1));
        const T pr = of[d], pi = of[4 + d];
        const T xr = sre[j], xi = sim[j];
        sre[j] = xr * pr - xi * pi;
        sim[j] = xr * pi + xi * pr;
      }
    } else if (kind == OP_IQFT) {
      const int l = oi[1], p = oi[3];
      const int64_t mask = l > M ? (int64_t(1) << l) - (int64_t(1) << M) : 0;
      const double inv = 1.0 / (double)(int64_t(1) << l);  // exact: a power of two
      const T s = (T)0.70710678118654752440;
      for (int k2 = threadIdx.x; k2 < tile / 2; k2 += THREADS) {
        const int j0 = (int)insert_zero(k2, p);
        const int j1 = j0 | (1 << p);
        const T ar = sre[j0], ai = sim[j0], br = sre[j1], bi = sim[j1];
        sre[j0] = s * (ar + br);
        sim[j0] = s * (ai + bi);
        T hr = s * (ar - br), hi_ = s * (ai - bi);
        if (mask) {
          double sn, cs;
          sincospi((double)(GLOBAL_INDEX(j1) & mask) * inv, &sn, &cs);
          const T c = (T)cs, sv = (T)sn;
          const T nr = hr * c - hi_ * sv;
          hi_ = hr * sv + hi_ * c;
          hr = nr;
        }
        sre[j1] = hr;
        sim[j1] = hi_;
      }
    } else if (kind == OP_U2Q) {
      const int ph = oi[3], pl = oi[4];  // ph > pl
      for (int k4 = threadIdx.x; k4 < tile / 4; k4 += THREADS) {
        const int b0 = (int)insert_zero(insert_zero(k4, pl), ph);
        int e[4];
        T xr[4], xi[4];
        for (int r = 0; r < 4; ++r) {
          e[r] = b0 | ((r >> 1) << ph) | ((r & 1) << pl);
          xr[r] = sre[e[r]];
          xi[r] = sim[e[r]];
        }
        for (int r = 0; r < 4; ++r) {
          T yr = 0, yi = 0;
          for (int c = 0; c < 4; ++c) {
            const T mr = of[4 * r + c], mi = of[16 + 4 * r + c];
            yr += mr * xr[c] - mi * xi[c];
            yi += mr * xi[c] + mi * xr[c];
          }
          sre[e[r]] = yr;
          sim[e[r]] = yi;
        }
      }
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < tile; j += THREADS) {
    const int64_t idx = GLOBAL_INDEX(j);
    re[idx] = sre[j];
    im[idx] = sim[j];
  }
#undef GLOBAL_INDEX
}

template <typename T>
int launch_fused(void* re, void* im, const void* ops_i, const void* ops_f, int64_t nops,
                 int64_t n, int64_t t, int64_t naxes, int64_t axes_packed, int64_t M,
                 void* stream) {
  if (naxes < 0 || naxes > MAX_AXES || t < 0 || t + naxes > n || n - t - naxes > 30) {
    return (int)cudaErrorInvalidValue;
  }
  Geom g;
  g.t = (int)t;
  g.k = (int)naxes;
  for (int a = 0; a < MAX_AXES; ++a) g.axes[a] = a < naxes ? (int)((axes_packed >> (8 * a)) & 0xff) : 0;
  const size_t smem = 2 * sizeof(T) * (size_t(1) << (t + naxes));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_segment_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned int tiles = (unsigned int)(int64_t(1) << (n - t - naxes));
  fused_segment_kernel<T><<<tiles, THREADS, smem, (cudaStream_t)stream>>>(
      (T*)re, (T*)im, (const int*)ops_i, (const double*)ops_f, (int)nops, g, (int)M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qc_fused_segment_f32(void* re, void* im, void* ops_i, void* ops_f, int64_t nops,
                                    int64_t n, int64_t t, int64_t naxes, int64_t axes_packed,
                                    int64_t M, void* stream) {
  return launch_fused<float>(re, im, ops_i, ops_f, nops, n, t, naxes, axes_packed, M, stream);
}

extern "C" int qc_fused_segment_f64(void* re, void* im, void* ops_i, void* ops_f, int64_t nops,
                                    int64_t n, int64_t t, int64_t naxes, int64_t axes_packed,
                                    int64_t M, void* stream) {
  return launch_fused<double>(re, im, ops_i, ops_f, nops, n, t, naxes, axes_packed, M, stream);
}

extern "C" const char* qc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
