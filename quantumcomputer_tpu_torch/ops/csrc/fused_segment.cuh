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
//   camodc  where control bit c is 1, the work register [0, M) permuted
//         f -> A*f mod C: the branch camodc_k of the TPU kernel
//         (pallas_fused.py:967-997), there 2M - 1 masked exchange stages
//         because TPU lanes cannot gather.  Here it is a shared-memory
//         gather by the inverse permutation (run_camodc): one read and one
//         write of shared memory per moved element, against 2M - 1 of each
//         for the stages.  Its segment's tile holds whole 2^M-element work
//         blocks (t >= M, at most 2^13 amplitudes; one ring slot when two do
//         not fit MAX_RING_BYTES), and a tile on which every op is a camodc
//         whose tile-base control bit is 0 is neither loaded nor stored.
//   lanemat, rowmat, xtable  the matrix groups of float32 and bf16 segments
//         (ops/fused.py, matmul_group_ops): a chain of ops on bits 0-6 as
//         one 128 x 128 product, on bits 7-12 as one 64 x 64 product, the
//         iQFT row stages' lane-cross phases as one (64, 128) table; the
//         TPU kernel's MXU branches (pallas_fused.py:911-966), here on the
//         tensor cores (run_matrix, below; instances of their own, MAT, in
//         fused_matmul.cu).  Their segment's tile is 2^13 amplitudes.
//
// What bounds it: device-memory bandwidth, one read and one write of the
// state per segment (1.282 ms for a 2 GiB complex64 state at 3.35 TB/s),
// as long as the ops' arithmetic hides behind the copies.  Three costs
// stand in the way, and the design answers each:
//
//   * Transcendentals.  An iQFT op's phase exp(i*pi*(idx & mask)/2^l) is
//     split as the TPU kernel splits it, over disjoint bit fields of the
//     index: (idx & mask) = (tile base & mask) + (axis bits & mask) + (low
//     bits & mask) + (slot bits & mask).  F_base is one double sincospi per
//     op per tile (shared memory); F_axes and F_low are tables built on the
//     host in float64 and rounded once to the plane dtype (ftab), and each
//     slot bit's factor sits in the op's coefficient record.  No amplitude
//     needs a transcendental: its phase is P * (slot factors), P = F_base *
//     F_axes * F_low once per thread.
//   * Shared-memory passes.  A thread holds 2^NE amplitudes in registers
//     (the low VB index bits, 16 bytes of a plane, plus NE - VB more tile
//     bits, its "slots") and applies a whole group of consecutive ops whose
//     targets are all slots, so a segment costs one shared-memory round trip
//     per group (ops/fused.py, _group_ops), not one per op.  The tile's
//     16-byte chunks are XOR-swizzled so that the threads of a warp hit
//     distinct banks whichever bits a group holds.
//   * Exposed latency.  Blocks are persistent (as many as fit the SMs) and
//     walk the tiles; while a tile's ops run, the next tile arrives by
//     16-byte cp.async into the block's second buffer, and stores leave as
//     16-byte vectors.  (Deeper rings measured slower: they cost blocks.)
//
// What bounds it on the H100, measured at n = 28: issue, not bytes, once a
// segment has more than about five ops.  Two blocks of 256 threads an SM
// (128 registers a thread) leave few warps to hide each op's dependent
// arithmetic, so the m_high layout's 10- and 12-op segments reach about
// half of the bound while 3- and 5-op segments reach 70-85% (PERF.md).  A
// real 2x2 matrix (H, X, RY) takes half the multiplies, and op records are
// read from a shared-memory copy that each block makes once.
//
// Tiling: a tile holds 2^(t+k) amplitudes, the low t index bits
// (contiguous) plus k exposed "axis" bits >= t, one per butterfly target
// above the low bits, so every butterfly of the segment stays in the tile.
// States too small for the register group (fewer than NE tile bits, or
// t < VB) take the edge form VB = 0, NE = all tile bits, with scalar copies;
// so do planes that are not 16-byte aligned, for their copies.
//
// bf16 storage ("complex32", qc_fused_segment_bf16; the TPU kernel's
// store_bf16 instance, pallas_fused.py:1010-1025): the planes are bf16 in
// device memory and every op computes in f32, rounded to bf16 once per
// pass, at the store, as the TPU kernel does.  cp.async cannot convert, so a
// tile arrives by 16-byte cp.async into a bf16 staging slot and is widened
// once into an f32 work tile before the first register group; the staging
// slot is then free, and the next tile's copy overlaps this tile's ops from
// that one slot (16 KB staging + 32 KB work, against the f32 ring's 64 KB).
// The other design, synchronous 16-byte loads widened in registers, would
// cost no staging slot but leave each tile's load exposed behind its ops.
//
// The op list arrives as device arrays: ops_i (int32 records of OPI_STRIDE:
// kind, q1, q2, slot of q1, slot of q2, then for an iQFT op the ftab offsets
// of F_axes and F_low and 1 when it has a phase; for a camodc op kind,
// control, M, the control's tile-local position or -1 for a tile-base bit,
// -1, its offset in ptab; for a matrix op its table's byte offset in mtab
// and 1 for a real table, at [5] and [6]), ops_f (coefficients in the plane dtype,
// OPF_STRIDE per op; an iQFT op's slot factors), groups (GRP_STRIDE:
// op_begin, op_end, extra slot positions; a camodc op is a group of its
// own, and so is a matrix op), ftab (complex tables, re/im interleaved),
// ptab (each camodc op's inverse permutation, 2^M int16) and mtab (the
// matrix ops' tables).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int OP_U1Q = 0;
constexpr int OP_DIAG1 = 1;
constexpr int OP_DIAG2 = 2;
constexpr int OP_IQFT = 3;
constexpr int OP_U2Q = 4;
constexpr int OP_CAMODC = 5;
constexpr int OP_LANEMAT = 6;  // the matrix groups (fused_matmul.cu's instances only)
constexpr int OP_ROWMAT = 7;
constexpr int OP_XTABLE = 8;
constexpr int OPI_STRIDE = 8;
constexpr int OPF_STRIDE = 32;  // a 4x4 complex matrix: 16 re, then 16 im
constexpr int GRP_STRIDE = 8;
constexpr int MAX_AXES = 8;
constexpr int THREADS = 256;
constexpr int MAX_PERM_TILE_BITS = 13;  // a camodc segment's tile (M <= 13) and a matrix segment's
// The ring holds two tiles (one computed, one arriving) when they fit these
// bytes, else one; only camodc segments' larger tiles take one.
constexpr size_t MAX_RING_BYTES = size_t(128) << 10;

struct Geom {
  int t;               // low contiguous index bits of a tile
  int k;               // exposed axis bits
  int axes[MAX_AXES];  // ascending global bit positions, each >= t
};

template <typename T>
using Chunk = typename std::conditional<sizeof(T) == 4, float4, double2>::type;  // 16 bytes

__device__ __forceinline__ int64_t insert_zero(int64_t x, int p) {
  const int64_t low = x & ((int64_t(1) << p) - 1);
  return ((x >> p) << (p + 1)) | low;
}

// Global index of tile tau's first amplitude: tau spread over the bits that
// are neither low nor exposed.  Row c of the tile starts at tile_base | axoff[c].
__device__ __forceinline__ int64_t tile_base(int64_t tau, const Geom& g) {
  int64_t base = tau << g.t;
#pragma unroll
  for (int a = 0; a < MAX_AXES; ++a) {  // static indices: g stays in the parameter space
    if (a < g.k) base = insert_zero(base, g.axes[a]);
  }
  return base;
}

// Shared-memory position of tile element j: its 2^VB-element chunk XORed in
// the low three chunk bits with a mix of the bits above them (a bijection;
// chunks stay whole, so 16-byte copies land intact).
template <int VB>
__device__ __forceinline__ int swz(int j) {
  const int c = j >> VB;
  const int v = c >> 3;
  return ((c ^ ((v ^ (v << 1) ^ (v << 2)) & 7)) << VB) | (j & ((1 << VB) - 1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait_group() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Start the copy of tile tau into (sre, sim), element j at swz<VB>(j):
// 16-byte chunks of 2^VB elements when `vec`, else one element per copy
// (synchronous for 2-byte elements, which cp.async cannot copy).
template <typename T, int VB>
__device__ __forceinline__ void load_tile(T* sre, T* sim, const T* re, const T* im, int64_t tbase,
                                          const int64_t* axoff, const Geom& g, bool vec) {
  const int tb = g.t + g.k;
  if (vec) {
    const int rbits = g.t - VB;  // chunks per row: 2^rbits
    for (int q = threadIdx.x; q < (1 << (tb - VB)); q += THREADS) {
      const int64_t idx = tbase | axoff[q >> rbits] | ((int64_t)(q & ((1 << rbits) - 1)) << VB);
      const int p = swz<VB>(q << VB);
      cp_async16(sre + p, re + idx);
      cp_async16(sim + p, im + idx);
    }
  } else {
    const int low_mask = (1 << g.t) - 1;
    for (int j = threadIdx.x; j < (1 << tb); j += THREADS) {
      const int64_t idx = tbase | axoff[j >> g.t] | (j & low_mask);
      const int p = swz<VB>(j);
      if constexpr (sizeof(T) >= 4) {
        cp_async_ca<sizeof(T)>(sre + p, re + idx);
        cp_async_ca<sizeof(T)>(sim + p, im + idx);
      } else {
        sre[p] = re[idx];
        sim[p] = im[idx];
      }
    }
  }
}

// bf16 storage: the staging slot (element j at swz<SB>(j), SB = 3: a
// 16-byte chunk is 8 elements) widened into the f32 work tile (element j at
// swz<VB>(j)), exactly.  With VB = 2 a thread moves 4 elements, 8 bytes in
// and 16 out (4 consecutive elements are contiguous in both layouts).
template <int SB, int VB>
__device__ __forceinline__ void widen_tile(const __nv_bfloat16* s, float* w, int tile) {
  if constexpr (VB == 2) {
    for (int q = threadIdx.x; q < tile / 4; q += THREADS) {
      const uint2 v = *reinterpret_cast<const uint2*>(s + swz<SB>(4 * q));
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
      *reinterpret_cast<float4*>(w + swz<VB>(4 * q)) = make_float4(a.x, a.y, b.x, b.y);
    }
  } else {
    for (int j = threadIdx.x; j < tile; j += THREADS) w[swz<VB>(j)] = __bfloat162float(s[swz<SB>(j)]);
  }
}

// bf16 storage: store the f32 work tile, each element rounded once to the
// nearest bf16 (ties to even).  With `vec` (VB = 2, t >= 3) a thread stores
// 4 elements as 8 bytes.
template <int VB>
__device__ __forceinline__ void store_tile_bf16(const float* sre, const float* sim, __nv_bfloat16* re,
                                                __nv_bfloat16* im, int64_t tbase, const int64_t* axoff,
                                                const Geom& g, bool vec) {
  const int tb = g.t + g.k;
  if (VB == 2 && vec) {
    const int rbits = g.t - 2;
    for (int q = threadIdx.x; q < (1 << (tb - 2)); q += THREADS) {
      const int64_t idx = tbase | axoff[q >> rbits] | ((int64_t)(q & ((1 << rbits) - 1)) << 2);
      const int p = swz<VB>(q << 2);
#pragma unroll
      for (int plane = 0; plane < 2; ++plane) {
        const float4 x = *reinterpret_cast<const float4*>((plane ? sim : sre) + p);
        const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y), b = __floats2bfloat162_rn(x.z, x.w);
        uint2 v;
        v.x = *reinterpret_cast<const unsigned*>(&a);
        v.y = *reinterpret_cast<const unsigned*>(&b);
        *reinterpret_cast<uint2*>((plane ? im : re) + idx) = v;
      }
    }
  } else {
    const int low_mask = (1 << g.t) - 1;
    for (int j = threadIdx.x; j < (1 << tb); j += THREADS) {
      const int64_t idx = tbase | axoff[j >> g.t] | (j & low_mask);
      const int p = swz<VB>(j);
      re[idx] = __float2bfloat16_rn(sre[p]);
      im[idx] = __float2bfloat16_rn(sim[p]);
    }
  }
}

template <typename T, int VB>
__device__ __forceinline__ void store_tile(const T* sre, const T* sim, T* re, T* im, int64_t tbase,
                                           const int64_t* axoff, const Geom& g, bool vec) {
  const int tb = g.t + g.k;
  if (vec) {
    const int rbits = g.t - VB;
    for (int q = threadIdx.x; q < (1 << (tb - VB)); q += THREADS) {
      const int64_t idx = tbase | axoff[q >> rbits] | ((int64_t)(q & ((1 << rbits) - 1)) << VB);
      const int p = swz<VB>(q << VB);
      *reinterpret_cast<Chunk<T>*>(re + idx) = *reinterpret_cast<const Chunk<T>*>(sre + p);
      *reinterpret_cast<Chunk<T>*>(im + idx) = *reinterpret_cast<const Chunk<T>*>(sim + p);
    }
  } else {
    const int low_mask = (1 << g.t) - 1;
    for (int j = threadIdx.x; j < (1 << tb); j += THREADS) {
      const int64_t idx = tbase | axoff[j >> g.t] | (j & low_mask);
      const int p = swz<VB>(j);
      re[idx] = sre[p];
      im[idx] = sim[p];
    }
  }
}

// Run f(std::integral_constant<int, s>) for a runtime slot s < NE, so that
// register indices derived from s are compile-time constants.
template <int NE, typename F>
__device__ __forceinline__ void with_slot(int s, F&& f) {
  switch (s) {
    case 0: f(std::integral_constant<int, 0>{}); break;
    case 1: if constexpr (NE > 1) f(std::integral_constant<int, 1>{}); break;
    case 2: if constexpr (NE > 2) f(std::integral_constant<int, 2>{}); break;
    case 3: if constexpr (NE > 3) f(std::integral_constant<int, 3>{}); break;
    default: break;
  }
}

template <typename T>
__device__ __forceinline__ void cmul(T& xr, T& xi, T pr, T pi) {
  const T r = xr * pr - xi * pi;
  xi = xr * pi + xi * pr;
  xr = r;
}

// An op's record as a thread holds it, loaded from the block's shared copy
// with 16-byte loads: the int fields and the first 8 coefficients (a 2x2
// matrix, a diagonal, or an iQFT op's slot factors).  Fields are read only
// at compile-time offsets, so the record stays in registers.
template <typename T>
struct OpRec {
  int4 a, b;  // kind, q1, q2, s1 | s2, off_axes, off_low, has_phase
  T c[8];
};

template <typename T>
__device__ __forceinline__ void load_op(OpRec<T>& r, const int* oi, const T* of) {
  r.a = reinterpret_cast<const int4*>(oi)[0];
  r.b = reinterpret_cast<const int4*>(oi)[1];
#pragma unroll
  for (int v = 0; v < 8 * (int)sizeof(T) / 16; ++v) {
    const Chunk<T> q = reinterpret_cast<const Chunk<T>*>(of)[v];
    if constexpr (sizeof(T) == 4) {
      r.c[4 * v] = q.x; r.c[4 * v + 1] = q.y; r.c[4 * v + 2] = q.z; r.c[4 * v + 3] = q.w;
    } else {
      r.c[2 * v] = q.x; r.c[2 * v + 1] = q.y;
    }
  }
}

// Highest set bit of a positive compile-time value.
__host__ __device__ constexpr int top_bit(int x) { return x > 1 ? 1 + top_bit(x >> 1) : 0; }

// One op on a thread's 2^NE register amplitudes.  j0: tile-local index of
// amplitude 0 (slot bits zero); gidx0: its global index.
template <typename T, int NE>
__device__ __forceinline__ void apply_op(T (&xr)[1 << NE], T (&xi)[1 << NE], const OpRec<T>& r,
                                         const T* __restrict__ of, const T* __restrict__ ftab,
                                         const T* fbase, int j0, int64_t gidx0, const Geom& g) {
  constexpr int E = 1 << NE;
  const int kind = r.a.x;
  if (kind == OP_U1Q) {
    const T u00r = r.c[0], u01r = r.c[1], u10r = r.c[2], u11r = r.c[3];
    const T u00i = r.c[4], u01i = r.c[5], u10i = r.c[6], u11i = r.c[7];
    const bool real = u00i == 0 && u01i == 0 && u10i == 0 && u11i == 0;  // H, X, RY: half the work
    with_slot<NE>(r.a.w, [&](auto A) {
      constexpr int bit = 1 << decltype(A)::value;
      if (real) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & bit) continue;
          const T ar = xr[e], ai = xi[e], br = xr[e | bit], bi = xi[e | bit];
          xr[e] = u00r * ar + u01r * br;
          xi[e] = u00r * ai + u01r * bi;
          xr[e | bit] = u10r * ar + u11r * br;
          xi[e | bit] = u10r * ai + u11r * bi;
        }
        return;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e & bit) continue;
        const T ar = xr[e], ai = xi[e], br = xr[e | bit], bi = xi[e | bit];
        xr[e] = (u00r * ar - u00i * ai) + (u01r * br - u01i * bi);
        xi[e] = (u00r * ai + u00i * ar) + (u01r * bi + u01i * br);
        xr[e | bit] = (u10r * ar - u10i * ai) + (u11r * br - u11i * bi);
        xi[e | bit] = (u10r * ai + u10i * ar) + (u11r * bi + u11i * br);
      }
    });
  } else if (kind == OP_DIAG1) {
    const int q = r.a.y, s = r.a.w;
    const int gb = (int)((gidx0 >> q) & 1);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int b = gb | (s >= 0 ? (e >> s) & 1 : 0);
      cmul(xr[e], xi[e], b ? r.c[2] : r.c[0], b ? r.c[3] : r.c[1]);
    }
  } else if (kind == OP_DIAG2) {
    const int qh = r.a.y, ql = r.a.z, sh = r.a.w, sl = r.b.x;
    const int gh = (int)((gidx0 >> qh) & 1), gl = (int)((gidx0 >> ql) & 1);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = 2 * (gh | (sh >= 0 ? (e >> sh) & 1 : 0)) + (gl | (sl >= 0 ? (e >> sl) & 1 : 0));
      // A select chain, not r.c[d]: a runtime index would put r in local memory.
      const T pr = d == 0 ? r.c[0] : d == 1 ? r.c[1] : d == 2 ? r.c[2] : r.c[3];
      const T pi = d == 0 ? r.c[4] : d == 1 ? r.c[5] : d == 2 ? r.c[6] : r.c[7];
      cmul(xr[e], xi[e], pr, pi);
    }
  } else if (kind == OP_IQFT) {
    const int l = r.a.y, off_axes = r.b.y, off_low = r.b.z;
    const bool phase = r.b.w > 0;
    const T s = (T)0.70710678118654752440;
    // P: the phase of amplitude 0 (F_base * F_axes * F_low), times 1/sqrt(2).
    T pr = s, pi = 0;
    if (phase) {
      pr = fbase[0] * s;
      pi = fbase[1] * s;
      if (off_axes >= 0) {
        const int c = off_axes + (j0 >> g.t);
        cmul(pr, pi, __ldg(ftab + 2 * c), __ldg(ftab + 2 * c + 1));
      }
      if (off_low >= 0) {
        const int c = off_low + (j0 & ((1 << min(l, g.t)) - 1));
        cmul(pr, pi, __ldg(ftab + 2 * c), __ldg(ftab + 2 * c + 1));
      }
    }
    with_slot<NE>(r.a.w, [&](auto A) {
      constexpr int bit = 1 << decltype(A)::value;
      // Q[e], e with the target bit set: P times the factor w_b (r.c[2b],
      // r.c[2b + 1]) of each other slot bit b set in e, built up from the
      // product one bit smaller.
      T qr[E], qi[E];
      qr[bit] = pr;
      qi[bit] = pi;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (!(e & bit) || e == bit) continue;
        const int b = top_bit(e & ~bit);
        qr[e] = qr[e ^ (1 << b)];
        qi[e] = qi[e ^ (1 << b)];
        if (phase) cmul(qr[e], qi[e], r.c[2 * b], r.c[2 * b + 1]);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e & bit) continue;
        const T ar = xr[e], ai = xi[e], br = xr[e | bit], bi = xi[e | bit];
        xr[e] = s * (ar + br);
        xi[e] = s * (ai + bi);
        T hr = ar - br, hi = ai - bi;
        cmul(hr, hi, qr[e | bit], qi[e | bit]);
        xr[e | bit] = hr;
        xi[e | bit] = hi;
      }
    });
  } else if (kind == OP_U2Q) {
    const int sh = r.a.w, sl = r.b.x;  // sh > sl
    with_slot<NE>(sh, [&](auto H) {
      with_slot<NE>(sl, [&](auto L) {
        constexpr int hb = 1 << decltype(H)::value, lb = 1 << decltype(L)::value;
        if constexpr (hb > lb) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if (e & (hb | lb)) continue;
            const int idx[4] = {e, e | lb, e | hb, e | hb | lb};
            T yr[4], yi[4];
#pragma unroll
            for (int row = 0; row < 4; ++row) {
              yr[row] = 0;
              yi[row] = 0;
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const T mr = __ldg(of + 4 * row + c), mi = __ldg(of + 16 + 4 * row + c);
                yr[row] += mr * xr[idx[c]] - mi * xi[idx[c]];
                yi[row] += mr * xi[idx[c]] + mi * xr[idx[c]];
              }
            }
#pragma unroll
            for (int row = 0; row < 4; ++row) {
              xr[idx[row]] = yr[row];
              xi[idx[row]] = yi[row];
            }
          }
        }
      });
    });
  }
}

// Load 2^VB consecutive amplitudes of a plane from shared memory.
template <typename T, int VB>
__device__ __forceinline__ void smem_get(const T* src, T* dst) {
  if constexpr (VB > 0 && (sizeof(T) << VB) == 16) {
    const Chunk<T> v = *reinterpret_cast<const Chunk<T>*>(src);
    if constexpr (sizeof(T) == 4) {
      dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
    } else {
      dst[0] = v.x; dst[1] = v.y;
    }
  } else {
#pragma unroll
    for (int v = 0; v < (1 << VB); ++v) dst[v] = src[v];
  }
}

template <typename T, int VB>
__device__ __forceinline__ void smem_put(T* dst, const T* src) {
  if constexpr (VB > 0 && (sizeof(T) << VB) == 16) {
    Chunk<T> v;
    if constexpr (sizeof(T) == 4) {
      v.x = src[0]; v.y = src[1]; v.z = src[2]; v.w = src[3];
    } else {
      v.x = src[0]; v.y = src[1];
    }
    *reinterpret_cast<Chunk<T>*>(dst) = v;
  } else {
#pragma unroll
    for (int v = 0; v < (1 << VB); ++v) dst[v] = src[v];
  }
}

// One register group over the tile in (sre, sim): each thread takes
// subcubes of 2^NE amplitudes, applies the group's ops, and puts them back.
// s_opi, s_opc: the block's shared copy of the op records; ops_f: the full
// coefficient records (u2q reads its 4x4 matrix there).
template <typename T, int VB, int NE>
__device__ __forceinline__ void run_group(T* sre, T* sim, const int* __restrict__ grp, const int* s_opi,
                                          const T* s_opc, const T* __restrict__ ops_f, const T* __restrict__ ftab,
                                          const T* fbase, int64_t tbase, const int64_t* axoff, const Geom& g) {
  constexpr int NX = NE - VB;  // extra slots beyond the vector bits
  constexpr int NC = 1 << NX;
  const int ob = __ldg(grp), oe = __ldg(grp + 1);
  int pos[NX > 0 ? NX : 1];
  int xoff[NC];
#pragma unroll
  for (int x = 0; x < NX; ++x) pos[x] = __ldg(grp + 2 + x);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    int o = 0;
#pragma unroll
    for (int x = 0; x < NX; ++x) o |= ((c >> x) & 1) << pos[x];
    xoff[c] = o;
  }
  const int nsub = 1 << (g.t + g.k - NE);
  const int low_mask = (1 << g.t) - 1;
  for (int sub = threadIdx.x; sub < nsub; sub += THREADS) {
    int j0 = sub << VB;
#pragma unroll
    for (int x = 0; x < NX; ++x) j0 = (int)insert_zero(j0, pos[x]);
    T xr[1 << NE], xi[1 << NE];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int p = swz<VB>(j0 | xoff[c]);
      smem_get<T, VB>(sre + p, xr + (c << VB));
      smem_get<T, VB>(sim + p, xi + (c << VB));
    }
    const int64_t gidx0 = tbase | axoff[j0 >> g.t] | (j0 & low_mask);
    for (int o = ob; o < oe; ++o) {
      OpRec<T> rec;
      load_op(rec, s_opi + OPI_STRIDE * o, s_opc + 8 * o);
      apply_op<T, NE>(xr, xi, rec, ops_f + OPF_STRIDE * o, ftab, fbase + 2 * o, j0, gidx0, g);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int p = swz<VB>(j0 | xoff[c]);
      smem_put<T, VB>(sre + p, xr + (c << VB));
      smem_put<T, VB>(sim + p, xi + (c << VB));
    }
  }
}

// A camodc op (record rec) on the tile in (sre, sim): where its control bit
// is 1, every 2^M-element work block j & ~w is gathered through the inverse
// permutation, out[j] = in[(j & ~w) | ginv[j & w]], one plane at a time:
// each thread reads its elements' sources into registers, the block syncs,
// then each thread writes them.  The control is an L-register bit (>= M),
// constant over a work block, so an element whose control is 0 is neither
// read nor written, and neither is its block.  The tile holds at most
// 2^MAX_PERM_TILE_BITS amplitudes, MAXE a thread.
template <typename T, int VB>
__device__ __forceinline__ void run_camodc(T* sre, T* sim, const int* rec, const short* __restrict__ ptab, int M,
                                           int64_t tbase, const Geom& g) {
  constexpr int MAXE = (1 << MAX_PERM_TILE_BITS) / THREADS;
  const int c = rec[1], cpos = rec[3];
  if (cpos < 0 && !((tbase >> c) & 1)) return;  // control 0 on the whole tile (block-uniform)
  const short* __restrict__ ginv = ptab + rec[5];
  const int tile = 1 << (g.t + g.k);
  const int w = (1 << M) - 1;
  for (int plane = 0; plane < 2; ++plane) {
    T* s = plane ? sim : sre;
    T v[MAXE];
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      const int j = threadIdx.x + e * THREADS;
      if (j < tile && (cpos < 0 || ((j >> cpos) & 1))) v[e] = s[swz<VB>((j & ~w) | __ldg(ginv + (j & w)))];
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      const int j = threadIdx.x + e * THREADS;
      if (j < tile && (cpos < 0 || ((j >> cpos) & 1))) s[swz<VB>(j)] = v[e];
    }
    __syncthreads();
  }
}

// False when every op of the segment is a camodc whose control is a tile-base
// bit that is 0 in this tile: then no op changes the tile.
__device__ __forceinline__ bool tile_active(const int* s_opi, int nops, int64_t tbase) {
  for (int o = 0; o < nops; ++o) {
    const int* r = s_opi + OPI_STRIDE * o;
    if (r[0] != OP_CAMODC || r[3] >= 0 || ((tbase >> r[1]) & 1)) return true;
  }
  return false;
}

// ---------------------------------------------------------------------------
// Matrix groups: the TPU kernel's lanemat / rowmat / xtable branches
// (pallas_fused.py:911-966) on the tensor cores, with mma.sync.  A matrix
// segment's tile is 2^13 amplitudes, viewed a plane at a time as X, 64 rows
// of 128 lanes (element j: row j >> 7, lane j & 127, at swz<VB>(j)); the lane
// bits 0-6 are always low tile bits, and a segment with a rowmat or xtable
// has t = 13, so its rows are the index bits 7-12 (ops/fused.py checks both).
//
//   lanemat  Y = X W, K = 128: W[k][n] = tab[k * 128 + n] (the table holds
//            W^T of the JAX package's operator, so x @ table).
//   rowmat   Y = V X, K = 64: V[m][k] = tab[k * 64 + m].
//   xtable   Y = X * (cos + i sin), elementwise, tab[j] and tab[8192 + j].
//
// A real table (the H chains) takes two real products a plane pair, a
// complex one four: Yr = Xr Wr - Xi Wi, Yi = Xr Wi + Xi Wr.  Warp w computes
// output lanes [16 w, 16 w + 16) of all 64 rows, 4 x 2 fragments of 16 x 8,
// so the 8 warps read each lanemat table element once between them (each
// reads all of V for a rowmat: 64 x 64, from L1); the tile is overwritten
// only after every warp has read it (one sync).  Tables are read through
// __ldg: every block reads the same few tables, which stay in L1 and L2, and
// the tile leaves no shared memory for them.
//
// float32 planes: 3xTF32.  Each operand x = hi + lo, both rounded to TF32
// (cvt.rna), and the product is hi*hi + hi*lo + lo*hi with float32
// accumulation (mma.m16n8k8.tf32): about float32 accuracy, as the TPU
// kernel's Precision.HIGHEST; one TF32 product (2^-11) would miss 3e-5.
// bf16 planes: as the TPU kernel's MXU dots at bf16 storage, the f32 work
// tile's activations rounded to bf16 and two products against the table's
// bf16 hi and lo parts (mma.m16n8k16.bf16, float32 accumulation); the
// tables arrive so split ((2 hi/lo, 2 re/im, K, K) bf16), xtables as float32.
//
// Fragment layouts (PTX ISA, mma.sync.m16n8k8 .tf32 and .m16n8k16 .bf16),
// with lane = 4 g + c: A (16 x K) register r holds row g + 8 (r & 1); B
// (K x 8) column g; C (16 x 8) register r row g + 8 (r >> 1), column
// 2 c + (r & 1).  tf32: A columns c + 4 (r >> 1), B rows c + 4 r.  bf16 (two
// elements a register, the lower index in the low half): A columns
// 2 c + 8 (r >> 1) + {0, 1}, B rows 2 c + 8 r + {0, 1}.

constexpr int MAT_TILE = 8192;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand fragment of N registers in two parts: TF32 hi and lo of
// float32 values, or a bf16 table's hi and lo.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// -f: the sign bit of every element flipped (SIGN: 0x80000000 for a TF32
// register, 0x80008000 for a pair of bf16), exact.
template <uint32_t SIGN, int N>
__device__ __forceinline__ Frag<N> negated(const Frag<N>& f) {
  Frag<N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r.hi[i] = f.hi[i] ^ SIGN;
    r.lo[i] = f.lo[i] ^ SIGN;
  }
  return r;
}

// 3xTF32: d += a b with lo * lo dropped (the small terms first).
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// bf16: d += a (b.hi + b.lo), a the activations; or (a.hi + a.lo) b, a the table.
__device__ __forceinline__ void mma2(float (&d)[4], const uint32_t (&a)[4], const Frag<2>& b) {
  mma_bf16(d, a, b.lo);
  mma_bf16(d, a, b.hi);
}
__device__ __forceinline__ void mma2(float (&d)[4], const Frag<4>& a, const uint32_t (&b)[2]) {
  mma_bf16(d, a.lo, b);
  mma_bf16(d, a.hi, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Table elements (k, i) and (k + 1, i) of a bf16 table part with K columns.
template <int K>
__device__ __forceinline__ uint32_t table_pair(const uint16_t* __restrict__ t, int k, int i) {
  return (uint32_t)__ldg(t + k * K + i) | ((uint32_t)__ldg(t + (k + 1) * K + i) << 16);
}

template <int VB>
__device__ __forceinline__ float tile_at(const float* p, int row, int col) {
  return p[swz<VB>((row << 7) | col)];
}

// Write a warp's output fragments (rows 16 mt + ..., lanes n0 + 8 nt + ...).
template <int VB>
__device__ __forceinline__ void store_frags(float* sre, float* sim, const float (&yr)[4][2][4],
                                            const float (&yi)[4][2][4], int g, int c, int n0) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = swz<VB>(((16 * mt + g + 8 * (r >> 1)) << 7) | (n0 + 8 * nt + 2 * c + (r & 1)));
        sre[p] = yr[mt][nt][r];
        sim[p] = yi[mt][nt][r];
      }
    }
  }
}

// One lanemat (ROW false) or rowmat (ROW true) on float32 planes, 3xTF32.
template <int VB, bool ROW>
__device__ __forceinline__ void matmul_tf32(float* sre, float* sim, const float* __restrict__ t0, bool real) {
  constexpr int K = ROW ? 64 : 128;
  const float* __restrict__ t1 = t0 + K * K;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3, n0 = 16 * (threadIdx.x >> 5);
  float yr[4][2][4] = {}, yi[4][2][4] = {};
  for (int k0 = 0; k0 < K; k0 += 8) {
    if constexpr (!ROW) {
      Frag<2> wr[2], wi[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int at = (k0 + c + 4 * r) * 128 + n0 + 8 * nt + g;
          split_tf32(__ldg(t0 + at), wr[nt].hi[r], wr[nt].lo[r]);
          if (!real) split_tf32(__ldg(t1 + at), wi[nt].hi[r], wi[nt].lo[r]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        Frag<4> ar, ai;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 16 * mt + g + 8 * (r & 1), col = k0 + c + 4 * (r >> 1);
          split_tf32(tile_at<VB>(sre, row, col), ar.hi[r], ar.lo[r]);
          split_tf32(tile_at<VB>(sim, row, col), ai.hi[r], ai.lo[r]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma3(yr[mt][nt], ar, wr[nt]);
          mma3(yi[mt][nt], ai, wr[nt]);
          if (!real) {
            mma3(yr[mt][nt], ai, negated<0x80000000u>(wi[nt]));
            mma3(yi[mt][nt], ar, wi[nt]);
          }
        }
      }
    } else {
      Frag<2> xr[2], xi[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int k = k0 + c + 4 * r, n = n0 + 8 * nt + g;
          split_tf32(tile_at<VB>(sre, k, n), xr[nt].hi[r], xr[nt].lo[r]);
          split_tf32(tile_at<VB>(sim, k, n), xi[nt].hi[r], xi[nt].lo[r]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        Frag<4> vr, vi;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int at = (k0 + c + 4 * (r >> 1)) * 64 + 16 * mt + g + 8 * (r & 1);
          split_tf32(__ldg(t0 + at), vr.hi[r], vr.lo[r]);
          if (!real) split_tf32(__ldg(t1 + at), vi.hi[r], vi.lo[r]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma3(yr[mt][nt], vr, xr[nt]);
          mma3(yi[mt][nt], vr, xi[nt]);
          if (!real) {
            mma3(yr[mt][nt], negated<0x80000000u>(vi), xi[nt]);
            mma3(yi[mt][nt], vi, xr[nt]);
          }
        }
      }
    }
  }
  __syncthreads();  // every warp has read the tile
  store_frags<VB>(sre, sim, yr, yi, g, c, n0);
}

// One lanemat or rowmat on the f32 work tile of bf16 planes: activations
// rounded to bf16, the table as bf16 hi + lo (parts at t, t + KK (im),
// t + 2 KK (lo re), t + 3 KK (lo im)).
template <int VB, bool ROW>
__device__ __forceinline__ void matmul_bf16(float* sre, float* sim, const uint16_t* __restrict__ t, bool real) {
  constexpr int K = ROW ? 64 : 128, KK = K * K;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3, n0 = 16 * (threadIdx.x >> 5);
  float yr[4][2][4] = {}, yi[4][2][4] = {};
  for (int k0 = 0; k0 < K; k0 += 16) {
    if constexpr (!ROW) {
      Frag<2> wr[2], wi[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int k = k0 + 2 * c + 8 * r, n = n0 + 8 * nt + g;
          wr[nt].hi[r] = table_pair<K>(t, k, n);
          wr[nt].lo[r] = table_pair<K>(t + 2 * KK, k, n);
          if (!real) {
            wi[nt].hi[r] = table_pair<K>(t + KK, k, n);
            wi[nt].lo[r] = table_pair<K>(t + 3 * KK, k, n);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t ar[4], ai[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 16 * mt + g + 8 * (r & 1), col = k0 + 2 * c + 8 * (r >> 1);
          ar[r] = pack_bf16(tile_at<VB>(sre, row, col), tile_at<VB>(sre, row, col + 1));
          ai[r] = pack_bf16(tile_at<VB>(sim, row, col), tile_at<VB>(sim, row, col + 1));
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma2(yr[mt][nt], ar, wr[nt]);
          mma2(yi[mt][nt], ai, wr[nt]);
          if (!real) {
            mma2(yr[mt][nt], ai, negated<0x80008000u>(wi[nt]));
            mma2(yi[mt][nt], ar, wi[nt]);
          }
        }
      }
    } else {
      uint32_t xr[2][2], xi[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int k = k0 + 2 * c + 8 * r, n = n0 + 8 * nt + g;
          xr[nt][r] = pack_bf16(tile_at<VB>(sre, k, n), tile_at<VB>(sre, k + 1, n));
          xi[nt][r] = pack_bf16(tile_at<VB>(sim, k, n), tile_at<VB>(sim, k + 1, n));
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        Frag<4> vr, vi;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int m = 16 * mt + g + 8 * (r & 1), k = k0 + 2 * c + 8 * (r >> 1);
          vr.hi[r] = table_pair<K>(t, k, m);
          vr.lo[r] = table_pair<K>(t + 2 * KK, k, m);
          if (!real) {
            vi.hi[r] = table_pair<K>(t + KK, k, m);
            vi.lo[r] = table_pair<K>(t + 3 * KK, k, m);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma2(yr[mt][nt], vr, xr[nt]);
          mma2(yi[mt][nt], vr, xi[nt]);
          if (!real) {
            mma2(yr[mt][nt], negated<0x80008000u>(vi), xi[nt]);
            mma2(yi[mt][nt], vi, xr[nt]);
          }
        }
      }
    }
  }
  __syncthreads();  // every warp has read the tile
  store_frags<VB>(sre, sim, yr, yi, g, c, n0);
}

// One matrix op (record rec: kind, ..., its table's byte offset in mtab at
// [5], 1 for a real table at [6]) on the f32 tile (sre, sim).  S: the
// storage type, which fixes the products' precision.
template <typename S, int VB>
__device__ __forceinline__ void run_matrix(float* sre, float* sim, const int* rec,
                                           const unsigned char* __restrict__ mtab) {
  const unsigned char* tab = mtab + rec[5];
  const bool real = rec[6] > 0;
  if (rec[0] == OP_XTABLE) {
    const float* __restrict__ x = reinterpret_cast<const float*>(tab);
    for (int j = threadIdx.x; j < MAT_TILE; j += THREADS) {
      const int p = swz<VB>(j);
      float xr = sre[p], xi = sim[p];
      cmul(xr, xi, __ldg(x + j), __ldg(x + MAT_TILE + j));
      sre[p] = xr;
      sim[p] = xi;
    }
  } else if constexpr (sizeof(S) == 2) {
    const uint16_t* t = reinterpret_cast<const uint16_t*>(tab);
    if (rec[0] == OP_ROWMAT) {
      matmul_bf16<VB, true>(sre, sim, t, real);
    } else {
      matmul_bf16<VB, false>(sre, sim, t, real);
    }
  } else {
    const float* t = reinterpret_cast<const float*>(tab);
    if (rec[0] == OP_ROWMAT) {
      matmul_tf32<VB, true>(sre, sim, t, real);
    } else {
      matmul_tf32<VB, false>(sre, sim, t, real);
    }
  }
}

// Bytes of the ring (staging slots) of a tile of `tile` elements of S.
template <typename S>
__host__ __device__ __forceinline__ size_t ring_bytes(int tile, bool ring) {
  return ((ring ? 2 : 1) * 2 * sizeof(S) * (size_t)tile + 15) & ~(size_t)15;
}

// Two blocks an SM: 128 registers a thread hold a group's 2^NE amplitudes
// without spills (a cap of 80, for three blocks, spilled and ran slower).
// PERM: the instance for segments with camodc ops; run_camodc's registers
// would otherwise cost every segment spills.  MAT: the instance for segments
// with matrix groups (fused_matmul.cu), one block an SM: its 2^13-amplitude
// tile fills the shared memory, and its fragments take more than 128
// registers.  S: the storage type, T: the compute type; S = bf16 with T =
// float stages each tile and widens it into a work tile (see the header),
// S = T computes in the ring slot itself.
template <typename S, typename T, int VB, int NE, bool PERM, bool MAT>
__global__ void __launch_bounds__(THREADS, MAT ? 1 : 2)
fused_segment_kernel(S* __restrict__ re, S* __restrict__ im, const int* __restrict__ ops_i,
                     const T* __restrict__ ops_f, const int* __restrict__ groups, int ngroups,
                     const T* __restrict__ ftab, const short* __restrict__ ptab,
                     const unsigned char* __restrict__ mtab, int nops, Geom g, int M, int64_t tiles, bool vec,
                     bool ring) {
  constexpr bool WIDEN = !std::is_same<S, T>::value;
  constexpr int SB = WIDEN ? 3 : VB;  // the staging slot's swizzle: 16-byte chunks of S
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t axoff[1 << MAX_AXES];  // axoff[c]: the axis bits of row c, any tile
  const int tile = 1 << (g.t + g.k);
  S* bufs = reinterpret_cast<S*>(smem);     // ring slot b: re at bufs + 2*b*tile, im after it
  // The tile the ops run on: the ring slot itself, or (WIDEN) the f32 work tile after the ring.
  T* work = reinterpret_cast<T*>(smem + ring_bytes<S>(tile, ring));
  T* fbase = work + (WIDEN ? 2 * tile : 0);  // F_base of each op for the current tile (re, im)
  T* s_opc = fbase + 2 * ((nops + 1) & ~1); // each op's first 8 coefficients (16-byte aligned)
  int* s_opi = reinterpret_cast<int*>(s_opc + 8 * nops);  // each op's int record
  for (int i = threadIdx.x; i < 8 * nops; i += THREADS) {
    s_opc[i] = ops_f[OPF_STRIDE * (i / 8) + i % 8];
    s_opi[i] = ops_i[i];
  }
  for (int c = threadIdx.x; c < (1 << g.k); c += THREADS) {
    int64_t off = 0;
#pragma unroll
    for (int a = 0; a < MAX_AXES; ++a) {
      if (a < g.k) off |= (int64_t)((c >> a) & 1) << g.axes[a];
    }
    axoff[c] = off;
  }
  __syncthreads();

  // The ring: with `ring`, tile i of this block lands in slot i % 2 while
  // tile i - 1 is computed; without, each tile lands in slot 0 once the one
  // before it is stored.  WIDEN has one slot and no ring: the next tile lands
  // in it once this one is widened into the work tile, while this one is
  // computed.  A tile no op changes is neither loaded nor stored.
  const bool early = ring || WIDEN;  // the next tile's copy starts before this tile's ops
  const int64_t step = gridDim.x;
  int64_t tau = blockIdx.x;
  bool act = tau < tiles && (!PERM || tile_active(s_opi, nops, tile_base(tau, g)));
  if (act) load_tile<S, SB>(bufs, bufs + tile, re, im, tile_base(tau, g), axoff, g, vec);
  cp_async_commit();
  int b = 0;
  for (; tau < tiles; tau += step) {
    cp_async_wait_group<0>();  // this tile's copies are done
    const int64_t tbase = tile_base(tau, g);
    for (int o = threadIdx.x; act && o < nops; o += THREADS) {
      const int* oi = ops_i + OPI_STRIDE * o;
      if (__ldg(oi) == OP_IQFT && __ldg(oi + 7) > 0) {
        const int l = __ldg(oi + 1);
        const int64_t mask = (int64_t(1) << l) - (int64_t(1) << M);
        double sn, cs;  // exact: (tbase & mask) < 2^31 and a power-of-two divisor
        sincospi((double)(tbase & mask) / (double)(int64_t(1) << l), &sn, &cs);
        fbase[2 * o] = (T)cs;
        fbase[2 * o + 1] = (T)sn;
      }
    }
    __syncthreads();  // the tile and fbase are ready; the slot stored last iteration is free
    T* sre;
    if constexpr (WIDEN) {
      if (act) {
        widen_tile<SB, VB>(bufs, work, tile);
        widen_tile<SB, VB>(bufs + tile, work + tile, tile);
      }
      __syncthreads();  // the work tile is ready; the staging slot is free
      sre = work;
    } else {
      sre = bufs + 2 * b * tile;
    }
    T* sim = sre + tile;
    const int64_t nxt = tau + step;
    const bool nact = nxt < tiles && (!PERM || tile_active(s_opi, nops, tile_base(nxt, g)));
    const int nb = ring ? b ^ 1 : b;
    if (early) {
      if (nact) load_tile<S, SB>(bufs + 2 * nb * tile, bufs + (2 * nb + 1) * tile, re, im, tile_base(nxt, g), axoff, g, vec);
      cp_async_commit();
    }
    if (act) {
      for (int gi = 0; gi < ngroups; ++gi) {
        const int* grp = groups + GRP_STRIDE * gi;
        if constexpr (PERM) {
          const int* first = s_opi + OPI_STRIDE * __ldg(grp);
          if (first[0] == OP_CAMODC) {  // a group of its own; it ends in a sync
            run_camodc<T, VB>(sre, sim, first, ptab, M, tbase, g);
            continue;
          }
        }
        if constexpr (MAT) {
          const int* first = s_opi + OPI_STRIDE * __ldg(grp);
          if (first[0] >= OP_LANEMAT) {  // a group of its own
            run_matrix<S, VB>(sre, sim, first, mtab);
            __syncthreads();
            continue;
          }
        }
        run_group<T, VB, NE>(sre, sim, grp, s_opi, s_opc, ops_f, ftab, fbase, tbase, axoff, g);
        __syncthreads();
      }
      if constexpr (WIDEN) {
        store_tile_bf16<VB>(sre, sim, re, im, tbase, axoff, g, vec);
      } else {
        store_tile<T, VB>(sre, sim, re, im, tbase, axoff, g, vec);
      }
    }
    __syncthreads();  // before fbase and this slot are reused
    if (!early) {
      if (nact) load_tile<S, SB>(bufs, bufs + tile, re, im, tile_base(nxt, g), axoff, g, vec);
      cp_async_commit();
    }
    b = nb;
    act = nact;
  }
}

template <typename S, typename T, int VB, int NE, bool PERM, bool MAT>
int launch(S* re, S* im, const void* ops_i, const void* ops_f, const void* groups, int ngroups,
           const void* ftab, const void* ptab, const void* mtab, int nops, const Geom& g, int M, int64_t tiles,
           void* stream) {
  constexpr bool WIDEN = !std::is_same<S, T>::value;
  const bool aligned = (reinterpret_cast<uintptr_t>(re) % 16) == 0 && (reinterpret_cast<uintptr_t>(im) % 16) == 0;
  // 16-byte copies: chunks of 2^VB elements, or (WIDEN) staged chunks of 8
  // bf16 and stores of 4 (VB = 2 only).
  const bool vec = aligned && (WIDEN ? VB == 2 && g.t >= 3 : VB > 0 && (sizeof(T) << VB) == 16 && g.t >= VB);
  const int tile = 1 << (g.t + g.k);
  const size_t slot = 2 * sizeof(S) * (size_t)tile;  // one tile, both planes
  const bool ring = !WIDEN && 2 * slot <= MAX_RING_BYTES;
  // The ring, the work tile (WIDEN), then per op: F_base (2 T), the first 8
  // coefficients, the int record.
  const size_t smem = ring_bytes<S>(tile, ring) + (WIDEN ? 2 * sizeof(T) * (size_t)tile : 0) +
                      10 * sizeof(T) * (size_t)(nops + 1) + OPI_STRIDE * sizeof(int) * (size_t)nops;
  auto kern = fused_segment_kernel<S, T, VB, NE, PERM, MAT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem)) != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  int64_t grid = tiles < (int64_t)sms * per_sm ? tiles : (int64_t)sms * per_sm;
  // A block walks tiles tau = blockIdx.x + i * grid.  With an even grid every
  // tile a block sees has the same low tile-base bits, so when the skipped
  // tiles are those of low controls whole blocks would idle: keep it odd.
  if (PERM && grid > 1 && grid % 2 == 0) --grid;
  kern<<<(unsigned int)grid, THREADS, smem, (cudaStream_t)stream>>>(
      re, im, (const int*)ops_i, (const T*)ops_f, (const int*)groups, ngroups, (const T*)ftab, (const short*)ptab,
      (const unsigned char*)mtab, nops, g, M, tiles, vec, ring);
  return (int)cudaGetLastError();
}

}  // namespace
