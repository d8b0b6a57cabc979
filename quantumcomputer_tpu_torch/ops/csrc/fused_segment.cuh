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
//         f -> A*f mod C (the TPU kernel's camodc_k branch,
//         pallas_fused.py:967-997), in segments that mix it with other ops:
//         each work block gathered through the inverse permutation in
//         shared memory (run_camodc, the PERM instances; a segment of camodc
//         ops alone runs in camodc_permute.cu).  Its tile holds whole
//         2^M-element work blocks (t >= M, at most 2^13 amplitudes; one ring
//         slot when two do not fit MAX_RING_BYTES).
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
// pass, at the store, as the TPU kernel does.  At half the bytes a pass the
// chain of a tile, not the bytes, bounds it, so its chain is designed for
// bf16 bytes (the "direct" form, DIRECT below):
//   * no widening or store pass: a tile arrives by 16-byte cp.async into a
//     bf16 staging slot; the first register group reads its amplitudes
//     straight from that slot and widens them in registers, the last one
//     rounds them to bf16 in registers and stores them to device memory
//     itself (8 bytes a chunk, the warp's lanes on the tile's contiguous
//     low bits: ops/fused.py pads groups with high bits).  Only groups in
//     between go through an f32 work tile.
//   * fewer groups: 128 threads a block, each holding 2^5 amplitudes (three
//     extra slots a group, so five butterfly targets take two groups, not
//     three), three blocks an SM; a group boundary (a work-tile round trip
//     and a block barrier) costs about as much as the tile's copies.
//   * a ring of WIDEN_STAGES staging slots: the next tile's copy is in
//     flight across this tile's whole chain.
// The instances with camodc ops (PERM) or matrix groups (MAT), whose ops
// read the whole tile, keep 2^4 amplitudes a thread and one staging slot,
// widened once into the work tile before the first group and stored from
// it after the last.
//
// The op list arrives as device arrays: ops_i (int32 records of OPI_STRIDE:
// kind, q1, q2, slot of q1, slot of q2, then for an iQFT op the ftab offsets
// of F_axes and F_low and 1 when it has a phase; for a camodc op kind,
// control, M, the control's tile-local position or -1 for a tile-base bit,
// -1, its offset in ptab; for a matrix op its table's chunks in mtab, their
// byte offset, 1 for a real table and 1 when a rowmat applies the xtable
// after it (on both records), at [4] to [7]), ops_f (coefficients in the plane dtype,
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

#include "mbarrier.cuh"

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
// The direct bf16 form: 128 threads a block, each holding 2^5 amplitudes of a
// 2^12-amplitude tile (three blocks an SM).
constexpr int DIRECT_THREADS = 128;
// The instances that take the direct form: bf16 storage (S) computed in f32
// (T), in a segment with no camodc op (PERM) and no matrix group (MAT).
template <typename S, typename T, bool PERM, bool MAT>
constexpr bool is_direct = !std::is_same<S, T>::value && !PERM && !MAT;
constexpr int MAX_PERM_TILE_BITS = 13;  // a camodc segment's tile (M <= 13) and a matrix segment's
// The ring holds two tiles (one computed, one arriving) when they fit these
// bytes, else one; only camodc segments' larger tiles take one.
constexpr size_t MAX_RING_BYTES = size_t(128) << 10;
// bf16 staging slots of the direct form: tile i + 1 is in flight while tile
// i is computed (2 x 16 KB beside the 32 KB work tile at 2^12 amplitudes;
// three slots measured within 1%, at 2^4 amplitudes a thread).
constexpr int WIDEN_STAGES = 2;

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
template <typename T, int VB, int NT = THREADS>
__device__ __forceinline__ void load_tile(T* sre, T* sim, const T* re, const T* im, int64_t tbase,
                                          const int64_t* axoff, const Geom& g, bool vec) {
  const int tb = g.t + g.k;
  if (vec) {
    const int rbits = g.t - VB;  // chunks per row: 2^rbits
    for (int q = threadIdx.x; q < (1 << (tb - VB)); q += NT) {
      const int64_t idx = tbase | axoff[q >> rbits] | ((int64_t)(q & ((1 << rbits) - 1)) << VB);
      const int p = swz<VB>(q << VB);
      cp_async16(sre + p, re + idx);
      cp_async16(sim + p, im + idx);
    }
  } else {
    const int low_mask = (1 << g.t) - 1;
    for (int j = threadIdx.x; j < (1 << tb); j += NT) {
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
    case 4: if constexpr (NE > 4) f(std::integral_constant<int, 4>{}); break;
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
// with 16-byte loads: the int fields and the first NC coefficients (a 2x2
// matrix, a diagonal, or an iQFT op's slot factors, two a slot: 12 for 2^5
// amplitudes a thread, else 8).  Fields are read only at compile-time
// offsets, so the record stays in registers.
template <int NE>
__host__ __device__ constexpr int op_coefs() { return NE > 4 ? 12 : 8; }

template <typename T, int NC = 8>
struct OpRec {
  int4 a, b;  // kind, q1, q2, s1 | s2, off_axes, off_low, has_phase
  T c[NC];
};

template <typename T, int NC>
__device__ __forceinline__ void load_op(OpRec<T, NC>& r, const int* oi, const T* of) {
  r.a = reinterpret_cast<const int4*>(oi)[0];
  r.b = reinterpret_cast<const int4*>(oi)[1];
#pragma unroll
  for (int v = 0; v < NC * (int)sizeof(T) / 16; ++v) {
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
__device__ __forceinline__ void apply_op(T (&xr)[1 << NE], T (&xi)[1 << NE], const OpRec<T, op_coefs<NE>()>& r,
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

// The direct bf16 form's reads and writes of a register chunk: from the bf16
// staging slot (element j at swz<3>(j)), widened in registers, and to device
// memory, rounded once to the nearest bf16 (ties to even): 8 bytes a chunk
// with `vec`, else element by element.
template <typename T, int VB>
__device__ __forceinline__ void stage_get(const __nv_bfloat16* src, int j, T* dst) {
  if constexpr (VB == 2) {  // 4 consecutive elements, contiguous in an 8-element chunk
    const uint2 v = *reinterpret_cast<const uint2*>(src + swz<3>(j));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    dst[0] = a.x; dst[1] = a.y; dst[2] = b.x; dst[3] = b.y;
  } else {
#pragma unroll
    for (int v = 0; v < (1 << VB); ++v) dst[v] = __bfloat162float(src[swz<3>(j + v)]);
  }
}

template <typename T, int VB>
__device__ __forceinline__ void global_put(__nv_bfloat16* dst, int64_t idx, const T* src, bool vec) {
  if (VB == 2 && vec) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(src[0], src[1]), b = __floats2bfloat162_rn(src[2], src[3]);
    uint2 v;
    v.x = *reinterpret_cast<const unsigned*>(&a);
    v.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(dst + idx) = v;
  } else {
#pragma unroll
    for (int v = 0; v < (1 << VB); ++v) dst[idx + v] = __float2bfloat16_rn(src[v]);
  }
}

// One register group over the tile: each of NT threads takes subcubes of
// 2^NE amplitudes, applies the group's ops, and puts them back.  They come
// from the work tile (wre, wim; element j at swz<VB>(j)), or (IN_STAGE, the
// direct bf16 form's first group) from the bf16 staging slot (sst, ist),
// and go back to the work tile, or (OUT_GLOBAL, its last group) to device
// memory (re, im) in place.  A thread reads and writes only its own
// amplitudes, so a group's reads and writes need no barrier between them.
// s_opi, s_opc: the block's shared copy of the op records; ops_f: the full
// coefficient records (u2q reads its 4x4 matrix there).
template <typename T, int VB, int NE, bool IN_STAGE = false, bool OUT_GLOBAL = false, int NT = THREADS>
__device__ __forceinline__ void run_group(T* wre, T* wim, const int* __restrict__ grp, const int* s_opi,
                                          const T* s_opc, const T* __restrict__ ops_f, const T* __restrict__ ftab,
                                          const T* fbase, int64_t tbase, const int64_t* axoff, const Geom& g,
                                          const __nv_bfloat16* sst = nullptr, const __nv_bfloat16* ist = nullptr,
                                          __nv_bfloat16* re = nullptr, __nv_bfloat16* im = nullptr, bool vec = false) {
  constexpr int NX = NE - VB;
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
  for (int sub = threadIdx.x; sub < nsub; sub += NT) {
    int j0 = sub << VB;
#pragma unroll
    for (int x = 0; x < NX; ++x) j0 = (int)insert_zero(j0, pos[x]);
    T xr[1 << NE], xi[1 << NE];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = j0 | xoff[c];
      if constexpr (IN_STAGE) {
        stage_get<T, VB>(sst, j, xr + (c << VB));
        stage_get<T, VB>(ist, j, xi + (c << VB));
      } else {
        smem_get<T, VB>(wre + swz<VB>(j), xr + (c << VB));
        smem_get<T, VB>(wim + swz<VB>(j), xi + (c << VB));
      }
    }
    const int64_t gidx0 = tbase | axoff[j0 >> g.t] | (j0 & low_mask);
    for (int o = ob; o < oe; ++o) {
      OpRec<T, op_coefs<NE>()> rec;
      load_op(rec, s_opi + OPI_STRIDE * o, s_opc + op_coefs<NE>() * o);
      apply_op<T, NE>(xr, xi, rec, ops_f + OPF_STRIDE * o, ftab, fbase + 2 * o, j0, gidx0, g);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = j0 | xoff[c];
      if constexpr (OUT_GLOBAL) {
        const int64_t idx = tbase | axoff[j >> g.t] | (j & low_mask);
        global_put<T, VB>(re, idx, xr + (c << VB), vec);
        global_put<T, VB>(im, idx, xi + (c << VB), vec);
      } else {
        smem_put<T, VB>(wre + swz<VB>(j), xr + (c << VB));
        smem_put<T, VB>(wim + swz<VB>(j), xi + (c << VB));
      }
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

// ---------------------------------------------------------------------------
// Matrix groups: the TPU kernel's lanemat / rowmat / xtable branches
// (pallas_fused.py:911-966) on Hopper's warpgroup tensor-core products
// (wgmma), for the MAT instances (fused_matmul.cu).  A matrix segment's tile
// is 2^13 amplitudes, viewed a plane at a time as X, 64 rows of 128 lanes
// (element j: row j >> 7, lane j & 127, at swz<VB>(j), VB = 2); the lane bits
// 0-6 are always low tile bits, and a segment with a rowmat or xtable has
// t = 13, so its rows are the index bits 7-12 (ops/fused.py checks both).
//
//   lanemat  Y = X W (M = 64 rows, N = 128 lanes, K = 128 lanes), W[k][n] =
//            tab[k][n] (the table holds W^T of the JAX package's operator).
//   rowmat   Y = V X with V[m][k] = tab[k][m], computed transposed:
//            Y^T = X^T V^T (M = 128 lanes, N = 64 rows, K = 64 rows), so
//            that V^T[k][n] = tab[k][n] is the shared-memory operand.
//   xtable   Y = X * (cos + i sin), elementwise, a (64, 128) phase table.
//
// A real table (the H chains) takes two real products a plane pair, a
// complex one four: Yr = Xr Wr - Xi Wi, Yi = Xr Wi + Xi Wr (the minus as the
// product's scale -1).  float32 planes: 3xTF32, each operand x = hi + lo
// rounded to TF32 (cvt.rna), hi*hi + hi*lo + lo*hi with float32
// accumulation (wgmma m64n64k8 .tf32), about float32 accuracy, as the TPU
// kernel's Precision.HIGHEST.  bf16 planes: as the TPU kernel's MXU dots at
// bf16 storage, the f32 work tile's activations rounded to bf16 and two
// products against the table's bf16 hi and lo parts (wgmma m64n64k16 .bf16,
// float32 accumulation).
//
// Warpgroup wg (threads 128 wg ...) computes output lanes [64 wg, 64 wg + 64)
// of a lanemat (its half of N; it reads all 64 x 128 activations once) and
// lanes [64 wg, 64 wg + 64) of a rowmat (its half of M; it reads only its
// half of the tile).  The activations are the register operand: each
// element is loaded once an op by 16-byte (lanemat) or 8-byte (rowmat)
// shared loads, converted once (TF32 hi / lo, or rounded to bf16), and fed
// to the products; the K order of the products is permuted (the host
// permutes the table's K to match) so that a 16-byte load of 4 consecutive
// lanes feeds one bf16 or two TF32 k-steps, and a rowmat's M index g / g + 8
// of a warp's 16 is lane 2g / 2g + 1, so one 8-byte load feeds both.  A
// rowmat's output rows (and its bf16 K rows) run in "rowmat order", row
// n ^ ((n >> 1) & 1) for index n: the four threads c of a quad, which read
// or write one row each, then take rows of both parities, which the tile's
// swizzle puts on different banks (2-way conflicts, not 4-way).
//
// Tables: prepared once a segment on the host (ops/fused.py,
// matrix_tables) in the form the products read: TF32 hi / lo pre-split at
// float32, bf16 hi / lo at bf16, K permuted as above, in the no-swizzle
// K-major core-matrix layout of the wgmma shared-memory descriptor (8 rows
// of 16 bytes a core matrix; LBO 128 bytes between the two K halves of a
// k-step, SBO 256 bytes between groups of 8 columns of N), cut into
// MAT_CHUNK-byte chunks in op order: one chunk holds 1, 2 or 4 k-steps of
// every part (re hi, re lo, im hi, im lo).  An xtable's four chunks hold
// its cos / sin in the order each thread consumes them.  The chunk stream
// (the same for every tile) passes through a ring of MAT_STAGES chunks in
// shared memory: thread 0 issues each chunk as one bulk asynchronous copy
// (cp.async.bulk, completion on the stage's full mbarrier) as soon as every
// warp has released the stage's previous chunk (its empty mbarrier), so
// the copies of the next chunks overlap the products of this one.
//
// Each k-step's products are issued asynchronously and committed as one
// group; the next k-step's activations are converted while they run
// (wgmma.wait_group 1), and a chunk is released once its last group is done.
// The epilogue writes each op's accumulators into the work tile once, with
// 8-byte stores, after a block-wide sync; an xtable that directly follows a
// rowmat (the iQFT segment's rowmat + xtable + lanemat) is applied to the
// rowmat's float32 accumulators before that store (the same arithmetic in
// the same order as its own pass: xr pc - xi ps, xr ps + xi pc).
//
// Accumulator layout (PTX ISA, wgmma .m64nNk*, f32 D): thread lane = 4 g + c
// of warp w of the warpgroup holds d[4 j + r] at M index 16 w + g + 8 (r >> 1),
// N index 8 j + 2 c + (r & 1).  The register A fragment (as mma.sync's):
// .tf32 a0..a3 at (M, K) = (g, c), (g + 8, c), (g, c + 4), (g + 8, c + 4);
// .bf16 (two values a register, the lower K in the low half) at (g, 2c..),
// (g + 8, 2c..), (g, 2c + 8..), (g + 8, 2c + 8..).

constexpr int MAT_CHUNK = 16384;    // bytes of a table chunk, one stage of the ring
// Stages of the table ring.  Up to 6 (f32) or 8 (bf16) fit beside the
// tiles; 3 and 4 measured within 1% of each other, all that fit 3-4% slower
// (PERF.md).
constexpr int MAT_STAGES = 4;
constexpr int MAT_WARPS = THREADS / 32;
// The table ring.  Chunk q of the block's stream (chunk q % per_tile of
// mtab) lands in stage q % MAT_STAGES: thread 0 copies it as one 16 KB
// cp.async.bulk, and full[s] at bar + 8 s counts that thread's arrival and
// the chunk's bytes.  empty[s] at bar + 8 (MAT_STAGES + s) counts
// MAT_WARPS, one a warp once it has done with the chunk (256 arrivals on
// one word a chunk would be 256 atomics).
struct MatPipe {
  const unsigned char* src;  // mtab
  uint32_t ring;             // shared address of stage 0
  uint32_t bar;
  int per_tile;    // chunks a tile consumes
  int64_t total;   // chunks this block consumes
  int64_t issued;  // chunks issued
  // Stages and phase parities advance with the counters, without divisions:
  int iss_s, iss_src, acq_s, rel_s;  // next stage to fill, its source chunk in mtab, next to acquire, to release
  uint32_t iss_par, acq_par;          // the empty phase to wait for before a refill; the full phase to wait for
  bool refill;                        // the stage to fill has held a chunk before
};

__device__ __forceinline__ void advance(int& s, uint32_t& par, int n) {
  if (++s == n) {
    s = 0;
    par ^= 1;
  }
}

// Start the copies of the next chunk of the stream into its stage, once
// every warp has released the chunk the stage held.
__device__ __forceinline__ void mat_issue(MatPipe& p) {
  if (p.issued >= p.total) return;
  const int s = p.iss_s;
  const unsigned char* src = p.src + (size_t)p.iss_src * MAT_CHUNK;
  if (threadIdx.x == 0) {
    if (p.refill) mbar_wait(p.bar + 8 * (MAT_STAGES + s), p.iss_par);
    mbar_expect_tx(p.bar + 8 * s, MAT_CHUNK);
    bulk_copy(p.ring + s * MAT_CHUNK, src, MAT_CHUNK, p.bar + 8 * s);
  }
  __syncwarp();
  ++p.issued;
  if (++p.iss_src == p.per_tile) p.iss_src = 0;
  if (++p.iss_s == MAT_STAGES) {
    p.iss_s = 0;
    if (p.refill) p.iss_par ^= 1;
    p.refill = true;
  }
}

// The next chunk of the stream, once it has landed: its shared address.
// Each acquire first issues one more chunk, so MAT_STAGES - 2 run ahead: the
// stage it fills held the chunk two before this one, which this thread
// has released (it holds one chunk besides the one it acquires).
__device__ __forceinline__ uint32_t mat_acquire(MatPipe& p) {
  mat_issue(p);
  const int s = p.acq_s;
  mbar_wait(p.bar + 8 * s, p.acq_par);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the copies, to the products' reads
  advance(p.acq_s, p.acq_par, MAT_STAGES);
  return p.ring + s * MAT_CHUNK;
}

// This warp is done with the oldest chunk it holds (every thread calls it).
__device__ __forceinline__ void mat_release(MatPipe& p) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(p.bar + 8 * (MAT_STAGES + p.rel_s));
  if (++p.rel_s == MAT_STAGES) p.rel_s = 0;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A shared-memory descriptor of one part of a k-step: no swizzle, K-major,
// LBO 128 bytes (the second 16 bytes of K), SBO 256 bytes (the next 8 of N).
__device__ __forceinline__ uint64_t mat_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator accesses across the asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define QC_D32                                                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define QC_D32_ARGS(d)                                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),   \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),    \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64 f32) += SA * a b: a from registers, b through its descriptor.
template <int SA>
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " QC_D32 ", {%32, %33, %34, %35}, %36, p, %37, 1;\n}\n"
      : QC_D32_ARGS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(SA), "r"(1));
}

template <int SA>
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " QC_D32 ", {%32, %33, %34, %35}, %36, p, %37, 1, 0;\n}\n"
      : QC_D32_ARGS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(SA), "r"(1));
}

#undef QC_D32
#undef QC_D32_ARGS

// One plane's activations of a k-step, converted: TF32 hi and lo, or bf16.
template <bool BF>
struct AFrag {
  uint32_t hi[4], lo[4];
};
template <>
struct AFrag<true> {
  uint32_t hi[4];
};

__device__ __forceinline__ AFrag<false> convert_tf32(float v0, float v1, float v2, float v3) {
  AFrag<false> f;
  const float v[4] = {v0, v1, v2, v3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = to_tf32(v[i]);
    f.lo[i] = to_tf32(v[i] - __uint_as_float(f.hi[i]));
  }
  return f;
}

// bf16: (v0, v1) and (v2, v3) are the two K values of a register pair; the
// register order is a0 = (v0, v1) of row g, a1 of row g + 8, ...: callers
// pass the 8 values in register order.
__device__ __forceinline__ AFrag<true> convert_bf16(float a0, float a1, float b0, float b1, float c0, float c1,
                                                    float e0, float e1) {
  AFrag<true> f;
  f.hi[0] = pack_bf16(a0, a1);
  f.hi[1] = pack_bf16(b0, b1);
  f.hi[2] = pack_bf16(c0, c1);
  f.hi[3] = pack_bf16(e0, e1);
  return f;
}

// A use of a fragment's registers that the compiler cannot drop: a k-step's
// fragments are read by its asynchronous products until their group is done
// (reading or writing them earlier is undefined), so each step's fragments
// are kept live until after the next step's wgmma.wait_group, and the next
// step's conversion cannot take their registers.
template <bool BF>
__device__ __forceinline__ void keep(const AFrag<BF>& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    asm volatile("" ::"r"(f.hi[i]));
    if constexpr (!BF) asm volatile("" ::"r"(f.lo[i]));
  }
}

// d += SA * a (b_hi + b_lo): 3xTF32 (lo * lo dropped, small terms first) or two bf16 products.
template <int SA>
__device__ __forceinline__ void mat_prod(float (&d)[32], const AFrag<false>& a, uint64_t b_hi, uint64_t b_lo) {
  wgmma_tf32<SA>(d, a.lo, b_hi);
  wgmma_tf32<SA>(d, a.hi, b_lo);
  wgmma_tf32<SA>(d, a.hi, b_hi);
}
template <int SA>
__device__ __forceinline__ void mat_prod(float (&d)[32], const AFrag<true>& a, uint64_t b_hi, uint64_t b_lo) {
  wgmma_bf16<SA>(d, a.hi, b_lo);
  wgmma_bf16<SA>(d, a.hi, b_hi);
}

__device__ __forceinline__ float* tile_ptr(float* p, int row, int lane) { return p + swz<2>((row << 7) | lane); }

// The xtable chunk q's values of this thread: (cos, sin) of its 8 elements
// i = 4 jj + e, at row 16 q + 8 jj + 2 c + ((e ^ c) & 1) (the rowmat's
// output order), lane 64 wg + 16 w + 2 g + (e >> 1).
__device__ __forceinline__ void xtable_values(MatPipe& p, float (&x)[16]) {
  const uint32_t chunk = mat_acquire(p);
  const float4* src = reinterpret_cast<const float4*>(
      __cvta_shared_to_generic(chunk + 16 * ((threadIdx.x >> 7) * 4 * 128 + (threadIdx.x & 127))));
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float4 f = src[v * 128];
    x[4 * v] = f.x;
    x[4 * v + 1] = f.y;
    x[4 * v + 2] = f.z;
    x[4 * v + 3] = f.w;
  }
  mat_release(p);
}

// One lanemat (ROW false) or rowmat (ROW true) on the f32 work tile (sre,
// sim), its table chunks from the ring; with `fuse_x` (a rowmat) the
// following xtable's four chunks applied before the store.  S: the storage
// type, which fixes the products' precision.
template <typename S, bool ROW, bool REAL>
__device__ __forceinline__ void mat_product(float* sre, float* sim, MatPipe& p, bool fuse_x) {
  constexpr bool BF = sizeof(S) == 2;
  constexpr int K = ROW ? 64 : 128;
  constexpr int N = ROW ? 64 : 128;  // columns of B in a chunk
  constexpr int PARTS = REAL ? 2 : 4;
  constexpr int PART_BYTES = N * 32;  // one k-step (32 bytes of K) of one part
  constexpr int STEP_BYTES = PARTS * PART_BYTES;
  constexpr int KPC = MAT_CHUNK / STEP_BYTES;  // k-steps a chunk
  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3, g = (tid & 31) >> 2, c = tid & 3;
  const int r0 = 16 * w + g;              // lanemat: this thread's rows r0, r0 + 8
  const int lr = 64 * wg + 16 * w + 2 * g;  // rowmat: its lanes lr, lr + 1 (M indices g, g + 8)
  float yr[32], yi[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yr[i] = yi[i] = 0.f;
  uint32_t chunk = 0;
  // Two k-steps an iteration (one group of 16 K indices at TF32, two at
  // bf16), each with fragments of its own: step h's are kept live (keep)
  // until the products of the step after it are issued and its own are done.
  AFrag<BF> ar[2] = {}, ai[2] = {};
#pragma unroll 1
  for (int it = 0; it < K / (BF ? 32 : 16); ++it) {
    // This iteration's activations, each loaded once: per k-step, the
    // register values of each plane in fragment order (4 at TF32, 8 at bf16).
    float xr[2][8], xi[2][8];
    if constexpr (!ROW) {
#pragma unroll
      for (int grp = 0; grp < (BF ? 2 : 1); ++grp) {
        const int lane = 16 * (BF ? 2 * it + grp : it) + 4 * c;
        const float4 p0 = *reinterpret_cast<const float4*>(tile_ptr(sre, r0, lane));
        const float4 p1 = *reinterpret_cast<const float4*>(tile_ptr(sre, r0 + 8, lane));
        const float4 q0 = *reinterpret_cast<const float4*>(tile_ptr(sim, r0, lane));
        const float4 q1 = *reinterpret_cast<const float4*>(tile_ptr(sim, r0 + 8, lane));
        if constexpr (BF) {  // step grp: K 2c, 2c + 1 <- lanes 4c, 4c + 1; K 2c + 8, 2c + 9 <- 4c + 2, 4c + 3
          const float vr[8] = {p0.x, p0.y, p1.x, p1.y, p0.z, p0.w, p1.z, p1.w};
          const float vi[8] = {q0.x, q0.y, q1.x, q1.y, q0.z, q0.w, q1.z, q1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) xr[grp][i] = vr[i], xi[grp][i] = vi[i];
        } else {  // step h: K c <- lane 4c + 2h, K c + 4 <- lane 4c + 2h + 1
          const float vr[2][4] = {{p0.x, p1.x, p0.y, p1.y}, {p0.z, p1.z, p0.w, p1.w}};
          const float vi[2][4] = {{q0.x, q1.x, q0.y, q1.y}, {q0.z, q1.z, q0.w, q1.w}};
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 4; ++i) xr[h][i] = vr[h][i], xi[h][i] = vi[h][i];
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (BF) {  // step h: K 2c + {0, 1, 8, 9} <- rows 16 (2 it + h) + rowmat order of the same
          float2 fr[4], fi[4];
          const int o = c & 1;  // odd c takes its row pairs swapped (rowmat order)
          const int rows[4] = {2 * c + o, 2 * c + 1 - o, 2 * c + 8 + o, 2 * c + 9 - o};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            fr[i] = *reinterpret_cast<const float2*>(tile_ptr(sre, 16 * (2 * it + h) + rows[i], lr));
            fi[i] = *reinterpret_cast<const float2*>(tile_ptr(sim, 16 * (2 * it + h) + rows[i], lr));
          }
          const float vr[8] = {fr[0].x, fr[1].x, fr[0].y, fr[1].y, fr[2].x, fr[3].x, fr[2].y, fr[3].y};
          const float vi[8] = {fi[0].x, fi[1].x, fi[0].y, fi[1].y, fi[2].x, fi[3].x, fi[2].y, fi[3].y};
#pragma unroll
          for (int i = 0; i < 8; ++i) xr[h][i] = vr[i], xi[h][i] = vi[i];
        } else {  // step h: K c, c + 4 <- rows 16 it + 8 h + c, + 4
          const int row = 16 * it + 8 * h + c;
          const float2 fa = *reinterpret_cast<const float2*>(tile_ptr(sre, row, lr));
          const float2 fb = *reinterpret_cast<const float2*>(tile_ptr(sre, row + 4, lr));
          const float2 ga = *reinterpret_cast<const float2*>(tile_ptr(sim, row, lr));
          const float2 gb = *reinterpret_cast<const float2*>(tile_ptr(sim, row + 4, lr));
          xr[h][0] = fa.x, xr[h][1] = fa.y, xr[h][2] = fb.x, xr[h][3] = fb.y;
          xi[h][0] = ga.x, xi[h][1] = ga.y, xi[h][2] = gb.x, xi[h][3] = gb.y;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int step = 2 * it + h;
      const bool first = step % KPC == 0;
      if (first) chunk = mat_acquire(p);
      if constexpr (BF) {
        ar[h] = convert_bf16(xr[h][0], xr[h][1], xr[h][2], xr[h][3], xr[h][4], xr[h][5], xr[h][6], xr[h][7]);
        ai[h] = convert_bf16(xi[h][0], xi[h][1], xi[h][2], xi[h][3], xi[h][4], xi[h][5], xi[h][6], xi[h][7]);
      } else {
        ar[h] = convert_tf32(xr[h][0], xr[h][1], xr[h][2], xr[h][3]);
        ai[h] = convert_tf32(xi[h][0], xi[h][1], xi[h][2], xi[h][3]);
      }
      const uint32_t base = chunk + (step % KPC) * STEP_BYTES + (ROW ? 0 : wg * (PART_BYTES / 2));
      const uint64_t re_hi = mat_desc(base), re_lo = mat_desc(base + PART_BYTES);
      fence_acc(yr);
      fence_acc(yi);
      wgmma_fence();
      mat_prod<1>(yr, ar[h], re_hi, re_lo);
      mat_prod<1>(yi, ai[h], re_hi, re_lo);
      if constexpr (!REAL) {
        const uint64_t im_hi = mat_desc(base + 2 * PART_BYTES), im_lo = mat_desc(base + 3 * PART_BYTES);
        mat_prod<-1>(yr, ai[h], im_hi, im_lo);
        mat_prod<1>(yi, ar[h], im_hi, im_lo);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-step's products are done
      fence_acc(yr);
      fence_acc(yi);
      keep(ar[h ^ 1]);  // ... so its fragments may now be overwritten
      keep(ai[h ^ 1]);
      if (first && step > 0) mat_release(p);  // ... and with them the chunk before this one
    }
  }
  wgmma_wait<0>();
  fence_acc(yr);
  fence_acc(yi);
  keep(ar[1]);
  keep(ai[1]);
  mat_release(p);
  if constexpr (ROW) {
    if (fuse_x) {  // the xtable after this rowmat, on the accumulators: d[4 j + e], j = 2 q + jj
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float x[16];
        xtable_values(p, x);
#pragma unroll
        for (int i = 0; i < 8; ++i) cmul(yr[8 * q + i], yi[8 * q + i], x[2 * i], x[2 * i + 1]);
      }
    }
  }
  __syncthreads();  // every thread has read the tile
  if constexpr (!ROW) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int lane = 64 * wg + 8 * j + 2 * c;
      *reinterpret_cast<float2*>(tile_ptr(sre, r0, lane)) = make_float2(yr[4 * j], yr[4 * j + 1]);
      *reinterpret_cast<float2*>(tile_ptr(sre, r0 + 8, lane)) = make_float2(yr[4 * j + 2], yr[4 * j + 3]);
      *reinterpret_cast<float2*>(tile_ptr(sim, r0, lane)) = make_float2(yi[4 * j], yi[4 * j + 1]);
      *reinterpret_cast<float2*>(tile_ptr(sim, r0 + 8, lane)) = make_float2(yi[4 * j + 2], yi[4 * j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row0 = 8 * j + 2 * c + (c & 1), row1 = row0 ^ 1;  // N 8j + 2c, 8j + 2c + 1 in rowmat order
      *reinterpret_cast<float2*>(tile_ptr(sre, row0, lr)) = make_float2(yr[4 * j], yr[4 * j + 2]);
      *reinterpret_cast<float2*>(tile_ptr(sre, row1, lr)) = make_float2(yr[4 * j + 1], yr[4 * j + 3]);
      *reinterpret_cast<float2*>(tile_ptr(sim, row0, lr)) = make_float2(yi[4 * j], yi[4 * j + 2]);
      *reinterpret_cast<float2*>(tile_ptr(sim, row1, lr)) = make_float2(yi[4 * j + 1], yi[4 * j + 3]);
    }
  }
}

// An xtable that does not follow a rowmat: its own pass over the tile, each
// thread on the elements whose phases it holds (xtable_values).
__device__ __forceinline__ void xtable_pass(float* sre, float* sim, MatPipe& p) {
  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3, g = (tid & 31) >> 2, c = tid & 3;
#pragma unroll 1
  for (int q = 0; q < 4; ++q) {
    float x[16];
    xtable_values(p, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = 16 * q + 8 * (i >> 2) + 2 * c + ((i ^ c) & 1), lane = 64 * wg + 16 * w + 2 * g + ((i >> 1) & 1);
      float* pr = tile_ptr(sre, row, lane);
      float* pi = tile_ptr(sim, row, lane);
      float xr = *pr, xi = *pi;
      cmul(xr, xi, x[2 * i], x[2 * i + 1]);
      *pr = xr;
      *pi = xi;
    }
  }
}

// One matrix op (record rec: kind, -1, -1, -1, its chunks, its table's byte
// offset in mtab, 1 for a real table, 1 when a rowmat applies the xtable
// after it) on the f32 tile (sre, sim).
template <typename S>
__device__ __forceinline__ void run_matrix(float* sre, float* sim, const int* rec, MatPipe& p) {
  const bool real = rec[6] > 0, fused = rec[7] > 0;
  if (rec[0] == OP_XTABLE) {
    if (!fused) xtable_pass(sre, sim, p);  // else the rowmat before it applied it
  } else if (rec[0] == OP_ROWMAT) {
    if (real) {
      mat_product<S, true, true>(sre, sim, p, fused);
    } else {
      mat_product<S, true, false>(sre, sim, p, fused);
    }
  } else if (real) {
    mat_product<S, false, true>(sre, sim, p, false);
  } else {
    mat_product<S, false, false>(sre, sim, p, false);
  }
}

// F_base of each iQFT op with tile-base bits, for the tile at tbase: (re,
// im) at fbase[2 * o], written by NT threads.
template <typename T, int NT>
__device__ __forceinline__ void fill_fbase(T* fbase, const int* __restrict__ ops_i, int nops, int64_t tbase, int M) {
  for (int o = threadIdx.x; o < nops; o += NT) {
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
}

// Bytes of the ring of `slots` staging slots of a tile of `tile` elements of S.
template <typename S>
__host__ __device__ __forceinline__ size_t ring_bytes(int tile, int slots) {
  return (slots * 2 * sizeof(S) * (size_t)tile + 15) & ~(size_t)15;
}

// The instance's staging slots: WIDEN_STAGES in the direct bf16 form, else
// two (a ring) or one.
template <typename S, typename T, bool PERM, bool MAT>
__host__ __device__ __forceinline__ int ring_slots(bool ring) {
  return is_direct<S, T, PERM, MAT> ? WIDEN_STAGES : (ring ? 2 : 1);
}

// Two blocks an SM: 128 registers a thread hold a group's 2^NE amplitudes
// without spills (a cap of 80, for three blocks, spilled and ran slower);
// the direct bf16 form: three blocks of DIRECT_THREADS, 168 registers a
// thread for its 2^5 amplitudes.
// PERM: the instance for segments that mix camodc ops with others; run_camodc's registers
// would otherwise cost every segment spills.  MAT: the instance for segments
// with matrix groups (fused_matmul.cu), one block an SM: its 2^13-amplitude
// tile and the table ring (MAT_STAGES chunks after the op records) fill the
// shared memory, and its accumulators take more than 128 registers.  S: the
// storage type, T: the compute type; S = bf16 with T = float takes the
// direct form (DIRECT: a staging ring, widened and rounded in registers),
// or with PERM or MAT stages each tile and widens it into a work tile (see
// the header); S = T computes in the ring slot itself.
template <typename S, typename T, int VB, int NE, bool PERM, bool MAT>
__global__ void __launch_bounds__(is_direct<S, T, PERM, MAT> ? DIRECT_THREADS : THREADS,
                                  is_direct<S, T, PERM, MAT> ? 3 : (MAT ? 1 : 2))
fused_segment_kernel(S* __restrict__ re, S* __restrict__ im, const int* __restrict__ ops_i,
                     const T* __restrict__ ops_f, const int* __restrict__ groups, int ngroups,
                     const T* __restrict__ ftab, const short* __restrict__ ptab,
                     const unsigned char* __restrict__ mtab, int nops, Geom g, int M, int64_t tiles, bool vec,
                     bool ring) {
  constexpr bool WIDEN = !std::is_same<S, T>::value;
  constexpr bool DIRECT = is_direct<S, T, PERM, MAT>;
  constexpr int SB = WIDEN ? 3 : VB;  // the staging slot's swizzle: 16-byte chunks of S
  constexpr int NT = DIRECT ? DIRECT_THREADS : THREADS;
  constexpr int OPC = op_coefs<NE>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t axoff[1 << MAX_AXES];  // axoff[c]: the axis bits of row c, any tile
  const int tile = 1 << (g.t + g.k);
  S* bufs = reinterpret_cast<S*>(smem);     // ring slot b: re at bufs + 2*b*tile, im after it
  // The tile the ops run on: the ring slot itself, or (WIDEN) the f32 work tile after the ring.
  T* work = reinterpret_cast<T*>(smem + ring_bytes<S>(tile, ring_slots<S, T, PERM, MAT>(ring)));
  T* fbase = work + (WIDEN ? 2 * tile : 0);  // F_base of each op for the current tile (re, im)
  T* s_opc = fbase + 2 * ((nops + 1) & ~1); // each op's first OPC coefficients (16-byte aligned)
  int* s_opi = reinterpret_cast<int*>(s_opc + OPC * nops);  // each op's int record
  for (int i = threadIdx.x; i < OPC * nops; i += NT) s_opc[i] = ops_f[OPF_STRIDE * (i / OPC) + i % OPC];
  for (int i = threadIdx.x; i < OPI_STRIDE * nops; i += NT) s_opi[i] = ops_i[i];
  for (int c = threadIdx.x; c < (1 << g.k); c += NT) {
    int64_t off = 0;
#pragma unroll
    for (int a = 0; a < MAX_AXES; ++a) {
      if (a < g.k) off |= (int64_t)((c >> a) & 1) << g.axes[a];
    }
    axoff[c] = off;
  }
  MatPipe pipe{};
  if constexpr (MAT) {
    // The table ring after the op records (128-byte aligned), then its mbarriers.
    const size_t head = ((size_t)(reinterpret_cast<unsigned char*>(s_opi + OPI_STRIDE * nops) - smem) + 127) & ~(size_t)127;
    pipe.ring = smem_u32(smem + head);
    pipe.bar = pipe.ring + MAT_STAGES * MAT_CHUNK;
    if (threadIdx.x == 0) {
      for (int s = 0; s < MAT_STAGES; ++s) {
        mbar_init(pipe.bar + 8 * s, 1);
        mbar_init(pipe.bar + 8 * (MAT_STAGES + s), MAT_WARPS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
  if constexpr (MAT) {
    for (int o = 0; o < nops; ++o) {
      if (s_opi[OPI_STRIDE * o] >= OP_LANEMAT) pipe.per_tile += s_opi[OPI_STRIDE * o + 4];
    }
    const int64_t mine = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;  // tiles of this block
    pipe.total = mine * pipe.per_tile;
    pipe.src = mtab;
    for (int c = 0; c < MAT_STAGES - 2; ++c) mat_issue(pipe);
  }

  if constexpr (DIRECT) {
    // Tile i of this block lands in slot i % WIDEN_STAGES; tiles i + 1 ..
    // i + WIDEN_STAGES - 1 are in flight while tile i is computed.  The slot
    // refilled at the top of an iteration held the tile before, whose last
    // reads ended before that iteration's closing barrier.
    constexpr int NS = WIDEN_STAGES;
    const int64_t step = gridDim.x;
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      const int64_t tt = blockIdx.x + s * step;
      if (tt < tiles) load_tile<S, SB, NT>(bufs + 2 * s * tile, bufs + (2 * s + 1) * tile, re, im, tile_base(tt, g), axoff, g, vec);
      cp_async_commit();
    }
    int b = 0;
    for (int64_t tau = blockIdx.x; tau < tiles; tau += step) {
      const int64_t ahead = tau + (NS - 1) * step;
      const int sa = b == 0 ? NS - 1 : b - 1;
      if (ahead < tiles) load_tile<S, SB, NT>(bufs + 2 * sa * tile, bufs + (2 * sa + 1) * tile, re, im, tile_base(ahead, g), axoff, g, vec);
      cp_async_commit();
      cp_async_wait_group<NS - 1>();  // this tile's copies are done
      const int64_t tbase = tile_base(tau, g);
      fill_fbase<T, NT>(fbase, ops_i, nops, tbase, M);
      __syncthreads();  // the tile and fbase are ready
      const S* sst = bufs + 2 * b * tile;
      const S* ist = sst + tile;
      T* wim = work + tile;
      for (int gi = 0; gi < ngroups; ++gi) {
        const int* grp = groups + GRP_STRIDE * gi;
        const bool first = gi == 0, last = gi == ngroups - 1;
        if (first && last) {
          run_group<T, VB, NE, true, true, NT>(work, wim, grp, s_opi, s_opc, ops_f, ftab, fbase, tbase, axoff, g, sst, ist, re, im, vec);
        } else if (first) {
          run_group<T, VB, NE, true, false, NT>(work, wim, grp, s_opi, s_opc, ops_f, ftab, fbase, tbase, axoff, g, sst, ist, re, im, vec);
        } else if (last) {
          run_group<T, VB, NE, false, true, NT>(work, wim, grp, s_opi, s_opc, ops_f, ftab, fbase, tbase, axoff, g, sst, ist, re, im, vec);
        } else {
          run_group<T, VB, NE, false, false, NT>(work, wim, grp, s_opi, s_opc, ops_f, ftab, fbase, tbase, axoff, g, sst, ist, re, im, vec);
        }
        __syncthreads();  // the work tile, or (last) the slot and fbase, are free
      }
      b = b + 1 == NS ? 0 : b + 1;
    }
  } else {
    // The ring: with `ring`, tile i of this block lands in slot i % 2 while
    // tile i - 1 is computed; without, each tile lands in slot 0 once the one
    // before it is stored.  WIDEN has one slot and no ring: the next tile lands
    // in it once this one is widened into the work tile, while this one is
    // computed.
    const bool early = ring || WIDEN;  // the next tile's copy starts before this tile's ops
    const int64_t step = gridDim.x;
    int64_t tau = blockIdx.x;
    bool act = tau < tiles;
    if (act) load_tile<S, SB>(bufs, bufs + tile, re, im, tile_base(tau, g), axoff, g, vec);
    cp_async_commit();
    int b = 0;
    for (; tau < tiles; tau += step) {
      cp_async_wait_group<0>();  // this tile's copies are done
      const int64_t tbase = tile_base(tau, g);
      if (act) fill_fbase<T, THREADS>(fbase, ops_i, nops, tbase, M);
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
      const bool nact = nxt < tiles;
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
              run_matrix<S>(sre, sim, first, pipe);
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
  constexpr int NT = is_direct<S, T, PERM, MAT> ? DIRECT_THREADS : THREADS;
  size_t smem = ring_bytes<S>(tile, ring_slots<S, T, PERM, MAT>(ring)) + (WIDEN ? 2 * sizeof(T) * (size_t)tile : 0) +
                      (2 + op_coefs<NE>()) * sizeof(T) * (size_t)(nops + 1) + OPI_STRIDE * sizeof(int) * (size_t)nops;
  auto kern = fused_segment_kernel<S, T, VB, NE, PERM, MAT>;
  cudaError_t err;
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  // The table ring (128-byte aligned) and its mbarriers after the op records.
  if (MAT) smem = ((smem + 127) & ~(size_t)127) + (size_t)MAT_STAGES * (MAT_CHUNK + 16);
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem)) != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  const int64_t grid = tiles < (int64_t)sms * per_sm ? tiles : (int64_t)sms * per_sm;
  kern<<<(unsigned int)grid, NT, smem, (cudaStream_t)stream>>>(
      re, im, (const int*)ops_i, (const T*)ops_f, (const int*)groups, ngroups, (const T*)ftab, (const short*)ptab,
      (const unsigned char*)mtab, nops, g, M, tiles, vec, ring);
  return (int)cudaGetLastError();
}

}  // namespace
