// The camodc permutation: a fused segment whose every op is a camodc op
// (--oracle benes), for Hopper (sm_90a).
//
// Replaces the camodc_k branch of quantumcomputer_tpu/ops/pallas_fused.py
// ::_fused_kernel (:967-997, the kernel at :1002) on such segments.  On the
// TPU that branch is 2M - 1 masked exchange stages of a Benes network,
// because TPU lanes cannot gather.  Here it is one gather a moved element.
// Segments that mix camodc ops with other ops keep the fused kernel's
// run_camodc (fused_segment.cuh, the PERM instances).
//
// What it computes.  A camodc op with control c and inverse table
// g(f) = A^-1 * f mod C (f < C, f otherwise) permutes each 2^M-element work
// block of the state whose control bit is 1: out[f] = in[g[f]].  A segment
// of (at most two) such ops is one permutation of each work block, chosen by
// the block's control bits: the identity where they are all 0, else the
// composition, in op order, of the tables of the ops whose control is 1 (for
// ops 1 then 2: out[f] = in[g1[g2[f]]]).  The host builds these "case
// tables" once a segment (ops/fused.py, permute_descriptor): table m - 1 for
// each nonzero combination m of the k distinct control bits, 2^M uint16
// each.
//
// What bounds it: device-memory bandwidth, one read and one write of the
// work blocks the segment changes (the other blocks are neither read nor
// written): at n = 28 a pair changes 3/4 of the state, 0.962 ms at complex64
// over 3.35 TB/s, 0.481 ms at complex32.  The design:
//
//   * A work unit is one plane of one changed work block (32 KB at float32
//     and M = 13; 16 KB at bf16, 64 KB at float64): the real and imaginary
//     planes are permuted independently by the same table.
//   * Only the changed blocks are enumerated.  The d-th changed block of a
//     segment with k distinct controls is found by inserting the control
//     bits of its case m = (d >> log_q) + 1 into d's low log_q bits, so the
//     case comes with the index and no block's loop skips work.
//   * Persistent blocks, one a streaming multiprocessor, with a ring of as
//     many unit slots as fit beside the case tables (up to MAX_SLOTS).  One
//     thread fills each slot with bulk copies (cp.async.bulk, completion on
//     the slot's mbarrier), so the other slots' copies overlap the gather
//     of the unit at hand.
//   * The case tables are staged in shared memory once a block (at most
//     three, 48 KB at M = 13), so an element's source index costs no L1 or
//     L2 read.
//   * One shared-memory read an element and stores straight out: a thread
//     takes 16 output bytes at a time (8 bf16, 4 float32 or 2 float64
//     elements), reads their sources' indices in one load of the table,
//     gathers them from the slot, and writes them with one 16-byte store.
//     The whole unit is in shared memory before any store, and a unit
//     belongs to one block, so the permutation is in place.  Nothing is
//     written back into shared memory; a unit costs one block barrier,
//     before its slot is refilled.
//   * Elements move as raw bits: bf16 is neither widened nor rounded.
//
// Shapes it takes (ops/fused.py, kernel_body, is the router): every op a
// camodc op, at most two distinct controls, planes 16-byte aligned and at
// least 16 bytes a work block.  A small work block fills few of a block's
// threads; such segments only occur at test sizes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mbarrier.cuh"

namespace {

constexpr int PERMUTE_THREADS = 512;
constexpr int MAX_SLOTS = 8;
constexpr uint32_t COPY_BYTES = 16384;  // bytes of one bulk copy; a unit takes 1-4
constexpr int MAX_M = 13;               // uint16 tables; 64 KB float64 units

template <int BYTES>
using Bits = typename std::conditional<
    BYTES == 2, unsigned short, typename std::conditional<BYTES == 4, unsigned, unsigned long long>::type>::type;

// Table entries padded to a multiple of 8 (16 bytes), the bulk copies' unit.
__host__ __device__ __forceinline__ int table_stride(int M) { return ((1 << M) + 7) & ~7; }

__device__ __forceinline__ int64_t insert_bit(int64_t x, int p, int64_t bit) {
  const int64_t low = x & ((int64_t(1) << p) - 1);
  return ((x >> p) << (p + 1)) | (bit << p) | low;
}

// The work block of the d-th changed block and its case m (1 .. 2^k - 1):
// bit j of m is the control at position p_j (p0 < p1; p1 < 0 when k = 1).
__device__ __forceinline__ int64_t changed_block(int64_t d, int log_q, int p0, int p1, int& m) {
  m = (int)(d >> log_q) + 1;
  int64_t b = insert_bit(d & ((int64_t(1) << log_q) - 1), p0, m & 1);
  if (p1 >= 0) b = insert_bit(b, p1, (m >> 1) & 1);
  return b;
}

// The source indices of 16 output bytes: VE consecutive uint16 table entries.
template <int VE>
__device__ __forceinline__ void load_indices(const unsigned short* t, int (&idx)[VE]) {
  unsigned w[VE / 2];
  if constexpr (VE == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(t);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (VE == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(t);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const unsigned*>(t);
  }
#pragma unroll
  for (int i = 0; i < VE / 2; ++i) {
    idx[2 * i] = (int)(w[i] & 0xffffu);
    idx[2 * i + 1] = (int)(w[i] >> 16);
  }
}

template <int BYTES>
__device__ __forceinline__ uint4 pack16(const Bits<BYTES> (&v)[16 / BYTES]) {
  uint4 o;
  if constexpr (BYTES == 2) {
    o.x = v[0] | ((unsigned)v[1] << 16); o.y = v[2] | ((unsigned)v[3] << 16);
    o.z = v[4] | ((unsigned)v[5] << 16); o.w = v[6] | ((unsigned)v[7] << 16);
  } else if constexpr (BYTES == 4) {
    o.x = v[0]; o.y = v[1]; o.z = v[2]; o.w = v[3];
  } else {
    o.x = (unsigned)v[0]; o.y = (unsigned)(v[0] >> 32); o.z = (unsigned)v[1]; o.w = (unsigned)(v[1] >> 32);
  }
  return o;
}

// Shared memory: the case tables (ntab x table_stride(M) uint16, padded to
// 128 bytes), the ring of `slots` units, then slots + 1 mbarriers (one a
// slot, then the tables').
template <int BYTES>
__global__ void __launch_bounds__(PERMUTE_THREADS, 1)
camodc_permute_kernel(unsigned char* __restrict__ re, unsigned char* __restrict__ im,
                      const unsigned short* __restrict__ cases, int M, int ntab, int p0, int p1, int log_q,
                      int64_t items, int slots) {
  using E = Bits<BYTES>;
  constexpr int VE = 16 / BYTES;  // elements a 16-byte store
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t unit_bytes = (uint32_t)BYTES << M;
  const uint32_t table_bytes = (uint32_t)ntab * table_stride(M) * 2;
  const uint32_t ring_off = (table_bytes + 127) & ~127u;
  const uint32_t ring = smem_u32(smem + ring_off);
  const uint32_t bar = ring + (uint32_t)slots * unit_bytes;
  const uint32_t tbar = bar + 8 * slots;
  const int64_t grid = gridDim.x;

  // Item i: plane i & 1 of changed block i >> 1.  Thread 0 only.
  auto fill = [&](int64_t item, int s) {
    int m;
    const int64_t block = changed_block(item >> 1, log_q, p0, p1, m);
    const unsigned char* src = ((item & 1) ? im : re) + (block << M) * BYTES;
    const uint32_t dst = ring + (uint32_t)s * unit_bytes, b = bar + 8 * s;
    mbar_expect_tx(b, unit_bytes);
    for (uint32_t o = 0; o < unit_bytes; o += COPY_BYTES) {
      bulk_copy(dst + o, src + o, unit_bytes - o < COPY_BYTES ? unit_bytes - o : COPY_BYTES, b);
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s <= slots; ++s) mbar_init(bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(tbar, table_bytes);
    for (uint32_t o = 0; o < table_bytes; o += COPY_BYTES) {
      bulk_copy(smem_u32(smem) + o, reinterpret_cast<const unsigned char*>(cases) + o,
                table_bytes - o < COPY_BYTES ? table_bytes - o : COPY_BYTES, tbar);
    }
    for (int s = 0; s < slots && blockIdx.x + s * grid < items; ++s) fill(blockIdx.x + s * grid, s);
  }
  mbar_wait(tbar, 0);
  const unsigned short* tabs = reinterpret_cast<const unsigned short*>(smem);
  const int chunks = (1 << M) / VE;
  int s = 0;
  uint32_t par = 0;
  for (int64_t item = blockIdx.x; item < items; item += grid) {
    int m;
    const int64_t block = changed_block(item >> 1, log_q, p0, p1, m);
    const unsigned short* tab = tabs + (m - 1) * table_stride(M);
    const E* src = reinterpret_cast<const E*>(smem + ring_off + (size_t)s * unit_bytes);
    uint4* dst = reinterpret_cast<uint4*>(((item & 1) ? im : re) + (block << M) * BYTES);
    mbar_wait(bar + 8 * s, par);
#pragma unroll 4
    for (int q = threadIdx.x; q < chunks; q += PERMUTE_THREADS) {
      int idx[VE];
      load_indices<VE>(tab + q * VE, idx);
      E v[VE];
#pragma unroll
      for (int e = 0; e < VE; ++e) v[e] = src[idx[e]];
      dst[q] = pack16<BYTES>(v);
    }
    __syncthreads();  // every thread is done with slot s
    if (threadIdx.x == 0 && item + slots * grid < items) fill(item + slots * grid, s);
    if (++s == slots) {
      s = 0;
      par ^= 1;
    }
  }
}

template <int BYTES>
int launch_permute(void* re, void* im, const void* cases, int64_t ntab, int64_t n, int64_t M, int64_t k,
                   int64_t positions, void* stream) {
  const int p0 = (int)(positions & 0xff), p1 = k == 2 ? (int)((positions >> 8) & 0xff) : -1;
  const bool aligned = (reinterpret_cast<uintptr_t>(re) % 16) == 0 && (reinterpret_cast<uintptr_t>(im) % 16) == 0 &&
                       (reinterpret_cast<uintptr_t>(cases) % 16) == 0;
  if (M < 1 || M > MAX_M || (BYTES << M) < 16 || k < 1 || k > 2 || ntab != (1 << k) - 1 || n - M < k ||
      n - M > 40 || p0 >= n - M || (k == 2 && (p1 <= p0 || p1 >= n - M)) || !aligned) {
    return (int)cudaErrorInvalidValue;
  }
  const int log_q = (int)(n - M - k);
  const int64_t items = 2 * (((int64_t(1) << k) - 1) << log_q);
  const size_t unit_bytes = (size_t)BYTES << M;
  const size_t ring_off = ((size_t)ntab * table_stride((int)M) * 2 + 127) & ~(size_t)127;
  int dev = 0, sms = 0, cap = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess) return (int)err;
  const int64_t fit = ((int64_t)cap - (int64_t)ring_off - 8 * (MAX_SLOTS + 1)) / (int64_t)unit_bytes;
  const int slots = (int)(fit < MAX_SLOTS ? fit : MAX_SLOTS);
  if (slots < 1) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = ring_off + slots * unit_bytes + 8 * (slots + 1);
  auto kern = camodc_permute_kernel<BYTES>;
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, PERMUTE_THREADS, smem)) != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t grid = items < sms ? items : sms;
  kern<<<(unsigned int)grid, PERMUTE_THREADS, smem, (cudaStream_t)stream>>>(
      (unsigned char*)re, (unsigned char*)im, (const unsigned short*)cases, (int)M, (int)ntab, p0, p1, log_q, items,
      slots);
  return (int)cudaGetLastError();
}

}  // namespace

// re, im: the planes (2^n elements each, in place); cases: ntab = 2^k - 1
// case tables of table_stride(M) uint16 each; positions: the k distinct
// controls' bits above M (control - M), ascending, 8 bits each.
extern "C" int qc_camodc_permute_f32(void* re, void* im, void* cases, int64_t ntab, int64_t n, int64_t M, int64_t k,
                                     int64_t positions, void* stream) {
  return launch_permute<4>(re, im, cases, ntab, n, M, k, positions, stream);
}

extern "C" int qc_camodc_permute_f64(void* re, void* im, void* cases, int64_t ntab, int64_t n, int64_t M, int64_t k,
                                     int64_t positions, void* stream) {
  return launch_permute<8>(re, im, cases, ntab, n, M, k, positions, stream);
}

extern "C" int qc_camodc_permute_bf16(void* re, void* im, void* cases, int64_t ntab, int64_t n, int64_t M, int64_t k,
                                      int64_t positions, void* stream) {
  return launch_permute<2>(re, im, cases, ntab, n, M, k, positions, stream);
}
