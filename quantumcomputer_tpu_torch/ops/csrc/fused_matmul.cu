// Fused gate segment with matrix groups, for Hopper (sm_90a): the instances
// (MAT) of fused_segment.cuh's kernel that run the lanemat / rowmat / xtable
// ops beside the register groups of the other ops.  Replaces the TPU
// kernel's MXU branches, quantumcomputer_tpu/ops/pallas_fused.py:911-966
// (_fused_kernel, with mxu_dot at :594-609; the grouping, matmul_group_ops,
// at :315-410).  A source of its own: these instances compile in parallel
// with fused_segment.cu's, and the instances without matrix groups keep
// their code generation.
//
// What bounds it: bytes (one read and one write of the state, 1.282 ms for
// a 2 GiB complex64 state at 3.35 TB/s, 0.641 ms at bf16) or the tensor
// cores: at float32 each real product is three TF32 products (3xTF32) at
// 495 TFLOP/s, 128 (lanemat) or 64 (rowmat) multiply-adds an amplitude, so
// the m_high iQFT segment (complex rowmat + xtable + lanemat) needs 2.50 ms
// over 2^28 amplitudes, more than its bytes; at bf16 two bf16 products at
// 989 TFLOP/s, 0.83 ms.  That is about 10 us (f32) or 3.4 us (bf16) of
// tensor-core time for one 2^13-amplitude tile on one SM.
//
// Design (fused_segment.cuh, "Matrix groups", has the details):
//   * wgmma.mma_async m64n64k8 .tf32 / m64n64k16 .bf16: the tile's 64 rows
//     are one wgmma M; warpgroup wg computes its 64 of the 128 output lanes
//     of a lanemat, and its 64 lanes of a rowmat computed transposed
//     (Y^T = X^T V^T), so each warpgroup reads the activations once an op
//     (half the tile for a rowmat) and converts each element once.
//   * Tables prepared once a segment on the host (ops/fused.py,
//     matrix_tables): TF32 hi / lo pre-split at f32, bf16 hi / lo at bf16,
//     K-major in the descriptor's core-matrix layout, K permuted to match
//     16-byte activation loads, in 16 KB chunks; the xtable in the order
//     each thread applies it.  They stream through a ring of four 16 KB
//     stages in shared memory by bulk asynchronous copies (cp.async.bulk,
//     mbarrier completion) that one thread issues two chunks ahead of the
//     products.
//   * Each k-step's products are asynchronous; the next k-step's activation
//     conversion overlaps them.  The accumulators go back into the tile once
//     an op, and an xtable right after a rowmat is applied to the rowmat's
//     accumulators before that store (one tile pass and one sync fewer).
//
// Shared memory (227 KB a block, one block of 256 threads an SM): f32, the
// two-slot tile ring (2 x 64 KB); bf16, the 32 KB staging slot and the
// 64 KB f32 work tile; then the op records, the table ring and its
// mbarriers.  Up to 6 (f32) or 8 (bf16) 16 KB table stages fit; the ring
// takes 4 (MAT_STAGES): 3 and 4 measured within 1% of each other, all that
// fit 3-4% slower, and every thread's 16-byte cp.async in place of the one
// bulk copy 3-6% slower (PERF.md).  Table bytes read from L2 a tile: the iQFT segment's 224 KB at
// bf16 (rowmat 32, xtable 64, lanemat 128) and 384 KB at f32 (64, 64, 256);
// the tables stay in L2.
//
// Entry points: those of fused_segment.cu with mtab (the packed tables)
// before the stream; float32 and bf16 planes only (float64 segments never group),
// the main register form (vb = 2, ne = 4), no camodc op, a 13-bit tile with
// t >= 7.

#include "fused_segment.cuh"

namespace {

template <typename S>
int launch_matmul(void* re, void* im, const void* ops_i, const void* ops_f, const void* groups, int64_t ngroups,
                  const void* ftab, const void* ptab, int64_t nperm, int64_t nops, int64_t n, int64_t t,
                  int64_t naxes, int64_t axes_packed, int64_t M, int64_t vb, int64_t ne, const void* mtab,
                  void* stream) {
  if (naxes < 0 || naxes > MAX_AXES || t < 7 || t + naxes != MAX_PERM_TILE_BITS || n - t - naxes > 40 ||
      vb != 2 || ne != 4 || nops < 1 || ngroups < 1 || nperm != 0 || mtab == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  Geom g;
  g.t = (int)t;
  g.k = (int)naxes;
  for (int a = 0; a < MAX_AXES; ++a) g.axes[a] = a < naxes ? (int)((axes_packed >> (8 * a)) & 0xff) : 0;
  const int64_t tiles = int64_t(1) << (n - t - naxes);
  return launch<S, float, 2, 4, false, true>((S*)re, (S*)im, ops_i, ops_f, groups, (int)ngroups, ftab, ptab, mtab,
                                             (int)nops, g, (int)M, tiles, stream);
}

}  // namespace

extern "C" int qc_fused_matmul_f32(void* re, void* im, void* ops_i, void* ops_f, void* groups, int64_t ngroups,
                                   void* ftab, void* ptab, int64_t nperm, int64_t nops, int64_t n, int64_t t,
                                   int64_t naxes, int64_t axes_packed, int64_t M, int64_t vb, int64_t ne, void* mtab,
                                   void* stream) {
  return launch_matmul<float>(re, im, ops_i, ops_f, groups, ngroups, ftab, ptab, nperm, nops, n, t, naxes,
                              axes_packed, M, vb, ne, mtab, stream);
}

// bf16 planes: f32 ops_f and ftab, bf16 hi/lo product tables, f32 xtables.
extern "C" int qc_fused_matmul_bf16(void* re, void* im, void* ops_i, void* ops_f, void* groups, int64_t ngroups,
                                    void* ftab, void* ptab, int64_t nperm, int64_t nops, int64_t n, int64_t t,
                                    int64_t naxes, int64_t axes_packed, int64_t M, int64_t vb, int64_t ne,
                                    void* mtab, void* stream) {
  return launch_matmul<__nv_bfloat16>(re, im, ops_i, ops_f, groups, ngroups, ftab, ptab, nperm, nops, n, t, naxes,
                                      axes_packed, M, vb, ne, mtab, stream);
}
