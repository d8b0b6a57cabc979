// Fused gate segment with matrix groups, for Hopper (sm_90a): the instances
// of fused_segment.cuh's kernel that run the lanemat / rowmat / xtable ops
// (the TPU kernel's MXU branches, pallas_fused.py:911-966, built by
// matmul_group_ops, pallas_fused.py:315-410) on the tensor cores beside the
// register groups of the other ops.  A source of its own: these instances
// compile in parallel with fused_segment.cu's, and the instances without
// matrix groups keep their code generation.
//
// What bounds it: bytes (one read and one write of the state, 1.282 ms for
// a 2 GiB complex64 state at 3.35 TB/s, 0.641 ms at bf16) or the tensor
// cores: at float32 each real product is three TF32 products (3xTF32) at
// 495 TFLOP/s, 128 (lanemat) or 64 (rowmat) multiply-adds an amplitude, so a
// complex 128 x 128 lanemat alone needs 1.67 ms over 2^28 amplitudes, more
// than the bytes; at bf16 two bf16 products at 989 TFLOP/s.  A matrix
// segment's tile is 2^13 amplitudes (64 KB at float32, two ring slots fill
// 128 KB: one block an SM of 256 threads, up to 255 registers a thread).
// mma.sync, not wgmma, and tables read through L1 rather than staged: the
// first port, correct and simple (PERF.md has its times).
//
// Entry points: those of fused_segment.cu with mtab (the tables, byte
// offsets in the op records) before the stream; float32 and bf16 planes
// only (float64 segments never group), the main register form (vb = 2,
// ne = 4), no camodc op, a 13-bit tile with t >= 7.

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
