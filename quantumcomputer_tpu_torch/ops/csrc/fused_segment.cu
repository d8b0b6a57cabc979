// Fused gate segment on a planar state vector, for Hopper (sm_90a): the
// entry points of the instances without matrix groups (the kernel, its
// design and its descriptor are in fused_segment.cuh; the matrix-group
// instances in fused_matmul.cu).

#include "fused_segment.cuh"

namespace {

// The instance for the register group form (vb, ne): the main form, or an
// edge form of a state with few tile bits.  S: the storage type, T: the
// compute type.
template <typename S, typename T, bool PERM>
int dispatch(int64_t vb, int64_t ne, void* re, void* im, const void* ops_i, const void* ops_f, const void* groups,
             int64_t ngroups, const void* ftab, const void* ptab, int64_t nops, const Geom& g, int64_t M,
             int64_t tiles, void* stream) {
  S* r = (S*)re;
  S* i = (S*)im;
  const int ng = (int)ngroups, no = (int)nops, m = (int)M;
  constexpr int VB_MAIN = sizeof(T) == 4 ? 2 : 1;
  // The direct bf16 form holds 2^5 amplitudes a thread (fused.group_bits).
  constexpr int NE_MAIN = sizeof(T) == 4 ? (is_direct<S, T, PERM, false> ? 5 : 4) : 3;
  if (vb == VB_MAIN && ne == NE_MAIN) return launch<S, T, VB_MAIN, NE_MAIN, PERM, false>(r, i, ops_i, ops_f, groups, ng, ftab, ptab, nullptr, no, g, m, tiles, stream);
  if (vb == 0 && ne == 1) return launch<S, T, 0, 1, PERM, false>(r, i, ops_i, ops_f, groups, ng, ftab, ptab, nullptr, no, g, m, tiles, stream);
  if (vb == 0 && ne == 2) return launch<S, T, 0, 2, PERM, false>(r, i, ops_i, ops_f, groups, ng, ftab, ptab, nullptr, no, g, m, tiles, stream);
  if constexpr (NE_MAIN > 3) {
    if (vb == 0 && ne == 3) return launch<S, T, 0, 3, PERM, false>(r, i, ops_i, ops_f, groups, ng, ftab, ptab, nullptr, no, g, m, tiles, stream);
  }
  if constexpr (NE_MAIN > 4) {
    if (vb == 0 && ne == 4) return launch<S, T, 0, 4, PERM, false>(r, i, ops_i, ops_f, groups, ng, ftab, ptab, nullptr, no, g, m, tiles, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename S, typename T>
int launch_fused(void* re, void* im, const void* ops_i, const void* ops_f, const void* groups, int64_t ngroups,
                 const void* ftab, const void* ptab, int64_t nperm, int64_t nops, int64_t n, int64_t t, int64_t naxes,
                 int64_t axes_packed, int64_t M, int64_t vb, int64_t ne, void* stream) {
  if (naxes < 0 || naxes > MAX_AXES || t < 0 || t + naxes > n || n - t - naxes > 40 || t + naxes > 16 ||
      ne < 1 || ne > t + naxes || nops < 0 || ngroups < 1 || nperm < 0 ||
      (nperm > 0 && (t < M || M < 1 || t + naxes > MAX_PERM_TILE_BITS))) {
    return (int)cudaErrorInvalidValue;
  }
  Geom g;
  g.t = (int)t;
  g.k = (int)naxes;
  for (int a = 0; a < MAX_AXES; ++a) g.axes[a] = a < naxes ? (int)((axes_packed >> (8 * a)) & 0xff) : 0;
  const int64_t tiles = int64_t(1) << (n - t - naxes);
  if (nperm > 0) return dispatch<S, T, true>(vb, ne, re, im, ops_i, ops_f, groups, ngroups, ftab, ptab, nops, g, M, tiles, stream);
  return dispatch<S, T, false>(vb, ne, re, im, ops_i, ops_f, groups, ngroups, ftab, ptab, nops, g, M, tiles, stream);
}

}  // namespace

extern "C" int qc_fused_segment_f32(void* re, void* im, void* ops_i, void* ops_f, void* groups, int64_t ngroups,
                                    void* ftab, void* ptab, int64_t nperm, int64_t nops, int64_t n, int64_t t,
                                    int64_t naxes, int64_t axes_packed, int64_t M, int64_t vb, int64_t ne,
                                    void* stream) {
  return launch_fused<float, float>(re, im, ops_i, ops_f, groups, ngroups, ftab, ptab, nperm, nops, n, t, naxes,
                                    axes_packed, M, vb, ne, stream);
}

extern "C" int qc_fused_segment_f64(void* re, void* im, void* ops_i, void* ops_f, void* groups, int64_t ngroups,
                                    void* ftab, void* ptab, int64_t nperm, int64_t nops, int64_t n, int64_t t,
                                    int64_t naxes, int64_t axes_packed, int64_t M, int64_t vb, int64_t ne,
                                    void* stream) {
  return launch_fused<double, double>(re, im, ops_i, ops_f, groups, ngroups, ftab, ptab, nperm, nops, n, t, naxes,
                                      axes_packed, M, vb, ne, stream);
}

// bf16 planes, f32 ops_f and ftab (the op records in the compute type).
extern "C" int qc_fused_segment_bf16(void* re, void* im, void* ops_i, void* ops_f, void* groups, int64_t ngroups,
                                     void* ftab, void* ptab, int64_t nperm, int64_t nops, int64_t n, int64_t t,
                                     int64_t naxes, int64_t axes_packed, int64_t M, int64_t vb, int64_t ne,
                                     void* stream) {
  return launch_fused<__nv_bfloat16, float>(re, im, ops_i, ops_f, groups, ngroups, ftab, ptab, nperm, nops, n, t,
                                            naxes, axes_packed, M, vb, ne, stream);
}

extern "C" const char* qc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
