// Tiled transpose of the structured stride permutation (ops/transpose.py).
//
// Replaces quantumcomputer_tpu/ops/pallas_transpose.py:_tr_kernel, reached
// through tiled_transpose_padded with (128, 128) blocks from
// ops/modperm.py:_tr.  Contract, as there:
//
//   x (B, R, Cc) -> out (B, Cp + extra_rows, Rp),  Rp/Cp = R/Cc rounded up
//   to multiples of 128;  out[b, c, r] = x[b, r, c] for r < R, c < Cc, and
//   0 on the rest of the first Cp rows.  The extra rows are not written.
//
// The permutation legs index the output with its padded row pitch Rp, so
// the shape is part of the contract.  Bound: bytes (one read and one write
// of the array, no arithmetic).  Design: the textbook shared-memory
// transpose; a 32 x 33 tile (one padding column against bank conflicts),
// 32 x 8 threads, each reading 4 rows of the tile along the input's
// contiguous axis and writing 4 rows along the output's, so both sides are
// coalesced.  The kernel writes the zero padding itself: the TPU path pays
// a full pad copy of the input when R or Cc is ragged, this one reads the
// input once whatever its shape.  All offsets are 64-bit.  The tiles of one
// plane are flattened onto grid.x (tall or wide views exceed grid.y's
// 65535), the batch is on grid.z.  bf16 ("complex32") planes move as 2-byte
// elements (qc_transpose_bf16), exactly.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;
constexpr int64_t BLOCK = 128;

template <typename T>
__global__ void __launch_bounds__(TILE * ROWS)
transpose_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t R, int64_t Cc, int64_t Rp,
                 int64_t out_rows, int64_t tiles_r) {
  __shared__ T tile[TILE][TILE + 1];
  const int64_t t = blockIdx.x;
  const int64_t r0 = (t % tiles_r) * TILE;  // input rows = output columns
  const int64_t c0 = (t / tiles_r) * TILE;  // input columns = output rows
  const T* xb = x + static_cast<int64_t>(blockIdx.z) * R * Cc;
  T* ob = out + static_cast<int64_t>(blockIdx.z) * out_rows * Rp;
  const int tx = threadIdx.x;
  const int64_t c = c0 + tx;
#pragma unroll
  for (int i = 0; i < TILE; i += ROWS) {
    const int k = threadIdx.y + i;
    const int64_t r = r0 + k;
    tile[k][tx] = (r < R && c < Cc) ? xb[r * Cc + c] : T(0);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TILE; i += ROWS) {
    const int k = threadIdx.y + i;
    ob[(c0 + k) * Rp + r0 + tx] = tile[tx][k];
  }
}

template <typename T>
int launch(const void* x, void* out, int64_t B, int64_t R, int64_t Cc, int64_t extra_rows, void* stream) {
  if (B <= 0 || R <= 0 || Cc <= 0 || extra_rows < 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t Rp = (R + BLOCK - 1) / BLOCK * BLOCK;
  const int64_t Cp = (Cc + BLOCK - 1) / BLOCK * BLOCK;
  const int64_t tiles_r = Rp / TILE;
  const int64_t tiles = tiles_r * (Cp / TILE);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(static_cast<unsigned>(tiles), 1, static_cast<unsigned>(B));
  dim3 block(TILE, ROWS);
  transpose_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), R, Cc, Rp, Cp + extra_rows, tiles_r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qc_transpose_f32(const void* x, void* out, int64_t B, int64_t R, int64_t Cc, int64_t extra_rows,
                                void* stream) {
  return launch<float>(x, out, B, R, Cc, extra_rows, stream);
}

extern "C" int qc_transpose_f64(const void* x, void* out, int64_t B, int64_t R, int64_t Cc, int64_t extra_rows,
                                void* stream) {
  return launch<double>(x, out, B, R, Cc, extra_rows, stream);
}

extern "C" int qc_transpose_bf16(const void* x, void* out, int64_t B, int64_t R, int64_t Cc, int64_t extra_rows,
                                 void* stream) {
  return launch<uint16_t>(x, out, B, R, Cc, extra_rows, stream);
}
