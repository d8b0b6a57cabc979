// Transposes of the structured stride permutation (ops/transpose.py).
//
// 1. The padded tile transpose (qc_transpose_*).  Replaces
// quantumcomputer_tpu/ops/pallas_transpose.py:_tr_kernel, reached
// through tiled_transpose_padded with (128, 128) blocks from
// ops/modperm.py:_tr.  Contract, as there:
//
//   x (B, R, Cc) -> out (B, Cp + extra_rows, Rp),  Rp/Cp = R/Cc rounded up
//   to multiples of 128;  out[b, c, r] = x[b, r, c] for r < R, c < Cc, and
//   0 on the rest of the first Cp rows.  The extra rows are not written.
//
// The permutation's old legs index the output with its padded row pitch
// Rp, so the shape is part of the contract.  Bound: bytes (one read and one
// write of the array, no arithmetic).  Design: the textbook shared-memory
// transpose; a 32 x 33 tile (one padding column against bank conflicts),
// 32 x 8 threads, each reading 4 rows of the tile along the input's
// contiguous axis and writing 4 rows along the output's, so both sides are
// coalesced.  The kernel writes the zero padding itself: the TPU path pays
// a full pad copy of the input when R or Cc is ragged, this one reads the
// input once whatever its shape.  All offsets are 64-bit.  The tiles of one
// plane are flattened onto grid.x (tall or wide views exceed grid.y's
// 65535), the batch is on grid.z.  bf16 ("complex32") planes move as 2-byte
// elements (qc_transpose_bf16), exactly.
//
// 2. The offset transpose (qc_offset_transpose_*): one leg of the
// structured stride permutation in one pass.  It replaces no single TPU
// kernel: it fuses the passes that pallas_transpose._tr_kernel and
// pallas_chunkgather._gather_kernel make for one leg in the JAX package
// (row gathers, a padded transpose, a row compaction, and for eps = -1 a
// flip and a concatenation).  With m * R = 1 (mod C), on a plane of dim
// elements, for 0 <= t < R and f = q * R + t < C:
//
//   collect (LEG 0):  out[f] = x[r(t, q)]
//   deal    (LEG 1):  out[r(t, q)] = x[f]
//   r(t, q) = SIGN * (m * t + q) mod C,   SIGN = +1 or -1
//
// and out[j] = x[j] for C <= j < dim.  r(t, q) = SIGN * m * f (mod C), so
// either leg is a permutation of [0, C): collect with (m, R) = (v^-1, v)
// is F_{SIGN v^-1}, deal with (u^-1, u) is F_{SIGN u}, and (1, 1) with
// SIGN -1 is the reversal F_-1 alone (F_k(x)[j] = x[(k j) mod C]).  In the
// (q, t) matrix both sides are contiguous: the flat side is row q's run
// [q R, q R + R), the run side is column t's run of Q = ceil(C / R)
// indices from (SIGN m t) mod C, forwards (SIGN +1) or backwards, wrapping
// past C at most once.  So a leg is a transpose whose input (collect) or
// output (deal) rows start at offsets computed from the row index.
//
// Bound: bytes, one read and one write of the plane a leg.  The rational
// split a^-1 = eps u v^-1 (mod C) needs both legs where u, v > 1: each leg
// is a transpose in its own (q, t) factorization, and a tile that is
// contiguous in both factorizations at once does not exist, so two passes
// are this factorization's floor.  Design: an NT x NQ tile (t by q) in
// shared memory, its rows padded to an odd count of 4-byte words against
// bank conflicts, 32 x RY threads; each side of the tile is runs of
// contiguous elements with neighbouring lanes on neighbouring addresses
// (backwards on the run side for SIGN -1): NT runs of NQ on the run side,
// NQ runs of NT on the flat side.  The run side, scattered over the plane,
// gets the longer runs (NQ >= NT).  Run starts are arbitrary element
// offsets, so a run may touch one 32-byte sector more than its bytes need,
// which the tile next to it reads or writes too, through L2 if it comes
// soon enough: tiles are on grid.x with t fastest in the collect leg, so
// neighbouring blocks continue each other's flat runs, and in chunks of WT
// t-tiles in the deal leg (t minor, then q), so a column's next q-tile is
// written WT blocks later, before its partly written sectors leave L2.
// TMA's 16-byte alignment rule does not hold here, hence plain coalesced
// loads and stores, every element of a phase loaded into registers before
// any is stored.  A bf16 element is two bytes, so the bound leaves half
// the time an element of float32 and the instructions an element matter:
// each tile first tabulates in shared memory, per column t (in 64-bit
// arithmetic), the run index of its first q and its count of live q (the
// ragged last row f >= C), and an element's index is then one add and one
// conditional wrap; in-plane
// offsets are 32-bit (C < 2^30, the planner's own bound), plane and tail
// offsets 64-bit.  Blocks past the tiles copy the identity tail [C, dim) in
// the same launch; planes are on grid.z.  R = 1 (the reversal alone, or the
// identity) is one column, which a tile would fill one lane in NT, so it
// launches its own overload, transpose_kernel<T, SIGN>: out[j] =
// x[(SIGN j) mod C] over [0, dim), a straight copy read backwards for
// SIGN -1, in small blocks with no shared memory, so that many are resident
// on an SM (the tile kernel's f32 instances hold one).  float32, float64 and
// bf16 (2-byte moves, exact) share the algorithm; the tile shape and order
// per dtype and leg (LegTile) are the fastest measured on an H100 over the
// semiclassical cell's legs at M = 30.

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

// The offset transpose (section 2 of the note above).
// NQ: run-side length, NT: flat-side length, RY: thread rows; WT: 0 puts the
// tiles in t-fastest order, WT > 0 in chunks of WT t-tiles (t minor, then q,
// then the chunk), which keeps the deal leg's written runs close in time.
template <typename T, int LEG> struct LegTile;
template <> struct LegTile<float, 0> { static constexpr int NQ = 256, NT = 128, RY = 16, WT = 0; };
template <> struct LegTile<float, 1> { static constexpr int NQ = 256, NT = 128, RY = 16, WT = 16; };
template <> struct LegTile<uint16_t, 0> { static constexpr int NQ = 128, NT = 128, RY = 16, WT = 0; };
template <> struct LegTile<uint16_t, 1> { static constexpr int NQ = 256, NT = 64, RY = 8, WT = 16; };
template <int LEG> struct LegTile<double, LEG> { static constexpr int NQ = 64, NT = 64, RY = 8, WT = 0; };

struct OffsetLeg {
  int64_t C;        // the permuted range is [0, C), C < 2^30
  int64_t R;        // flat-side row length: f = q * R + t
  int64_t m;        // column t's run starts at (SIGN * m * t) mod C
  int64_t Q;        // rows: ceil(C / R)
  int64_t dim;      // plane length; [C, dim) is copied as it is
  int64_t tiles_t;  // tiles across t
  int64_t tiles_q;  // tiles across q
  int64_t tiles;    // tiles of the (q, t) matrix; blocks past them copy the tail
};

template <typename T, int LEG, int SIGN>
__global__ void __launch_bounds__(TILE * LegTile<T, LEG>::RY)
transpose_kernel(const T* __restrict__ x, T* __restrict__ out, const OffsetLeg p) {
  constexpr int NQ = LegTile<T, LEG>::NQ, NT = LegTile<T, LEG>::NT, RY = LegTile<T, LEG>::RY, WT = LegTile<T, LEG>::WT;
  constexpr int THREADS = TILE * RY;
  constexpr int PAD = sizeof(T) < 4 ? 4 / sizeof(T) : 1;
  constexpr int RUN_Y = NT / RY, RUN_X = NQ / TILE, FLAT_Y = NQ / RY, FLAT_X = NT / TILE;
  static_assert(NQ % TILE == 0 && NT % TILE == 0 && NT <= THREADS && RUN_Y * RUN_X == FLAT_Y * FLAT_X, "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  T (*tile)[NQ + PAD] = reinterpret_cast<T (*)[NQ + PAD]>(smem);  // [t - t0][q - q0]
  __shared__ int base[NT];  // r(t0 + i, q0)
  __shared__ int live[NT];  // column t0 + i's live q - q0: [0, live)
  const int64_t plane = static_cast<int64_t>(blockIdx.z) * p.dim;
  const T* xb = x + plane;
  T* ob = out + plane;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int lin = ty * TILE + tx;
  const int64_t bid = blockIdx.x;

  if (bid >= p.tiles) {  // the identity tail [C, dim)
    constexpr int PER = NQ * NT / THREADS;
    const int64_t j0 = p.C + (bid - p.tiles) * NQ * NT + lin;
    T val[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int64_t j = j0 + static_cast<int64_t>(e) * THREADS;
      val[e] = j < p.dim ? xb[j] : T(0);
    }
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int64_t j = j0 + static_cast<int64_t>(e) * THREADS;
      if (j < p.dim) ob[j] = val[e];
    }
    return;
  }

  const int C = static_cast<int>(p.C), R = static_cast<int>(p.R), Q = static_cast<int>(p.Q);
  int64_t tt = bid % p.tiles_t, tq = bid / p.tiles_t;
  if (WT > 0) {
    const int64_t chunk = bid / (WT * p.tiles_q), within = bid % (WT * p.tiles_q);
    const int64_t width = p.tiles_t - chunk * WT < WT ? p.tiles_t - chunk * WT : WT;
    tt = chunk * WT + within % width;
    tq = within / width;
  }
  const int t0 = static_cast<int>(tt) * NT;
  const int q0 = static_cast<int>(tq) * NQ;
  if (lin < NT) {
    const int t = t0 + lin;
    int b = 0, n = 0;
    if (t < R) {
      const int64_t v = ((p.m * t) % p.C + q0) % p.C;  // (m t + q0) mod C
      b = static_cast<int>(SIGN > 0 || v == 0 ? v : p.C - v);
      const int qmax = t < C - (Q - 1) * R ? Q : Q - 1;  // live q of column t: q R + t < C
      n = min(max(qmax - q0, 0), NQ);
    }
    base[lin] = b;
    live[lin] = n;
  }
  __syncthreads();

  // r(t0 + i, q0 + k): one add, one conditional wrap past C.
  auto run = [&](int i, int k) {
    int r = base[i] + SIGN * k;
    if (SIGN > 0) {
      if (r >= C) r -= C;
    } else {
      if (r < 0) r += C;
    }
    return r;
  };

  // Phase 1 reads the source side into registers, then into the tile;
  // phase 2 writes the other side from the tile.  The run side: rows t
  // (i = t - t0), lanes along q (k = q - q0).  The flat side: rows q, lanes
  // along t, with q R replaced by C past the last row (no live element).
  T val[RUN_Y * RUN_X];
  if (LEG == 0) {
#pragma unroll
    for (int a = 0; a < RUN_Y; ++a) {
      const int i = ty + a * RY, n = live[i];
#pragma unroll
      for (int c = 0; c < RUN_X; ++c) {
        const int k = tx + c * TILE;
        val[a * RUN_X + c] = k < n ? xb[run(i, k)] : T(0);
      }
    }
#pragma unroll
    for (int a = 0; a < RUN_Y; ++a) {
#pragma unroll
      for (int c = 0; c < RUN_X; ++c) tile[ty + a * RY][tx + c * TILE] = val[a * RUN_X + c];
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < FLAT_Y; ++a) {
      const int k = ty + a * RY, q = q0 + k, qR = q < Q ? q * R : C;
#pragma unroll
      for (int c = 0; c < FLAT_X; ++c) {
        const int i = tx + c * TILE, t = t0 + i, f = qR + t;
        if (t < R && f < C) ob[f] = tile[i][k];
      }
    }
  } else {
#pragma unroll
    for (int a = 0; a < FLAT_Y; ++a) {
      const int k = ty + a * RY, q = q0 + k, qR = q < Q ? q * R : C;
#pragma unroll
      for (int c = 0; c < FLAT_X; ++c) {
        const int i = tx + c * TILE, t = t0 + i, f = qR + t;
        val[a * FLAT_X + c] = t < R && f < C ? xb[f] : T(0);
      }
    }
#pragma unroll
    for (int a = 0; a < FLAT_Y; ++a) {
#pragma unroll
      for (int c = 0; c < FLAT_X; ++c) tile[tx + c * TILE][ty + a * RY] = val[a * FLAT_X + c];
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < RUN_Y; ++a) {
      const int i = ty + a * RY, n = live[i];
#pragma unroll
      for (int c = 0; c < RUN_X; ++c) {
        const int k = tx + c * TILE;
        if (k < n) ob[run(i, k)] = tile[i][k];
      }
    }
  }
}

// R = 1: out[j] = x[(SIGN j) mod C] for j < C, x[j] above, on either leg.
constexpr int COPY_THREADS = 256, COPY_PER = 8;

template <typename T, int SIGN>
__global__ void __launch_bounds__(COPY_THREADS)
transpose_kernel(const T* __restrict__ x, T* __restrict__ out, const int64_t C, const int64_t dim) {
  const int64_t plane = static_cast<int64_t>(blockIdx.z) * dim;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * COPY_THREADS * COPY_PER + threadIdx.x;
  T val[COPY_PER];
#pragma unroll
  for (int e = 0; e < COPY_PER; ++e) {
    const int64_t j = j0 + e * COPY_THREADS;
    val[e] = j < dim ? x[plane + (SIGN < 0 && j > 0 && j < C ? C - j : j)] : T(0);
  }
#pragma unroll
  for (int e = 0; e < COPY_PER; ++e) {
    const int64_t j = j0 + e * COPY_THREADS;
    if (j < dim) out[plane + j] = val[e];
  }
}

template <typename T>
int launch_column(const T* x, T* out, int64_t B, int64_t dim, int64_t C, int64_t sign, cudaStream_t stream) {
  const int64_t blocks = (dim + COPY_THREADS * COPY_PER - 1) / (COPY_THREADS * COPY_PER);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks), 1, static_cast<unsigned>(B));
  if (sign > 0) {
    transpose_kernel<T, 1><<<grid, COPY_THREADS, 0, stream>>>(x, out, C, dim);
  } else {
    transpose_kernel<T, -1><<<grid, COPY_THREADS, 0, stream>>>(x, out, C, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int LEG, int SIGN>
int launch_kernel(const T* x, T* out, const OffsetLeg& p, int64_t blocks, int64_t B, cudaStream_t stream) {
  using Tile = LegTile<T, LEG>;
  constexpr int PAD = sizeof(T) < 4 ? 4 / sizeof(T) : 1;
  constexpr int smem = Tile::NT * (Tile::NQ + PAD) * static_cast<int>(sizeof(T));
  auto kern = transpose_kernel<T, LEG, SIGN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(static_cast<unsigned>(blocks), 1, static_cast<unsigned>(B)), dim3(TILE, Tile::RY), smem, stream>>>(x, out, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int LEG>
int launch_leg(const void* x, void* out, int64_t B, int64_t dim, int64_t C, int64_t R, int64_t m, int64_t sign,
               void* stream) {
  using Tile = LegTile<T, LEG>;
  const int64_t Q = (C + R - 1) / R;
  const int64_t tiles_t = (R + Tile::NT - 1) / Tile::NT;
  const int64_t tiles_q = (Q + Tile::NQ - 1) / Tile::NQ;
  const int64_t per = static_cast<int64_t>(Tile::NQ) * Tile::NT;
  const int64_t blocks = tiles_t * tiles_q + (dim - C + per - 1) / per;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const OffsetLeg p{C, R, m, Q, dim, tiles_t, tiles_q, tiles_t * tiles_q};
  const T* xs = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sign > 0 ? launch_kernel<T, LEG, 1>(xs, o, p, blocks, B, s) : launch_kernel<T, LEG, -1>(xs, o, p, blocks, B, s);
}

template <typename T>
int launch_offset(const void* x, void* out, int64_t B, int64_t dim, int64_t C, int64_t R, int64_t m, int64_t sign,
                  int64_t leg, void* stream) {
  // In-plane offsets are 32-bit (C < 2^30); m * R = 1 (mod C) makes a leg a permutation.
  if (B <= 0 || B > 65535 || C <= 0 || C > dim || C >= (1LL << 30) || R <= 0 || R > C || m < 0 || m >= C ||
      (sign != 1 && sign != -1) || (leg != 0 && leg != 1) || (m * R) % C != 1 % C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 1) {
    return launch_column<T>(static_cast<const T*>(x), static_cast<T*>(out), B, dim, C, sign,
                            static_cast<cudaStream_t>(stream));
  }
  return leg == 0 ? launch_leg<T, 0>(x, out, B, dim, C, R, m, sign, stream)
                  : launch_leg<T, 1>(x, out, B, dim, C, R, m, sign, stream);
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

// x, out, B, dim, C, R, m, sign, leg (0 collect, 1 deal), stream
extern "C" int qc_offset_transpose_f32(const void* x, void* out, int64_t B, int64_t dim, int64_t C, int64_t R,
                                       int64_t m, int64_t sign, int64_t leg, void* stream) {
  return launch_offset<float>(x, out, B, dim, C, R, m, sign, leg, stream);
}

extern "C" int qc_offset_transpose_f64(const void* x, void* out, int64_t B, int64_t dim, int64_t C, int64_t R,
                                       int64_t m, int64_t sign, int64_t leg, void* stream) {
  return launch_offset<double>(x, out, B, dim, C, R, m, sign, leg, stream);
}

extern "C" int qc_offset_transpose_bf16(const void* x, void* out, int64_t B, int64_t dim, int64_t C, int64_t R,
                                        int64_t m, int64_t sign, int64_t leg, void* stream) {
  return launch_offset<uint16_t>(x, out, B, dim, C, R, m, sign, leg, stream);
}
