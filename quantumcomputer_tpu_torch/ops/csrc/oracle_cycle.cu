// In-place controlled modular multiply (m_high layout) along the cycles of
// its row permutation, for Hopper (sm_90a).  Two kernels share the walk:
//
//   qc_oracle_cycle_*         replaces pallas_oracle.py::_cycle_kernel: one
//                             gate, its control at any column bit;
//   qc_oracle_cycle_masked_*  replaces pallas_oracle.py::_cycle_masked_kernel:
//                             1 or 3 schedules, each for one nonzero control
//                             mask m = bit_a + 2 * bit_b of a column (a lone
//                             gate, or a fused pair of gates).
//
// Over the (rows = 2^M, rest = 2^(n-M)) row-major view of each plane
// (element (j, col) at j * rest + col), a column whose control mask is m
// has its rows permuted, x[j] <- x[ginv_m[j]], and a column of mask 0 is
// never touched.  The permutation acts on the rows of one column, so
// distinct columns are independent: a thread owns one column of one plane,
// and the kernel enumerates only the columns of nonzero mask (the mask bits
// are inserted into the thread index), so a GPU thread never reads a column
// it does not move.  Neighbouring threads take neighbouring columns of one
// mask, so a warp reads and writes consecutive elements of a row.  The TPU
// kernels could not skip the control-0 columns below their slab width; the
// per-column walk can, at any control position.
//
// In place, one column's walk must read every row before it writes it.  The
// schedule (ops/oracle.py, cycle_schedule; int32 (3, rows): out_row,
// src_row, kind) orders the rows along the permutation's cycles:
//   kind 0  chain step:  x[out] <- x[src], and src is the next step's out;
//   kind 1  cycle head:  as kind 0, but out (the head row) is also the
//           source of the cycle's closing step;
//   kind 2  fixed point: nothing moves;
//   kind 3  closing:     x[out] <- the head row's original value.
// The TPU kernel keeps the head's original value in a scratch slot.  Here
// the head's own write is deferred to the closing step instead: the head
// row then still holds its original value when the closing step reads it,
// so every step reads exactly one row, from device memory, and every row
// is read once and written once (1R + 1W of the moved columns).
//
// What bounds it: device-memory latency first.  A step is one load and one
// store per column, and a column's steps run in order.  But no load depends
// on an earlier step's store: step t reads row src[t] = out[t+1], which is
// first written at step t+1 (the head row at the closing step itself, after
// its read).  So a thread starts the loads of DEPTH steps before it stores
// any of them, and DEPTH loads are in flight per thread.  The schedule is
// staged through shared memory STAGE steps at a time; every thread of a
// block walks the same schedule.  Measured on the H100 at n = 28: depth 32
// is 9% faster than 16; issuing the next batch's loads before this batch's
// stores, and 16-byte vectors per thread, were both slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;
constexpr int STAGE = 1024;  // schedule steps staged in shared memory at a time
constexpr int DEPTH = 32;    // steps whose loads are in flight per thread
constexpr int KIND_HEAD = 1;
constexpr int KIND_SELF = 2;
constexpr int KIND_CLOSE = 3;

// x with a bit of value `bit` inserted at position p (bits >= p shift up).
__device__ __forceinline__ int64_t insert_bit(int64_t x, int p, int64_t bit) {
  const int64_t low = x & ((int64_t(1) << p) - 1);
  return ((x >> p) << (p + 1)) | (bit << p) | low;
}

// Column bits inserted into a thread's index: mask bit sel[i] of m at
// column bit pos[i], positions ascending.
struct Insert {
  int nbits;
  int pos[2];
  int sel[2];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
cycle_walk_kernel(T* re, T* im, const int32_t* __restrict__ sched, int64_t rows, int log_rest,
                  Insert ins) {
  __shared__ int32_t s_out[STAGE];
  __shared__ int32_t s_src[STAGE];
  __shared__ int32_t s_kind[STAGE];
  const int m = (int)blockIdx.z + 1;  // this block's control mask
  const int32_t* sc = sched + (int64_t)blockIdx.z * 3 * rows;
  T* x = blockIdx.y ? im : re;
  const int64_t rest = int64_t(1) << log_rest;
  const int64_t v = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const bool active = v < (rest >> ins.nbits);
  int64_t col = v;
  for (int b = 0; b < ins.nbits; ++b) col = insert_bit(col, ins.pos[b], (m >> ins.sel[b]) & 1);

  T pending = T(0);
  int64_t pending_row = 0;
  for (int64_t t0 = 0; t0 < rows; t0 += STAGE) {
    const int steps = (int)(rows - t0 < STAGE ? rows - t0 : STAGE);
    __syncthreads();  // the previous stage is no longer read
    for (int s = threadIdx.x; s < steps; s += THREADS) {
      s_out[s] = sc[t0 + s];
      s_src[s] = sc[rows + t0 + s];
      s_kind[s] = sc[2 * rows + t0 + s];
    }
    __syncthreads();
    if (!active) continue;
    for (int k0 = 0; k0 < steps; k0 += DEPTH) {
      T val[DEPTH];
#pragma unroll
      for (int k = 0; k < DEPTH; ++k) {
        const int s = k0 + k;
        if (s < steps && s_kind[s] != KIND_SELF) {
          val[k] = x[(int64_t)s_src[s] * rest + col];
        }
      }
#pragma unroll
      for (int k = 0; k < DEPTH; ++k) {
        const int s = k0 + k;
        if (s >= steps) break;
        const int kind = s_kind[s];
        if (kind == KIND_SELF) continue;
        if (kind == KIND_HEAD) {
          pending = val[k];
          pending_row = s_out[s];
          continue;
        }
        x[(int64_t)s_out[s] * rest + col] = val[k];
        if (kind == KIND_CLOSE) x[pending_row * rest + col] = pending;
      }
    }
  }
}

template <typename T>
int launch_walk(void* re, void* im, const void* sched, int64_t nmasks, int64_t log_rows,
                int64_t log_rest, const Insert& ins, void* stream) {
  if (log_rows < 0 || log_rows > 30 || log_rest < ins.nbits || log_rows + log_rest > 40) {
    return (int)cudaErrorInvalidValue;
  }
  for (int b = 0; b < ins.nbits; ++b) {
    if (ins.pos[b] < 0 || ins.pos[b] >= log_rest) return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = ((int64_t(1) << (log_rest - ins.nbits)) + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)blocks, 2, (unsigned int)nmasks);
  cycle_walk_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (T*)re, (T*)im, (const int32_t*)sched, int64_t(1) << log_rows, (int)log_rest, ins);
  return (int)cudaGetLastError();
}

// One gate: the control bit c_phys set (mask 1), one schedule.
template <typename T>
int cycle(void* re, void* im, const void* sched, int64_t log_rows, int64_t log_rest,
          int64_t c_phys, void* stream) {
  const Insert ins{1, {(int)c_phys, 0}, {0, 0}};
  return launch_walk<T>(re, im, sched, 1, log_rows, log_rest, ins, stream);
}

// nmasks == 1: one gate on control pos_a (pos_b unused); nmasks == 3: a
// pair, schedule m - 1 for the columns with bit_a + 2 * bit_b == m.
template <typename T>
int cycle_masked(void* re, void* im, const void* sched, int64_t nmasks, int64_t log_rows,
                 int64_t log_rest, int64_t pos_a, int64_t pos_b, void* stream) {
  Insert ins{1, {(int)pos_a, 0}, {0, 0}};
  if (nmasks == 3) {
    if (pos_a == pos_b) return (int)cudaErrorInvalidValue;
    ins.nbits = 2;
    if (pos_a < pos_b) {
      ins.pos[0] = (int)pos_a; ins.sel[0] = 0; ins.pos[1] = (int)pos_b; ins.sel[1] = 1;
    } else {
      ins.pos[0] = (int)pos_b; ins.sel[0] = 1; ins.pos[1] = (int)pos_a; ins.sel[1] = 0;
    }
  } else if (nmasks != 1) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_walk<T>(re, im, sched, nmasks, log_rows, log_rest, ins, stream);
}

}  // namespace

// sched: int32 (3, 2^log_rows) on the device.
extern "C" int qc_oracle_cycle_f32(void* re, void* im, void* sched, int64_t log_rows,
                                   int64_t log_rest, int64_t c_phys, void* stream) {
  return cycle<float>(re, im, sched, log_rows, log_rest, c_phys, stream);
}

extern "C" int qc_oracle_cycle_f64(void* re, void* im, void* sched, int64_t log_rows,
                                   int64_t log_rest, int64_t c_phys, void* stream) {
  return cycle<double>(re, im, sched, log_rows, log_rest, c_phys, stream);
}

// sched: int32 (nmasks, 3, 2^log_rows) on the device.
extern "C" int qc_oracle_cycle_masked_f32(void* re, void* im, void* sched, int64_t nmasks,
                                          int64_t log_rows, int64_t log_rest, int64_t pos_a,
                                          int64_t pos_b, void* stream) {
  return cycle_masked<float>(re, im, sched, nmasks, log_rows, log_rest, pos_a, pos_b, stream);
}

extern "C" int qc_oracle_cycle_masked_f64(void* re, void* im, void* sched, int64_t nmasks,
                                          int64_t log_rows, int64_t log_rest, int64_t pos_a,
                                          int64_t pos_b, void* stream) {
  return cycle_masked<double>(re, im, sched, nmasks, log_rows, log_rest, pos_a, pos_b, stream);
}
