// In-place controlled modular multiply (m_high layout) along the cycles of
// its row permutation, for Hopper (sm_90a).  Two entry points share the walk:
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
// never touched: the kernels enumerate only the columns of nonzero mask (the
// mask bits are inserted into the thread's column index).
//
// In place, a walk must read every row before it writes it.  The schedule
// (ops/oracle.py, cycle_schedule; int32 (3, rows): out_row, src_row, kind)
// orders the rows along the permutation's cycles:
//   kind 0  chain step:  x[out] <- x[src], and src is the next step's out;
//   kind 1  cycle head:  as kind 0, but out (the head row) is also the
//           source of the cycle's closing step;
//   kind 2  fixed point: nothing moves;
//   kind 3  closing:     x[out] <- the head row's original value.
// The head's own write is deferred to the closing step, so the head row
// still holds its original value when the closing step reads it: every row
// is read once and written once (1R + 1W of the moved columns).
//
// What bounds it: device-memory bandwidth, 1R + 1W of the moved half
// (0.641 ms for a 2 GiB complex64 state at 3.35 TB/s).  One thread a
// column walking all 2^M steps in order would give 32,768 threads at n = 28
// (12% of the card's), each step one 128-byte line a warp: too few bytes in
// flight.  So the walk is cut open along the schedule as well:
//
//   * Segments.  The schedule splits into S contiguous step ranges
//     (ops/oracle.py, walk_segments), walked concurrently.  A row is read at
//     step t and written at step t + 1 (a head row: read and written at its
//     closing step), so only two values cross a cut: the source row of a
//     segment's last step, which the next segment overwrites first, and, for
//     a cycle that closes in a segment but opened in an earlier one, the
//     value its head read.  A first, small launch copies those rows of the
//     moved columns into scratch; each segment then takes them from there,
//     and the result is x[ginv] whatever order the blocks run in.
//   * Vectors.  A thread moves V contiguous columns (16 bytes) per step when
//     every run of moved columns fills a 32-byte sector (ops/oracle.py,
//     walk_vector), so a warp moves 512 bytes of a row per step; below it,
//     one column a thread.  At bf16 ("complex32", the _bf16 entry points,
//     2-byte elements) 16 bytes are 8 columns, from control 4 up.
//     Runs shorter than a 128-byte line still cost whole sectors and lines,
//     so the walk's share of its bound falls below control 5 (f32); see
//     PERF.md.
//   * Depth.  No load depends on an earlier step's store (step t reads
//     src[t] = out[t + 1]), so a thread issues the loads of DEPTH steps
//     before their stores.  S is chosen from the shapes (ops/oracle.py) so
//     that the grid fills the card's resident threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int STAGE = 512;  // schedule steps staged in shared memory at a time
constexpr int DEPTH = 8;    // steps whose loads are in flight per thread
constexpr int KIND_HEAD = 1;
constexpr int KIND_SELF = 2;
constexpr int KIND_CLOSE = 3;
constexpr int SEG_STRIDE = 8;  // t0, t1, a_row, b_row, head_row (ops/oracle.py)
constexpr int MAX_SEGMENTS = 1 << 14;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// x with a bit of value `bit` inserted at position p (bits >= p shift up).
__device__ __forceinline__ int64_t insert_bit(int64_t x, int p, int64_t bit) {
  const int64_t low = x & ((int64_t(1) << p) - 1);
  return ((x >> p) << (p + 1)) | (bit << p) | low;
}

// Column bits inserted into an active-column index: mask bit sel[i] of m at
// column bit pos[i], positions ascending.
struct Insert {
  int nbits;
  int pos[2];
  int sel[2];
};

__device__ __forceinline__ int64_t column(int64_t v, int m, const Insert& ins) {
  for (int b = 0; b < ins.nbits; ++b) v = insert_bit(v, ins.pos[b], (m >> ins.sel[b]) & 1);
  return v;
}

// Scratch element of (segment, which row, plane, mask) at active column u.
__device__ __forceinline__ int64_t scratch_at(int sigma, int which, int plane, int mi, int nmasks, int64_t active,
                                              int64_t u) {
  return ((((int64_t)sigma * 2 + which) * 2 + plane) * nmasks + mi) * active + u;
}

// Copy each segment's cut rows (a_row, b_row) of the moved columns into
// scratch, before any segment writes.
template <typename T>
__global__ void __launch_bounds__(THREADS)
walk_preread_kernel(const T* re, const T* im, T* __restrict__ scratch, const int32_t* __restrict__ segs, int S,
                    int nmasks, int64_t active, int log_rest, Insert ins) {
  const int64_t u = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (u >= active) return;
  const int plane = blockIdx.z & 1, mi = blockIdx.z >> 1;
  const int sigma = blockIdx.y >> 1, which = blockIdx.y & 1;
  const int row = segs[((int64_t)mi * S + sigma) * SEG_STRIDE + 2 + which];
  if (row < 0) return;
  const T* x = plane ? im : re;
  scratch[scratch_at(sigma, which, plane, mi, nmasks, active, u)] =
      x[((int64_t)row << log_rest) + column(u, mi + 1, ins)];
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
cycle_walk_kernel(T* re, T* im, const int32_t* __restrict__ sched, const int32_t* __restrict__ segs,
                  const T* __restrict__ scratch, int64_t rows, int S, int nmasks, int64_t active, int log_rest,
                  Insert ins) {
  using P = Pack<T, V>;
  __shared__ int32_t s_out[STAGE];
  __shared__ int32_t s_src[STAGE];
  __shared__ int32_t s_kind[STAGE];
  const int plane = blockIdx.z & 1, mi = blockIdx.z >> 1;
  const int sigma = blockIdx.y;
  const int32_t* sc = sched + (int64_t)mi * 3 * rows;
  const int32_t* rec = segs + ((int64_t)mi * S + sigma) * SEG_STRIDE;
  const int64_t t0 = rec[0], t1 = rec[1];
  const int a_row = rec[2], b_row = rec[3];
  T* x = plane ? im : re;
  const int64_t u = ((int64_t)blockIdx.x * THREADS + threadIdx.x) * V;  // first active column of this thread
  const bool live = u < active;
  const int64_t col = column(u, mi + 1, ins);

  P pending = {};
  int64_t pending_row = rec[4];
  if (live && b_row >= 0) {
    pending = *reinterpret_cast<const P*>(scratch + scratch_at(sigma, 1, plane, mi, nmasks, active, u));
  }
  const P* cut = reinterpret_cast<const P*>(scratch + scratch_at(sigma, 0, plane, mi, nmasks, active, u));
  for (int64_t st0 = t0; st0 < t1; st0 += STAGE) {
    const int steps = (int)(t1 - st0 < STAGE ? t1 - st0 : STAGE);
    __syncthreads();  // the previous stage is no longer read
    for (int s = threadIdx.x; s < steps; s += THREADS) {
      s_out[s] = sc[st0 + s];
      s_src[s] = sc[rows + st0 + s];
      s_kind[s] = sc[2 * rows + st0 + s];
    }
    __syncthreads();
    if (!live) continue;
    const int last = (a_row >= 0 && st0 + steps == t1) ? steps - 1 : -1;  // the step whose source is in scratch
    for (int k0 = 0; k0 < steps; k0 += DEPTH) {
      P val[DEPTH];
#pragma unroll
      for (int k = 0; k < DEPTH; ++k) {
        const int s = k0 + k;
        if (s < steps && s_kind[s] != KIND_SELF) {
          val[k] = s == last ? *cut : *reinterpret_cast<const P*>(x + ((int64_t)s_src[s] << log_rest) + col);
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
        *reinterpret_cast<P*>(x + ((int64_t)s_out[s] << log_rest) + col) = val[k];
        if (kind == KIND_CLOSE) *reinterpret_cast<P*>(x + (pending_row << log_rest) + col) = pending;
      }
    }
  }
}

template <typename T>
int launch_walk(void* re, void* im, const void* sched, const void* segs, void* scratch, int64_t S,
                int64_t nmasks, int64_t log_rows, int64_t log_rest, const Insert& ins, int64_t vec, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (log_rows < 0 || log_rows > 30 || log_rest < ins.nbits || log_rows + log_rest > 40 || S < 1 ||
      S > MAX_SEGMENTS || S > (int64_t(1) << log_rows) || (vec != 1 && vec != VEC)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int b = 0; b < ins.nbits; ++b) {
    if (ins.pos[b] < 0 || ins.pos[b] >= log_rest) return (int)cudaErrorInvalidValue;
    if (vec > 1 && (int64_t(1) << ins.pos[b]) < vec) return (int)cudaErrorInvalidValue;
  }
  if (vec > 1 && ((reinterpret_cast<uintptr_t>(re) | reinterpret_cast<uintptr_t>(im) |
                   reinterpret_cast<uintptr_t>(scratch)) % 16) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t active = int64_t(1) << (log_rest - ins.nbits);
  const int64_t blocks = (active + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  walk_preread_kernel<T><<<dim3((unsigned int)blocks, (unsigned int)(2 * S), (unsigned int)(2 * nmasks)), THREADS, 0,
                           st>>>((const T*)re, (const T*)im, (T*)scratch, (const int32_t*)segs, (int)S, (int)nmasks,
                                 active, (int)log_rest, ins);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((active / vec + THREADS - 1) / THREADS), (unsigned int)S, (unsigned int)(2 * nmasks));
  const int64_t rows = int64_t(1) << log_rows;
  if (vec > 1) {
    cycle_walk_kernel<T, VEC><<<grid, THREADS, 0, st>>>((T*)re, (T*)im, (const int32_t*)sched, (const int32_t*)segs,
                                                        (const T*)scratch, rows, (int)S, (int)nmasks, active,
                                                        (int)log_rest, ins);
  } else {
    cycle_walk_kernel<T, 1><<<grid, THREADS, 0, st>>>((T*)re, (T*)im, (const int32_t*)sched, (const int32_t*)segs,
                                                      (const T*)scratch, rows, (int)S, (int)nmasks, active,
                                                      (int)log_rest, ins);
  }
  return (int)cudaGetLastError();
}

// One gate: the control bit c_phys set (mask 1), one schedule.
template <typename T>
int cycle(void* re, void* im, const void* sched, const void* segs, void* scratch, int64_t S, int64_t log_rows,
          int64_t log_rest, int64_t c_phys, int64_t vec, void* stream) {
  const Insert ins{1, {(int)c_phys, 0}, {0, 0}};
  return launch_walk<T>(re, im, sched, segs, scratch, S, 1, log_rows, log_rest, ins, vec, stream);
}

// nmasks == 1: one gate on control pos_a (pos_b unused); nmasks == 3: a
// pair, schedule m - 1 for the columns with bit_a + 2 * bit_b == m.
template <typename T>
int cycle_masked(void* re, void* im, const void* sched, const void* segs, void* scratch, int64_t S, int64_t nmasks,
                 int64_t log_rows, int64_t log_rest, int64_t pos_a, int64_t pos_b, int64_t vec, void* stream) {
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
  return launch_walk<T>(re, im, sched, segs, scratch, S, nmasks, log_rows, log_rest, ins, vec, stream);
}

}  // namespace

// sched: int32 (3, 2^log_rows); segs: int32 (S, SEG_STRIDE); scratch: 2 * S
// rows of the moved columns of both planes, on the device.
extern "C" int qc_oracle_cycle_f32(void* re, void* im, void* sched, void* segs, void* scratch, int64_t S,
                                   int64_t log_rows, int64_t log_rest, int64_t c_phys, int64_t vec, void* stream) {
  return cycle<float>(re, im, sched, segs, scratch, S, log_rows, log_rest, c_phys, vec, stream);
}

extern "C" int qc_oracle_cycle_f64(void* re, void* im, void* sched, void* segs, void* scratch, int64_t S,
                                   int64_t log_rows, int64_t log_rest, int64_t c_phys, int64_t vec, void* stream) {
  return cycle<double>(re, im, sched, segs, scratch, S, log_rows, log_rest, c_phys, vec, stream);
}

extern "C" int qc_oracle_cycle_bf16(void* re, void* im, void* sched, void* segs, void* scratch, int64_t S,
                                    int64_t log_rows, int64_t log_rest, int64_t c_phys, int64_t vec, void* stream) {
  return cycle<uint16_t>(re, im, sched, segs, scratch, S, log_rows, log_rest, c_phys, vec, stream);
}

// sched: int32 (nmasks, 3, 2^log_rows); segs: int32 (nmasks, S, SEG_STRIDE).
extern "C" int qc_oracle_cycle_masked_f32(void* re, void* im, void* sched, void* segs, void* scratch, int64_t S,
                                          int64_t nmasks, int64_t log_rows, int64_t log_rest, int64_t pos_a,
                                          int64_t pos_b, int64_t vec, void* stream) {
  return cycle_masked<float>(re, im, sched, segs, scratch, S, nmasks, log_rows, log_rest, pos_a, pos_b, vec, stream);
}

extern "C" int qc_oracle_cycle_masked_f64(void* re, void* im, void* sched, void* segs, void* scratch, int64_t S,
                                          int64_t nmasks, int64_t log_rows, int64_t log_rest, int64_t pos_a,
                                          int64_t pos_b, int64_t vec, void* stream) {
  return cycle_masked<double>(re, im, sched, segs, scratch, S, nmasks, log_rows, log_rest, pos_a, pos_b, vec,
                              stream);
}

extern "C" int qc_oracle_cycle_masked_bf16(void* re, void* im, void* sched, void* segs, void* scratch, int64_t S,
                                           int64_t nmasks, int64_t log_rows, int64_t log_rest, int64_t pos_a,
                                           int64_t pos_b, int64_t vec, void* stream) {
  return cycle_masked<uint16_t>(re, im, sched, segs, scratch, S, nmasks, log_rows, log_rest, pos_a, pos_b, vec,
                                stream);
}
