"""Row-permutation oracle kernels of the m_high layout: wrappers, plain
versions, schedules and eligibility.

The counterpart of the JAX package's ``ops/pallas_oracle.py``.  In the
m_high layout the work register is the top M physical bits, so over the
(2^M, 2^(n-M)) view of each plane a controlled modular multiply moves whole
rows of the columns whose control bit is set:
x[j, col] <- x[ginv[j], col].  Five CUDA kernels carry it:

  * ``gather`` (``csrc/oracle_gather.cu``): one gate out of place,
    ``in`` -> ``out`` (``apply_camodc_high_planar``; the JAX package's
    blocked row gather, which its dispatcher never picks either);
  * ``ladder`` (``csrc/oracle_ladder.cu``): a fused run of K <= 8 gates in
    one out-of-place gather, ``in`` -> ``out``;
  * ``cycle`` (``csrc/oracle_cycle.cu``): one gate in place, its control at
    any column bit, walking the permutation's cycles in concurrent schedule
    segments (``walk_segments``);
  * ``cycle_masked`` (the same source, its own entry point): the in-place
    walk with one schedule per nonzero control mask; a lone gate
    (``apply_camodc_high_perm_planar``) or a fused pair of gates
    (``apply_camodc_pair_inplace_planar``);
  * ``strip`` (``csrc/oracle_strip.cu``): a run of K gates in place, in one
    pass through column strips staged in shared memory
    (``apply_camodc_run_inplace_planar``; the engine sends it runs of
    adjacent cycle walks and out-of-place ladders on bf16 or float32
    planes, ``strip_run_supported``, where ``strip_pays``).

Each wrapper takes the plain version (``ops/gates.py``) for a CPU tensor,
launches its kernel for a CUDA tensor at every size, and raises for any
other device.  ``LAUNCHES`` counts kernel launches per kernel.  The ladder,
both walks, the strip pass and the row gather (which no dispatcher picks)
also take bf16 ("complex32") planes, as 2-byte elements (exact: they only
move data).

The eligibility predicates keep the JAX package's thresholds unchanged
(they come from the TPU's DMA slab sizes), so the engine plans the same
circuit rewrite and dispatch as the JAX package; retuning them for the
H100 is later work.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from quantumcomputer_tpu_torch.ops import _build
from quantumcomputer_tpu_torch.ops import gates as tops
from quantumcomputer_tpu_torch.sim import statevec as sv

#: Kernel launches per kernel (CUDA tensors only).
LAUNCHES = {"gather": 0, "ladder": 0, "cycle": 0, "cycle_masked": 0, "strip": 0}

# The JAX package's thresholds (pallas_oracle.py), in its units.
LANE = 128
ROWS_PER_BLOCK = 8
MIN_REST = 1024
MIN_PERM_SLAB_BYTES = 32768
MAX_LADDER_K = 8  # 2^K combo-table entries

_PLANE_DTYPES = (torch.float32, torch.float64, torch.bfloat16)


# ---------------------------------------------------------------------------
# Schedules and eligibility (pure host code).


def cycle_schedule(ginv: np.ndarray):
    """Order the rows of a permutation along its cycles (the JAX package's
    ``pallas_oracle.cycle_schedule``, array for array).

    Output row j takes source row ginv[j].  Walking each cycle
    j -> ginv[j] -> ... makes step t's source the next step's output row, so
    an in-place walk reads every row once, before it writes it.  Returns
    int32 arrays (out_row, src_row, prev_kind): 0 = chain step, 1 = cycle
    head, 2 = fixed point, 3 = the cycle's closing step, whose source is the
    head row's original value.  From the native layer when it is available,
    else this Python walk."""
    from quantumcomputer_tpu_torch.algorithms import _native

    if _native.available():
        return _native.cycle_schedule(np.asarray(ginv, np.int32))
    rows = len(ginv)
    out_row = np.empty(rows, np.int32)
    src_row = np.empty(rows, np.int32)
    prev_kind = np.empty(rows, np.int32)
    visited = np.zeros(rows, bool)
    t = 0
    for j0 in range(rows):
        if visited[j0]:
            continue
        if ginv[j0] == j0:
            out_row[t], src_row[t], prev_kind[t] = j0, j0, 2
            visited[j0] = True
            t += 1
            continue
        j, first = j0, True
        while not visited[j]:
            visited[j] = True
            out_row[t] = j
            src_row[t] = ginv[j]
            prev_kind[t] = 1 if first else 0
            first = False
            t += 1
            j = int(ginv[j])
        prev_kind[t - 1] = 3
    assert t == rows
    return out_row, src_row, prev_kind


# The segmented walk (csrc/oracle_cycle.cu).  Segments are chosen so that
# the grid holds about the card's resident threads (132 SMs x 2048), with
# at least WALK_MIN_STEPS steps each, so the rows copied at the cuts stay a
# small share of the moved rows.
WALK_TARGET_THREADS = 1 << 18
WALK_MIN_STEPS = 64
WALK_MAX_SEGMENTS = 1 << 14
WALK_VEC_BYTES = 16
WALK_SECTOR_BYTES = 32
_SEG_STRIDE = 8  # t0, t1, a_row, b_row, head_row, unused


def walk_segment_count(rows: int, active: int, nmasks: int, vec: int) -> int:
    """S, the number of schedule segments walked concurrently: the power of
    two that brings the threads (2 planes x masks x active columns / vec
    per segment) closest below WALK_TARGET_THREADS."""
    per_segment = 2 * nmasks * max(1, active // vec)
    cap = max(1, min(WALK_MAX_SEGMENTS, rows // WALK_MIN_STEPS, WALK_TARGET_THREADS // per_segment))
    return 1 << (cap.bit_length() - 1)


def walk_segments(out_row, src_row, kind, S: int) -> np.ndarray:
    """Cut a cycle schedule into S contiguous step ranges and list what
    crosses each cut.  int32 (S, 8) records: t0, t1, a_row, b_row,
    head_row, and three unused.

    A row is read at step t (as src[t]) and written at step t + 1, or, a
    head row, read and written at its closing step.  So the only values a
    segment needs from before its neighbours write are: a_row, the source
    of its last step when the next segment's first step overwrites it (a
    chain or head step, else -1); and b_row, for a cycle that opened in an
    earlier segment and closes in this one, the source its head read, with
    head_row the head it writes at the close (else -1).  The walk copies
    those rows first, so the segments may then run in any order."""
    rows = len(kind)
    if not 1 <= S <= rows:
        raise ValueError(f"{S} segments do not fit a {rows}-step schedule")
    kind = np.asarray(kind)
    bounds = [s * rows // S for s in range(S + 1)]
    heads = np.flatnonzero(kind == 1)
    closes = np.flatnonzero(kind == 3)
    segs = np.full((S, _SEG_STRIDE), -1, np.int32)
    for s in range(S):
        t0, t1 = bounds[s], bounds[s + 1]
        segs[s, 0], segs[s, 1] = t0, t1
        if kind[t1 - 1] in (0, 1):
            segs[s, 2] = src_row[t1 - 1]
        if kind[t0] in (0, 3):  # the cycle at t0 opened earlier
            close = closes[np.searchsorted(closes, t0)]
            if close < t1:
                head = heads[np.searchsorted(heads, t0) - 1]
                segs[s, 3], segs[s, 4] = src_row[head], out_row[head]
    return segs


def _min_perm_cb2(itemsize: int) -> int:
    return MIN_PERM_SLAB_BYTES // (LANE * itemsize)


def ladder_high_supported(controls, M: int, n: int, itemsize: int = 4) -> bool:
    """The JAX package's eligibility of a ladder run: every control stride
    covers an 8 KB slab, the rows are long enough, at most 8 gates, and
    combo * j fits int32."""
    rest = 1 << (n - M)
    if rest < MIN_REST or (1 << M) < ROWS_PER_BLOCK:
        return False
    if len(controls) > MAX_LADDER_K:
        return False
    if (1 << M) * (1 << M) >= (1 << 31):
        return False
    c_min = min(controls)
    return c_min >= 7 and (1 << (c_min - 7)) * LANE * itemsize >= 8192


def perm_supported(c_phys: int, M: int, n: int, itemsize: int = 4) -> bool:
    """The JAX package's eligibility of the single-gate masked path: the
    control stride covers a 32 KB slab and at least two of them."""
    min_cb2 = _min_perm_cb2(itemsize)
    rest = 1 << (n - M)
    if rest < max(MIN_REST, 2 * min_cb2 * LANE) or (1 << M) < ROWS_PER_BLOCK:
        return False
    return (1 << (c_phys - 7)) >= min_cb2 if c_phys >= 7 else False


def pair_member_supported(c_phys: int, M: int, n: int, itemsize: int = 4) -> bool:
    """Per-gate test: two gates with distinct controls that both pass form
    a pair_inplace_supported pair."""
    min_cb2 = _min_perm_cb2(itemsize)
    rest = 1 << (n - M)
    if rest < max(MIN_REST, 4 * min_cb2 * LANE) or (1 << M) < ROWS_PER_BLOCK:
        return False
    return c_phys >= 7 and (1 << (c_phys - 7)) >= min_cb2


def pair_inplace_supported(controls, M: int, n: int, itemsize: int = 4) -> bool:
    """True when two fused gates run as one in-place masked pass."""
    if len(controls) != 2 or controls[0] == controls[1]:
        return False
    return all(pair_member_supported(c, M, n, itemsize) for c in controls)


# The strip pass (csrc/oracle_strip.cu): one block stages C rows of a 16- or
# 32-byte column strip of one plane in shared memory; a row holds at least
# one 32-byte sector.
STRIP_MIN_ROW_BYTES = 32
#: The shared memory a strip block may take on an H100 (sm_90a, the one
#: architecture the build targets: 227 KB a block less the kernel's reserve
#: for its static arrays).  The card reports its own (strip_room); a CPU run
#: takes this, so it merges what the card would.
STRIP_ROOM_SM90 = 232448 - 1024
_STRIP_DTYPES = (torch.bfloat16, torch.float32)


@lru_cache(maxsize=8)
def strip_room(device) -> int:
    """The shared memory (bytes) a strip block may take on `device`: what
    the kernel reads from a CUDA card (qc_oracle_strip_room), else
    STRIP_ROOM_SM90."""
    device = torch.device(device)
    if device.type != "cuda":
        return STRIP_ROOM_SM90
    room = ctypes.c_int64(0)
    with torch.cuda.device(device):
        _build.check(_build.load().qc_oracle_strip_room(ctypes.byref(room)), "oracle strip room")
    return room.value


def strip_bytes(C: int, room: int) -> int:
    """The strip width a run takes: 32 bytes (a warp storing whole sectors)
    where C rows of it fit `room`, else 16 (PERF.md §6)."""
    return 32 if 32 * C <= room else 16


def strip_run_supported(M: int, n: int, itemsize: int, aligned: bool, room: int) -> bool:
    """The strip kernel's eligibility, from the card's limits: 16-byte
    aligned bf16 or float32 planes, a 2^M-row 16-byte strip within `room`
    (strip_room), rows of at least a sector."""
    return (
        aligned
        and itemsize in (2, 4)
        and 1 <= M < n
        and (16 << M) <= room
        and (itemsize << (n - M)) >= STRIP_MIN_ROW_BYTES
    )


# Shares of the memory rate on an H100 (PERF.md §6, scripts/prof_strip.py),
# by plane item size and by the register size n they were read at: a cycle
# walk's by the bytes of its runs of moved columns (itemsize << control, 16
# to 256), the strip pass's by its width, the out-of-place ladder's.  At
# n = 32 (rows 2 MiB apart) the float32 pass reads 0.31 of the rate, against
# 0.415 at n = 28.
WALK_SHARE = {
    (2, 28): {16: 0.39, 32: 0.47, 64: 0.59, 128: 0.62, 256: 0.69},
    (2, 32): {16: 0.40, 32: 0.50, 64: 0.64, 128: 0.67, 256: 0.75},
    (4, 28): {16: 0.39, 32: 0.49, 64: 0.61, 128: 0.76, 256: 0.81},
    (4, 32): {16: 0.40, 32: 0.50, 64: 0.64, 128: 0.78, 256: 0.84},
}
STRIP_SHARE = {
    (2, 28): {16: 0.40, 32: 0.51},
    (2, 32): {16: 0.41, 32: 0.40},
    (4, 28): {16: 0.415, 32: 0.58},
    (4, 32): {16: 0.306, 32: 0.31},
}
LADDER_SHARE = {(2, 28): 0.75, (2, 32): 0.52, (4, 28): 0.88, (4, 32): 0.89}


def _shares(table: dict, itemsize: int, n: int):
    """The entry of `table` read at `itemsize` and at the largest register
    size not above n (the smallest one read, for a smaller n)."""
    sizes = sorted(k for i, k in table if i == itemsize)
    return table[itemsize, max((k for k in sizes if k <= n), default=sizes[0])]


def strip_pays(entries, C: int, itemsize: int, room: int, n: int) -> bool:
    """True when one strip pass over a run of plan entries should beat the
    entries one by one.  Each entry is a tuple of controls: one for a cycle
    walk, more for an out-of-place ladder.  The pass's time: the sectors it
    rewrites at STRIP_SHARE of the memory rate, counted as the mean of the
    32-byte sectors and of the 64-byte sector pairs that hold a moved column
    (all of them when a control lies below their column bits, else those
    with a control bit set): with its lowest control at a sector's first
    column bit, moved and unmoved sectors alternate and the pass reads at
    about half the rate in the unmoved ones' place.  The entries' time: half
    the state each walk at WALK_SHARE, the whole state each ladder at
    LADDER_SHARE.  The shares are those of this item size and register size
    (_shares): the rule adapts to both.  A tie goes to the entries, and a
    lone entry keeps its kernel (on an H100 the pass read 1.56-1.58 ms
    against a lone bf16 walk's 0.83-0.85 at controls 0 and 3)."""
    entries = [tuple(int(c) for c in e) for e in entries]
    controls = [c for e in entries for c in e]
    walk, strip, ladder = (_shares(t, itemsize, n) for t in (WALK_SHARE, STRIP_SHARE, LADDER_SHARE))
    sector_bits = (WALK_SECTOR_BYTES // itemsize).bit_length() - 1
    moved = sum(1.0 if min(controls) < bits else 1.0 - 2.0 ** -len(controls) for bits in (sector_bits, sector_bits + 1))
    one_pass = moved / 2 / strip[strip_bytes(C, room)]
    apart = sum(0.5 / walk[min(max(itemsize << e[0], 16), 256)] if len(e) == 1 else 1.0 / ladder for e in entries)
    return len(entries) >= 2 and one_pass < apart


def planes_aligned(planar: torch.Tensor) -> bool:
    """True when both planes start on a 16-byte boundary (the walk's and the
    strip pass's vector width)."""
    return all(p.data_ptr() % 16 == 0 for p in (planar[0], planar[1]))


@lru_cache(maxsize=256)
def pass_bytes(C: int, A_list: tuple, n: int, M: int, itemsize: int, in_place: bool) -> int:
    """Bytes a pass of K = len(A_list) gates reads and writes on a (2, 2^n)
    state: out of place (the ladder) every element once each way; in place
    (a walk, a pair, a strip run) each element it moves, once each way: the
    rest >> K columns of every nonzero control mask m, times the rows
    j < C that the mask's composed multiplier mu moves (C - gcd(mu - 1, C)
    of them; rows >= C and the fixed points stay).  The masks are counted
    by their product mod C, gate by gate, so a long run costs K x C steps
    and not 2^K."""
    if not in_place:
        return 2 * 2 * itemsize << n
    residues = np.arange(C)
    count = np.zeros(C, np.int64)  # count[mu]: the masks so far whose product is mu
    count[1] = 1
    for A in A_list:
        grown = count.copy()
        np.add.at(grown, residues * (int(A) % C) % C, count)
        count = grown
    moved = int(np.sum(count * (C - np.gcd(residues - 1, C))))
    return 2 * 2 * itemsize * moved << (n - M - len(A_list))


def mask_multipliers(C: int, A_list, M: int) -> np.ndarray:
    """(2^K - 1, 2^M) int32 inverse permutations of a run of K gates, one
    per nonzero control mask m (bit k = gate k): ginv_m[j] = combo[m] * j
    mod C for j < C, identity above."""
    combos = tops.modexp_combo_multipliers(C, list(A_list))
    f = np.arange(1 << M, dtype=np.int64)
    return np.stack(
        [np.where(f < C, (int(combos[m]) * f) % C, f).astype(np.int32) for m in range(1, len(combos))]
    )


# ---------------------------------------------------------------------------
# Device tables, cached per (C, A..., M, device) so attempts do not upload
# them again.


@lru_cache(maxsize=256)
def _host_schedules(C: int, A_list: tuple, M: int) -> np.ndarray:
    """int32 (2^K - 1, 3, 2^M): the cycle schedule of each nonzero mask."""
    return np.stack([np.stack(cycle_schedule(g)) for g in mask_multipliers(C, A_list, M)])


@lru_cache(maxsize=256)
def _schedules(C: int, A_list: tuple, M: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_host_schedules(C, A_list, M)).to(device)


@lru_cache(maxsize=256)
def _segments(C: int, A_list: tuple, M: int, S: int, device: torch.device) -> torch.Tensor:
    """int32 (2^K - 1, S, 8): walk_segments of each mask's schedule."""
    return torch.from_numpy(np.stack([walk_segments(*s, S) for s in _host_schedules(C, A_list, M)])).to(device)


@lru_cache(maxsize=256)
def _strip_table(C: int, A_list: tuple, controls: tuple, device: torch.device) -> torch.Tensor:
    """int32 (2K,): the run's inverse multipliers, then its controls."""
    ainv = [pow(int(A) % C, -1, C) for A in A_list]
    return torch.tensor(ainv + list(controls), dtype=torch.int32).to(device)


@lru_cache(maxsize=256)
def _combo(C: int, A_list: tuple, device: torch.device) -> torch.Tensor:
    """int32 (2^K,) composed inverse multipliers."""
    return torch.from_numpy(tops.modexp_combo_multipliers(C, list(A_list)).astype(np.int32)).to(device)


# ---------------------------------------------------------------------------
# Wrappers.


def _geometry(planar: torch.Tensor, C: int, M: int, bits) -> tuple:
    """(log_rows, log_rest) of a valid oracle call, or raise."""
    n = sv.num_qubits(planar)
    if planar.dtype not in _PLANE_DTYPES:
        raise TypeError(f"planar state must be float32, float64 or bfloat16, got {planar.dtype}")
    if not planar.is_contiguous():
        raise ValueError("planar state must be contiguous")
    if not 0 <= M <= n:
        raise ValueError(f"work register M={M} does not fit a {n}-qubit state")
    if (1 << M) < C:
        raise ValueError(f"2^M={1 << M} < C={C}: the modular-multiply gate is not unitary (increase M)")
    if any(not 0 <= c < n - M for c in bits):
        raise ValueError(f"controls {tuple(bits)} must be column bits below n - M = {n - M}")
    return M, n - M


def _device_kind(planar: torch.Tensor, what: str) -> str:
    kind = planar.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no {what} path for device {planar.device}")
    return kind


def _stream(planar: torch.Tensor) -> int:
    return torch.cuda.current_stream(planar.device).cuda_stream


def _check_out(planar: torch.Tensor, out: torch.Tensor) -> None:
    if out.shape != planar.shape or out.dtype != planar.dtype or out.device != planar.device:
        raise ValueError("out must match the state's shape, dtype and device")
    if not out.is_contiguous() or out.data_ptr() == planar.data_ptr():
        raise ValueError("out must be a distinct contiguous buffer")


def apply_camodc_high_planar(planar: torch.Tensor, out: torch.Tensor, C: int, atox: int, c_phys: int, M: int) -> torch.Tensor:
    """One controlled modular multiply (m_high layout), OUT OF PLACE: reads
    `planar`, writes out[j, col] = ctrl(col) ? x[ginv[j], col] : x[j, col]
    into `out` (a distinct buffer of the same shape and dtype) and returns
    it.  The JAX function's own limits hold: 2^M >= 8 rows of >= 1024
    columns."""
    log_rows, log_rest = _geometry(planar, C, M, (c_phys,))
    if (1 << log_rows) < ROWS_PER_BLOCK:
        raise ValueError(f"2^M={1 << log_rows} < {ROWS_PER_BLOCK}: M too small for the row-gather oracle")
    if (1 << log_rest) < MIN_REST:
        raise ValueError(f"rows of 2^(n-M)={1 << log_rest} < {MIN_REST} columns are too short for the row-gather oracle")
    kind = _device_kind(planar, "gather")
    _check_out(planar, out)
    if kind == "cpu":
        return tops.apply_camodc_high_planes_(out.copy_(planar), C, atox, c_phys, M)
    planes = (planar[0], planar[1], out[0], out[1])
    if any(p.data_ptr() % 16 for p in planes):
        raise ValueError("the row-gather kernel needs 16-byte aligned planes")
    fn = _build.entry("qc_oracle_gather", planar.dtype)
    ginv = tops.inverse_index_table(C, atox, M, planar.device)
    with torch.cuda.device(planar.device):
        err = fn(*(p.data_ptr() for p in planes), ginv.data_ptr(), log_rows, log_rest, c_phys, _stream(planar))
    _build.check(err, "oracle gather")
    LAUNCHES["gather"] += 1
    return out


def apply_camodc_ladder_high_planar(
    planar: torch.Tensor, out: torch.Tensor, C: int, A_list, controls, M: int
) -> torch.Tensor:
    """A fused run of K <= 8 controlled modular multiplies (m_high layout),
    OUT OF PLACE: reads `planar`, writes `out` (a distinct buffer of the same
    shape and dtype) and returns it.  The gates commute, so the run is one
    gather whose multiplier each column's control bits select."""
    log_rows, log_rest = _geometry(planar, C, M, controls)
    if len(controls) > MAX_LADDER_K or len(A_list) != len(controls):
        raise ValueError(f"a ladder takes 1..{MAX_LADDER_K} gates with one control each")
    _check_out(planar, out)
    if _device_kind(planar, "ladder") == "cpu":
        return tops.apply_camodc_ladder_high_planes_(out.copy_(planar), C, A_list, controls, M)
    combo = _combo(C, tuple(int(A) for A in A_list), planar.device)
    packed = sum(int(c) << (8 * k) for k, c in enumerate(controls))
    fn = _build.entry("qc_oracle_ladder", planar.dtype)
    with torch.cuda.device(planar.device):
        err = fn(
            planar[0].data_ptr(), planar[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            combo.data_ptr(), len(controls), packed, C, log_rows, log_rest, _stream(planar),
        )
    _build.check(err, "oracle ladder")
    LAUNCHES["ladder"] += 1
    return out


def apply_camodc_high_cycle_planar(planar: torch.Tensor, C: int, atox: int, c_phys: int, M: int) -> torch.Tensor:
    """One controlled modular multiply (m_high layout), IN PLACE, its
    control at any column bit: the cycle-ordered walk over the control-1
    columns.  Returns `planar`."""
    _geometry(planar, C, M, (c_phys,))
    if _device_kind(planar, "cycle") == "cpu":
        return tops.apply_camodc_high_planes_(planar, C, atox, c_phys, M)
    return _walk(planar, C, (int(atox),), (int(c_phys),), M, "cycle")


def walk_vector(planar: torch.Tensor, controls) -> int:
    """Columns a walk thread moves per step: 16 bytes when every run of
    moved columns (2^min(controls) of them) fills a 32-byte sector and the
    planes are 16-byte aligned, else 1."""
    item = planar.element_size()
    return WALK_VEC_BYTES // item if planes_aligned(planar) and (item << min(controls)) >= WALK_SECTOR_BYTES else 1


def _walk(planar: torch.Tensor, C: int, A_list: tuple, controls: tuple, M: int, kernel: str) -> torch.Tensor:
    """The segmented in-place walk on a CUDA tensor: `cycle` (one gate) or
    `cycle_masked` (one gate, or a pair's three masks)."""
    log_rows, log_rest = M, sv.num_qubits(planar) - M
    sched = _schedules(C, A_list, M, planar.device)
    nmasks = sched.shape[0]
    active = 1 << (log_rest - len(controls))
    vec = walk_vector(planar, controls)
    S = walk_segment_count(1 << log_rows, active, nmasks, vec)
    segs = _segments(C, A_list, M, S, planar.device)
    scratch = torch.empty(2 * S * 2 * nmasks * active, dtype=planar.dtype, device=planar.device)
    fn = _build.entry(f"qc_oracle_{kernel}", planar.dtype)
    ptrs = (planar[0].data_ptr(), planar[1].data_ptr(), sched.data_ptr(), segs.data_ptr(), scratch.data_ptr(), S)
    with torch.cuda.device(planar.device):
        if kernel == "cycle":
            err = fn(*ptrs, log_rows, log_rest, controls[0], vec, _stream(planar))
        else:
            pos_b = controls[1] if len(controls) == 2 else -1
            err = fn(*ptrs, nmasks, log_rows, log_rest, controls[0], pos_b, vec, _stream(planar))
    _build.check(err, f"oracle {kernel}")
    LAUNCHES[kernel] += 1
    return planar


def apply_camodc_high_perm_planar(planar: torch.Tensor, C: int, atox: int, c_phys: int, M: int) -> torch.Tensor:
    """One controlled modular multiply (m_high layout), IN PLACE, through the
    masked walk with a single mask: only the control-1 columns are read and
    written.  Returns `planar`."""
    _geometry(planar, C, M, (c_phys,))
    if _device_kind(planar, "perm") == "cpu":
        return tops.apply_camodc_high_planes_(planar, C, atox, c_phys, M)
    return _walk(planar, C, (int(atox),), (int(c_phys),), M, "cycle_masked")


def apply_camodc_pair_inplace_planar(planar: torch.Tensor, C: int, A_pair, controls, M: int) -> torch.Tensor:
    """Two fused controlled modular multiplies (m_high layout) in one
    in-place masked walk: a column of mask m = bit_a + 2 * bit_b moves by the
    composed multiplier of the gates set in m, and mask-0 columns never
    move.  Returns `planar`."""
    if len(controls) != 2 or len(A_pair) != 2 or controls[0] == controls[1]:
        raise ValueError("a pair takes two gates with distinct controls")
    _geometry(planar, C, M, controls)
    if _device_kind(planar, "pair") == "cpu":
        return tops.apply_camodc_ladder_high_planes_(planar, C, A_pair, controls, M)
    return _walk(planar, C, tuple(int(A) for A in A_pair), tuple(int(c) for c in controls), M, "cycle_masked")


def apply_camodc_run_inplace_planar(planar: torch.Tensor, C: int, A_list, controls, M: int) -> torch.Tensor:
    """A run of K controlled modular multiplies (m_high layout), IN PLACE, in
    one pass: x[j, col] <- x[(mu(col) * j) mod C, col] for j < C, mu(col)
    the product of the inverse multipliers of the gates whose control bit
    of col is set.  The gates commute, so this equals applying them one by
    one.  Takes the kernel's limits on every device (strip_run_supported:
    bf16 or float32 planes, 16-byte aligned, M within shared memory, rows
    of a sector), so a CPU run accepts what the card does.  Returns
    `planar`."""
    controls = tuple(int(c) for c in controls)
    if not controls or len(A_list) != len(controls) or len(set(controls)) != len(controls):
        raise ValueError("a run takes one or more gates with distinct controls, one multiplier each")
    log_rows, log_rest = _geometry(planar, C, M, controls)
    if planar.dtype not in _STRIP_DTYPES:
        raise TypeError(f"the strip pass takes bfloat16 or float32 planes, not {planar.dtype}")
    if C * C >= (1 << 31):
        raise ValueError(f"C={C} too large for int32 run composition")
    kind = _device_kind(planar, "strip")
    room = strip_room(planar.device)
    if not strip_run_supported(M, log_rows + log_rest, planar.element_size(), planes_aligned(planar), room):
        raise ValueError(
            f"the strip pass needs 16-byte aligned planes, 2^M x 16 bytes within {room} bytes of shared "
            f"memory and rows of at least {STRIP_MIN_ROW_BYTES} bytes (M={M}, n={log_rows + log_rest})"
        )
    if kind == "cpu":
        return tops.apply_camodc_ladder_high_planes_(planar, C, A_list, controls, M)
    tab = _strip_table(C, tuple(int(A) for A in A_list), controls, planar.device)
    fn = _build.entry("qc_oracle_strip", planar.dtype)
    with torch.cuda.device(planar.device):
        err = fn(
            planar[0].data_ptr(), planar[1].data_ptr(), tab.data_ptr(), len(controls), C, log_rows, log_rest,
            strip_bytes(C, room), _stream(planar),
        )
    _build.check(err, "oracle strip")
    LAUNCHES["strip"] += 1
    return planar
