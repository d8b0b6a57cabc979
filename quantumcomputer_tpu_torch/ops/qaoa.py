"""The QAOA step's cost layer, its mixer's fused segments and its adjoint
gradient's reductions: wrappers, plain versions and the cost table.

QAOA for MaxCut (``algorithms/variational.qaoa_step``) evolves |+>^n through
p layers of the cost phase exp(-i gamma C) and the mixer exp(-i beta B),
B = sum_q X_q (n RX(2 beta) gates: the engine's fused segments, planned
once for their structure, each run taking its angle at launch:
``mixer_segments``, ``mixer_values``, ``apply_mixer``), and reads
E = <psi|C|psi>.  Its gradient comes by the adjoint method (Jones and
Gacon, arXiv:2009.02823): from lambda = C psi, walking the layers
backward and undoing each on psi and lambda alike,

    dE/dbeta_k  = 2 Im <lambda|B|psi>   after mixer k,
    dE/dgamma_k = 2 Im <lambda|C|psi>   after cost layer k,

so no intermediate state is kept and the step holds two states whatever p.

The cost diagonal lives on the device as one uint8 level an amplitude
(``CostTable``: the cut value c(x), whole numbers under 256), built there
with torch ops from the edges.  The four passes:

  apply_phase(psi, table, ph)                   psi *= ph[c]
  expect(psi, table, lam=None)                  sum |psi|^2 c, float64;
                                                lam = c psi when given
  cost_grad(psi, lam, table, ph, write)         sum c Im(conj(lam) psi), float64;
                                                then psi, lam *= ph[c] if write
  mixer_grad(psi, lam, group)                   sum over the group's qubits q of
                                                Im <lam|X_q|psi>, float64

``ph`` is a (K, 2) table of exp(-+i gamma k) in the compute dtype
(``phase_table``).  ``mixer_groups`` cuts the qubits into the tiles of the
mixer's reduction (``csrc/qaoa.cu``: the low bits, then five axes at a
time, as the fused segments expose them).

Each wrapper launches the kernel (``csrc/qaoa.cu``) for a CUDA tensor, takes
the plain version (PyTorch ops, in 2^22-element blocks, each product formed
in the compute dtype and each sum in float64) for a CPU tensor, and raises
for any other device.  Sums come back as 0-d float64 tensors on the state's
device.  ``LAUNCHES`` counts launches by kernel.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from quantumcomputer_tpu_torch.models import circuit as cir
from quantumcomputer_tpu_torch.ops import _build, fused
from quantumcomputer_tpu_torch.sim import statevec as sv
from quantumcomputer_tpu_torch.utils import profiling

#: Kernel launches by kernel (CUDA tensors only).
LAUNCHES = {"phase": 0, "expect": 0, "cost_grad": 0, "mixer_grad": 0}

DTYPES = (torch.float32, torch.float64, torch.bfloat16)
#: Levels a uint8 table holds: cut values 0..255.
MAX_LEVELS = 256
# csrc/qaoa.cu's block width, the mixer reduction's persistent grid in
# blocks per SM, and that reduction's tile in amplitudes: 2^12 for float32
# and bf16 planes, 2^11 for float64 (16 or 8 amplitudes of each of four
# planes in a thread's registers).
THREADS = 256
BLOCKS_PER_SM = 3
TILE_BITS = {torch.float32: 12, torch.bfloat16: 12, torch.float64: 11}
LOW_BITS = 7
# Any angle whose RX(2 beta) has no zero entry: mixer_segments plans at it.
_PLAN_BETA = 0.3
_PLAIN_BLOCK = 1 << 22
_TABLE_CHUNK = 1 << 24


class CostTable:
    """The MaxCut cost diagonal of an n-qubit state on `device`: `levels`,
    one uint8 cut value an amplitude, and `values`, the float64 value of
    each level 0..K-1 (K = the edges' total weight + 1) on the same device.
    Built with torch ops on the device, 2^24 amplitudes at a time: each edge
    (a, b, w) adds w where bits a and b differ.  The weights must be whole
    numbers >= 0 that sum to less than 256."""

    def __init__(self, n: int, edges: Sequence, device):
        self.n = int(n)
        edges = [(int(e[0]), int(e[1]), _whole_weight(e)) for e in edges]
        for a, b, _ in edges:
            if not (0 <= a < n and 0 <= b < n) or a == b:
                raise ValueError(f"edge ({a}, {b}) is not a pair of distinct qubits of {n}")
        total = sum(w for _, _, w in edges)
        if total >= MAX_LEVELS:
            raise ValueError(f"the edges' weights sum to {total}; a uint8 cost table holds cut values below {MAX_LEVELS}")
        self.K = total + 1
        self.device = torch.device(device)
        dim = 1 << self.n
        with profiling.span("qaoa.table", self.device, bytes=dim):
            self.levels = torch.empty(dim, dtype=torch.uint8, device=self.device)
            for lo in range(0, dim, _TABLE_CHUNK):
                hi = min(dim, lo + _TABLE_CHUNK)
                idx = torch.arange(lo, hi, dtype=torch.int64 if self.n > 30 else torch.int32, device=self.device)
                c = torch.zeros(hi - lo, dtype=torch.int32, device=self.device)
                for a, b, w in edges:
                    c += (((idx >> a) ^ (idx >> b)) & 1) * w
                self.levels[lo:hi] = c.to(torch.uint8)
        self.device = self.levels.device  # "cuda" resolved to its index
        self.values = torch.arange(self.K, dtype=torch.float64, device=self.device)

    def optimal(self) -> int:
        """The largest cut (one pass over the levels)."""
        return int(self.levels.max())


def _whole_weight(e) -> int:
    w = float(e[2]) if len(e) > 2 else 1.0
    if w < 0 or w != math.floor(w):
        raise ValueError(f"edge {tuple(e)}: the cost table takes whole weights >= 0")
    return int(w)


def phase_tables(K: int, gammas: Sequence[float], sign: float, dtype: torch.dtype, device) -> torch.Tensor:
    """(len(gammas), K, 2) tables of exp(sign i gamma k), k = 0..K-1, in the
    compute dtype of `dtype` planes: computed in float64 on the host, rounded
    once, moved to `device` in one copy."""
    k = np.arange(K, dtype=np.float64)
    ang = sign * np.asarray(gammas, dtype=np.float64)[:, None] * k[None, :]
    tab = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    return torch.from_numpy(tab).to(device=device, dtype=sv.compute_dtype(dtype))


def plus_state(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """|+>^n as a planar state: every real part 2^(-n/2), every imaginary part 0."""
    planar = torch.zeros((2, 1 << n), dtype=dtype, device=device)
    planar[0].fill_(2.0 ** (-n / 2))
    return planar


@lru_cache(maxsize=16)
def mixer_segments(n: int, dtype: torch.dtype) -> Tuple[Tuple[tuple, tuple], ...]:
    """The fused segments (ops, axes) of the mixer exp(-i beta B) on an
    n-qubit state of `dtype` planes: its n RX(2 beta) gates planned once,
    for their structure (fused.plan_circuit, ungrouped: every segment in its
    butterfly form), at an angle whose every gate is a dense u1q op; each
    run takes its angle's values at launch (apply_mixer)."""
    circuit = tuple(cir.RX(q, 2.0 * _PLAN_BETA) for q in range(n))
    plan = fused.plan_circuit(circuit, n, 0, fused.TILE_BITS[dtype])
    segments = tuple((seg[1], seg[2]) for seg in plan)
    if any(seg[0] != "fused" for seg in plan) or sorted(op[1] for ops, _ in segments for op in ops) != list(range(n)) \
            or any(op[0] != "u1q" for ops, _ in segments for op in ops):
        raise AssertionError(f"the mixer's plan is not one u1q op a qubit: {plan}")
    return segments


def mixer_values(n: int, betas: Sequence[float], dtype: torch.dtype, device) -> torch.Tensor:
    """(len(betas), n, fused.OPF_STRIDE) op records of the mixers
    exp(-i beta B): for each beta, n rows of RX(2 beta)'s u1q values
    (fused.gate_to_op), in the compute dtype of `dtype` planes, moved to
    `device` in one copy.  Row k of one beta's block is op k's record in any
    of mixer_segments' segments."""
    rows = np.zeros((len(betas), n, fused.OPF_STRIDE), dtype=np.float64)
    for j, b in enumerate(betas):
        vals = fused.gate_to_op(cir.RX(0, 2.0 * float(b)))[2]
        rows[j, :, : len(vals)] = vals
    return torch.from_numpy(rows).to(device=device, dtype=sv.compute_dtype(dtype))


def apply_mixer(psi: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """exp(-i beta B) on psi in place, for one beta's block of mixer_values:
    each of mixer_segments' segments as one fused-segment launch with those
    values (fused.apply_segment_values; its plain version on the CPU), in a
    fused.segment span.  Returns psi."""
    for ops, axes in mixer_segments(sv.num_qubits(psi), psi.dtype):
        with profiling.span("fused.segment", psi.device):
            fused.apply_segment_values(psi, ops, axes, 0, values[: len(ops)])
    return psi


def mixer_groups(n: int, dtype: torch.dtype) -> List[Tuple[int, Tuple[int, ...], Tuple[int, ...]]]:
    """The passes of the mixer's reduction on an n-qubit state of `dtype`
    planes, each (t, axes, qubits): a tile of the low t bits and the axes,
    reducing over `qubits`.  The first takes the low min(n, TILE_BITS) bits
    whole; each later one up to TILE_BITS - LOW_BITS axes and as many low
    bits as fill the tile (at least LOW_BITS, for coalescing), so every
    tile but a small state's holds 2^TILE_BITS amplitudes."""
    tb = TILE_BITS[dtype]
    t0 = min(n, tb)
    groups = [(t0, (), tuple(range(t0)))]
    for q in range(t0, n, tb - LOW_BITS):
        axes = tuple(range(q, min(n, q + tb - LOW_BITS)))
        groups.append((tb - len(axes), axes, axes))
    return groups


# -- checks ------------------------------------------------------------------------------


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no QAOA pass for device {x.device}")
    return x.device.type


def check_state(psi: torch.Tensor, table: CostTable = None, other: torch.Tensor = None) -> None:
    """Raise unless psi is a contiguous (2, 2^n) planar state of a kernel
    dtype whose planes start on 16-byte boundaries, `other` (lambda) one of
    the same shape, dtype and device, and `table` a cost table of its size
    on its device."""
    if psi.dtype not in DTYPES:
        raise TypeError(f"the QAOA passes take float32, float64 or bfloat16 planes, got {psi.dtype}")
    n = sv.num_qubits(psi)
    if not psi.is_contiguous():
        raise ValueError("the planar state must be contiguous")
    for name, t in (("lambda", other),):
        if t is not None and (t.shape != psi.shape or t.dtype != psi.dtype or t.device != psi.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {tuple(psi.shape)} {psi.dtype} state on {psi.device}")
    if table is not None and (table.n != n or table.device != psi.device):
        raise ValueError(f"the cost table is for {table.n} qubits on {table.device}, the state {n} on {psi.device}")
    if psi.device.type == "cuda":
        planes = [psi[0], psi[1]] + ([other[0], other[1]] if other is not None else [])
        if any(x.data_ptr() % 16 for x in planes):
            raise ValueError("the planes must start on 16-byte boundaries")


def _grid(psi: torch.Tensor) -> int:
    quads = -(-psi.shape[1] // 4)
    sms = torch.cuda.get_device_properties(psi.device).multi_processor_count
    return max(1, min(sms * 4, -(-quads // THREADS)))


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _blocks(dim: int):
    return ((lo, min(lo + _PLAIN_BLOCK, dim)) for lo in range(0, dim, _PLAIN_BLOCK))


def _store(planes: torch.Tensor, lo: int, hi: int, r: torch.Tensor, i: torch.Tensor) -> None:
    planes[0, lo:hi] = r.to(planes.dtype)
    planes[1, lo:hi] = i.to(planes.dtype)


# -- plain versions ----------------------------------------------------------------------


def apply_phase_plain(psi: torch.Tensor, table: CostTable, ph: torch.Tensor) -> torch.Tensor:
    ct = sv.compute_dtype(psi.dtype)
    for lo, hi in _blocks(psi.shape[1]):
        c = table.levels[lo:hi].long()
        pr, pi = ph[c, 0].to(ct), ph[c, 1].to(ct)
        xr, xi = psi[0, lo:hi].to(ct), psi[1, lo:hi].to(ct)
        _store(psi, lo, hi, xr * pr - xi * pi, xr * pi + xi * pr)
    return psi


def expect_plain(psi: torch.Tensor, table: CostTable, lam: torch.Tensor = None) -> torch.Tensor:
    ct = sv.compute_dtype(psi.dtype)
    acc = torch.zeros((), dtype=torch.float64, device=psi.device)
    for lo, hi in _blocks(psi.shape[1]):
        v = table.values[table.levels[lo:hi].long()]
        xr, xi = psi[0, lo:hi].to(ct), psi[1, lo:hi].to(ct)
        r, m = xr.double(), xi.double()
        acc += ((r * r + m * m) * v).sum()
        if lam is not None:
            w = v.to(ct)
            _store(lam, lo, hi, xr * w, xi * w)
    return acc


def cost_grad_plain(psi: torch.Tensor, lam: torch.Tensor, table: CostTable, ph: torch.Tensor, write: bool) -> torch.Tensor:
    ct = sv.compute_dtype(psi.dtype)
    acc = torch.zeros((), dtype=torch.float64, device=psi.device)
    for lo, hi in _blocks(psi.shape[1]):
        c = table.levels[lo:hi].long()
        xr, xi = psi[0, lo:hi].to(ct), psi[1, lo:hi].to(ct)
        yr, yi = lam[0, lo:hi].to(ct), lam[1, lo:hi].to(ct)
        acc += (table.values[c] * (yr.double() * xi.double() - yi.double() * xr.double())).sum()
        if write:
            pr, pi = ph[c, 0].to(ct), ph[c, 1].to(ct)
            _store(psi, lo, hi, xr * pr - xi * pi, xr * pi + xi * pr)
            _store(lam, lo, hi, yr * pr - yi * pi, yr * pi + yi * pr)
    return acc


def mixer_grad_plain(psi: torch.Tensor, lam: torch.Tensor, qubits: Sequence[int]) -> torch.Tensor:
    """sum over q in `qubits` of Im <lam|X_q|psi>, pair by pair in float64."""
    acc = torch.zeros((), dtype=torch.float64, device=psi.device)
    for q in qubits:
        x = psi.double().view(2, -1, 2, 1 << q)
        y = lam.double().view(2, -1, 2, 1 << q)
        acc += (y[0, :, 0] * x[1, :, 1] - y[1, :, 0] * x[0, :, 1]).sum()
        acc += (y[0, :, 1] * x[1, :, 0] - y[1, :, 1] * x[0, :, 0]).sum()
    return acc


# -- the wrappers ------------------------------------------------------------------------


def apply_phase(psi: torch.Tensor, table: CostTable, ph: torch.Tensor) -> torch.Tensor:
    """psi *= ph[c] in place (the cost layer exp(-i gamma C) for the table of
    phase_tables with sign -1); returns psi."""
    check_state(psi, table)
    if _device_kind(psi) == "cpu":
        return apply_phase_plain(psi, table, ph)
    fn = _build.entry("qc_qaoa_phase", psi.dtype)
    with torch.cuda.device(psi.device):
        err = fn(psi[0].data_ptr(), psi[1].data_ptr(), table.levels.data_ptr(), ph.data_ptr(), table.K, _grid(psi),
                 psi.shape[1], _stream(psi))
    _build.check(err, "qaoa_phase")
    LAUNCHES["phase"] += 1
    return psi


def expect(psi: torch.Tensor, table: CostTable, lam: torch.Tensor = None) -> torch.Tensor:
    """<psi|C|psi> as a 0-d float64 tensor; with `lam`, lam = C psi written too."""
    check_state(psi, table, lam)
    if _device_kind(psi) == "cpu":
        return expect_plain(psi, table, lam)
    grid = _grid(psi)
    partials = torch.empty(grid, dtype=torch.float64, device=psi.device)
    lr, li = (lam[0].data_ptr(), lam[1].data_ptr()) if lam is not None else (None, None)
    fn = _build.entry("qc_qaoa_expect", psi.dtype)
    with torch.cuda.device(psi.device):
        err = fn(psi[0].data_ptr(), psi[1].data_ptr(), table.levels.data_ptr(), table.values.data_ptr(), lr, li,
                 partials.data_ptr(), table.K, grid, psi.shape[1], _stream(psi))
    _build.check(err, "qaoa_expect")
    LAUNCHES["expect"] += 1
    return partials.sum()


def cost_grad(psi: torch.Tensor, lam: torch.Tensor, table: CostTable, ph: torch.Tensor, write: bool = True) -> torch.Tensor:
    """sum_x c(x) Im(conj(lam_x) psi_x) as a 0-d float64 tensor; with `write`
    psi and lam are then multiplied by ph[c] in place (the cost layer undone
    for the table of phase_tables with sign +1)."""
    check_state(psi, table, lam)
    if _device_kind(psi) == "cpu":
        return cost_grad_plain(psi, lam, table, ph, write)
    grid = _grid(psi)
    partials = torch.empty(grid, dtype=torch.float64, device=psi.device)
    fn = _build.entry("qc_qaoa_cost_grad", psi.dtype)
    with torch.cuda.device(psi.device):
        err = fn(psi[0].data_ptr(), psi[1].data_ptr(), lam[0].data_ptr(), lam[1].data_ptr(), table.levels.data_ptr(),
                 table.values.data_ptr(), ph.data_ptr(), partials.data_ptr(), table.K, int(bool(write)), grid,
                 psi.shape[1], _stream(psi))
    _build.check(err, "qaoa_cost_grad")
    LAUNCHES["cost_grad"] += 1
    return partials.sum()


def mixer_grad(psi: torch.Tensor, lam: torch.Tensor, group: Tuple[int, Tuple[int, ...], Tuple[int, ...]]) -> torch.Tensor:
    """sum over the group's qubits q of Im <lam|X_q|psi>, as a 0-d float64
    tensor: one pass over a tile of the low t bits and the group's axes
    (mixer_groups)."""
    check_state(psi, None, lam)
    t, axes, qubits = group
    n = sv.num_qubits(psi)
    if _device_kind(psi) == "cpu":
        return mixer_grad_plain(psi, lam, qubits)
    local = [q if q < t else t + axes.index(q) for q in qubits]
    if t + len(axes) > n or any(q >= t and q not in axes for q in qubits):
        raise ValueError(f"qubits {qubits} do not lie in a tile of the low {t} bits and axes {axes}")
    ntiles = 1 << (n - t - len(axes))
    sms = torch.cuda.get_device_properties(psi.device).multi_processor_count
    grid = max(1, min(ntiles, sms * BLOCKS_PER_SM))
    partials = torch.empty(grid, dtype=torch.float64, device=psi.device)
    fn = _build.entry("qc_qaoa_mixer_grad", psi.dtype)
    with torch.cuda.device(psi.device):
        err = fn(psi[0].data_ptr(), psi[1].data_ptr(), lam[0].data_ptr(), lam[1].data_ptr(), partials.data_ptr(), n, t,
                 len(axes), sum(a << (8 * k) for k, a in enumerate(axes)), sum(1 << p for p in local), grid,
                 _stream(psi))
    _build.check(err, "qaoa_mixer_grad")
    LAUNCHES["mixer_grad"] += 1
    return partials.sum()


def state_bytes(psi: torch.Tensor) -> int:
    """Bytes of both planes of a planar state."""
    return psi.numel() * psi.element_size()
