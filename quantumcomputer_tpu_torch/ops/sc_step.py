"""The semiclassical step's epilogue in two passes: wrappers and plain
versions.

A structured step (``algorithms/semiclassical.py``) permutes both planes
of the work state w into (gr, gi), unscaled.  What remains is the
epilogue, which these two passes compute without storing the rotated
branch a1 (``csrc/sc_step.cu`` holds the formulas):

  branch_sums(w, gr, gi, ct, st)   one (p0, p1) pair per block of the
      kernel's grid, float64, shape (G, 2): the partial sums of |b0|^2 and
      |b1|^2 (kernel A, sc_branch_sums_kernel)
  collapse(w, gr, gi, ct, st, partials, r, force)
      the pairs summed in one fixed order (``reduce_partials``), the bit
      (r (p0 + p1) >= p0, or the forced one), and w' written over w;
      returns (bit, p_bit / (p0 + p1)) as 0-d tensors on the device
      (kernel B, sc_collapse_kernel)

The plain versions (``branch_sums_plain``, ``collapse_plain``) compute the
same in PyTorch ops, in 2^22-element blocks, rounding as the kernels do:
given the same pairs, collapse_plain's state equals the kernel's bit for
bit; the sums differ in their order only.  Each wrapper takes the plain
version for a CPU tensor, launches the kernel for a CUDA tensor (float32
or float64 planes), and raises for any other device; it raises on a
malformed input (``check_inputs``).  ``LAUNCHES`` counts launches by kernel.
"""

from __future__ import annotations

import math

import torch

from quantumcomputer_tpu_torch.ops import _build

#: Kernel launches by kernel (CUDA tensors only).
LAUNCHES = {"branch_sums": 0, "collapse": 0}

DTYPES = (torch.float32, torch.float64)
S2 = 1.0 / math.sqrt(2.0)
# csrc/sc_step.cu's block width and the blocks of its grid per SM.
THREADS = 256
BLOCKS_PER_SM = 4
_VEC_BYTES = 16
_PLAIN_BLOCK = 1 << 22


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % _VEC_BYTES == 0


def check_inputs(w, gr, gi, ct, st) -> None:
    """Raise unless w is a contiguous (2, n) float32 or float64 state, gr and
    gi contiguous (n,) planes of its dtype and device, ct and st one-element
    tensors of that dtype, and every plane starts on a 16-byte boundary."""
    if w.dtype not in DTYPES:
        raise TypeError(f"the step's kernels take float32 or float64 planes, got {w.dtype}")
    if w.dim() != 2 or w.shape[0] != 2:
        raise ValueError(f"w must be a (2, n) planar state, got {tuple(w.shape)}")
    n = w.shape[1]
    for name, t, shape in (("w", w, (2, n)), ("gr", gr, (n,)), ("gi", gi, (n,)), ("ct", ct, None), ("st", st, None)):
        if t.dtype != w.dtype or t.device != w.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; w is {w.dtype} on {w.device}")
        if shape is None:
            if t.numel() != 1:
                raise ValueError(f"{name} must hold one value, got shape {tuple(t.shape)}")
        elif tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor, got {tuple(t.shape)} strides {t.stride()}")
    if not all(_aligned(t) for t in (w[0], w[1], gr, gi)):
        raise ValueError("the planes of w, gr and gi must start on 16-byte boundaries")


def _grid(w: torch.Tensor) -> int:
    """Blocks of the persistent grid: a few per SM, fewer for a small state."""
    vectors = -(-w.shape[1] * w.element_size() // _VEC_BYTES)
    sms = torch.cuda.get_device_properties(w.device).multi_processor_count
    return max(1, min(sms * BLOCKS_PER_SM, -(-vectors // THREADS)))


def _device_kind(w: torch.Tensor) -> str:
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no semiclassical step path for device {w.device}")
    return w.device.type


def _parts(w, gr, gi, ct, st, s2, lo: int, hi: int) -> tuple:
    """a0 = w s2 and a1 = e^{i theta} (g s2) of elements lo:hi, each op
    rounded once: the rotation of semiclassical._oracle_pass_structured."""
    g_r, g_i = gr[lo:hi] * s2, gi[lo:hi] * s2
    a1r = g_r * ct - g_i * st
    a1i = g_r * st + g_i * ct
    return w[0, lo:hi] * s2, w[1, lo:hi] * s2, a1r, a1i


def _blocks(n: int):
    return ((lo, min(lo + _PLAIN_BLOCK, n)) for lo in range(0, n, _PLAIN_BLOCK))


def branch_sums_plain(w, gr, gi, ct, st) -> torch.Tensor:
    """Kernel A in PyTorch ops: one (p0, p1) float64 pair per 2^22-element
    block, each element's |b|^2 formed in the planes' dtype and summed in
    float64."""
    s2 = torch.tensor(S2, dtype=w.dtype, device=w.device)
    rows = []
    for lo, hi in _blocks(w.shape[1]):
        a0r, a0i, a1r, a1i = _parts(w, gr, gi, ct, st, s2, lo, hi)
        b0r, b0i = (a0r + a1r) * s2, (a0i + a1i) * s2
        b1r, b1i = (a0r - a1r) * s2, (a0i - a1i) * s2
        rows.append(torch.stack([
            (b0r * b0r + b0i * b0i).to(torch.float64).sum(),
            (b1r * b1r + b1i * b1i).to(torch.float64).sum(),
        ]))
    return torch.stack(rows)


def reduce_partials(partials: torch.Tensor) -> torch.Tensor:
    """(p0, p1) in float64 from the (G, 2) pairs, in kernel B's order:
    THREADS running sums, the k-th taking pairs k, k + THREADS, ... in turn,
    then a halving tree."""
    g = partials.shape[0]
    padded = torch.zeros((-(-g // THREADS) * THREADS, 2), dtype=torch.float64, device=partials.device)
    padded[:g] = partials  # the zeros add exactly
    acc = torch.zeros((THREADS, 2), dtype=torch.float64, device=partials.device)
    for rows in padded.view(-1, THREADS, 2):
        acc = acc + rows
    s = THREADS // 2
    while s:
        acc = acc[:s] + acc[s : 2 * s]
        s //= 2
    return acc[0]


def collapse_plain(w, gr, gi, ct, st, partials, r, force: int) -> tuple:
    """Kernel B in PyTorch ops: the bit and p_bit / (p0 + p1) as 0-d
    tensors; w' written over w block by block, each op rounded once in the
    order of semiclassical.collapse_from_a1."""
    s2 = torch.tensor(S2, dtype=w.dtype, device=w.device)
    p0, p1 = reduce_partials(partials).to(w.dtype)
    total = p0 + p1
    if force >= 0:
        bit = torch.full((), int(force), dtype=torch.int64, device=w.device)
    else:
        bit = (r * total >= p0).to(torch.int64)
    p_branch = torch.where(bit == 1, p1, p0)
    sign = (1 - 2 * bit).to(w.dtype)
    scale = torch.sqrt(p_branch)
    for lo, hi in _blocks(w.shape[1]):
        a0r, a0i, a1r, a1i = _parts(w, gr, gi, ct, st, s2, lo, hi)
        w[0, lo:hi] = (sign * a1r + a0r) * s2 / scale
        w[1, lo:hi] = (sign * a1i + a0i) * s2 / scale
    return bit, p_branch / total


def branch_sums(w, gr, gi, ct, st) -> torch.Tensor:
    """The (G, 2) float64 pairs of |b0|^2 and |b1|^2: kernel A on a CUDA
    tensor, branch_sums_plain on a CPU tensor."""
    if _device_kind(w) == "cpu":
        return branch_sums_plain(w, gr, gi, ct, st)
    check_inputs(w, gr, gi, ct, st)
    n = w.shape[1]
    grid = _grid(w)
    partials = torch.empty((grid, 2), dtype=torch.float64, device=w.device)
    fn = _build.entry("qc_sc_branch_sums", w.dtype)
    with torch.cuda.device(w.device):
        err = fn(
            w[0].data_ptr(), w[1].data_ptr(), gr.data_ptr(), gi.data_ptr(), ct.data_ptr(), st.data_ptr(), S2,
            partials.data_ptr(), grid, n, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "sc_branch_sums")
    LAUNCHES["branch_sums"] += 1
    return partials


def collapse(w, gr, gi, ct, st, partials, r, force: int) -> tuple:
    """Measure and collapse from branch_sums' pairs: kernel B on a CUDA
    tensor (w' written over w), collapse_plain on a CPU tensor.  `r` is the
    draw, a one-element tensor of w's dtype; `force` the forced bit, or -1.
    Returns (bit, p_cond) as 0-d tensors on w's device."""
    if force not in (-1, 0, 1):
        raise ValueError(f"force must be -1, 0 or 1, got {force}")
    if _device_kind(w) == "cpu":
        return collapse_plain(w, gr, gi, ct, st, partials, r, force)
    check_inputs(w, gr, gi, ct, st)
    if partials.dtype != torch.float64 or partials.dim() != 2 or partials.shape[1] != 2 or not partials.is_contiguous():
        raise ValueError(f"partials must be a contiguous (G, 2) float64 tensor, got {partials.dtype} {partials.shape}")
    if partials.device != w.device or r.device != w.device or r.dtype != w.dtype or r.numel() != 1:
        raise TypeError("partials and r must lie on w's device, and r be one value of w's dtype")
    n = w.shape[1]
    bit = torch.empty((), dtype=torch.int64, device=w.device)
    p_cond = torch.empty((), dtype=w.dtype, device=w.device)
    fn = _build.entry("qc_sc_collapse", w.dtype)
    with torch.cuda.device(w.device):
        err = fn(
            w[0].data_ptr(), w[1].data_ptr(), gr.data_ptr(), gi.data_ptr(), ct.data_ptr(), st.data_ptr(), S2,
            partials.data_ptr(), partials.shape[0], r.data_ptr(), int(force), bit.data_ptr(), p_cond.data_ptr(),
            _grid(w), n, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "sc_collapse")
    LAUNCHES["collapse"] += 1
    return bit, p_cond
