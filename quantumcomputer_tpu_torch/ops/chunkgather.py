"""Chunk gather of the structured stride permutation: W-wide slices at
arbitrary element offsets.  Wrappers and plain versions.

The counterpart of the JAX package's ``ops/pallas_chunkgather.py``, four
entry points over one CUDA kernel (``csrc/chunk_gather.cu``).  x is (B, P),
the result (B, NC, W):

  chunk_gather(x, s, W)                 out[b,c,e] = x[b, s[c] + e]
  chunk_gather_src2(x, x2, s, flag, W)  the same, from x2 where flag[c] != 0
  chunk_gather_blend(x, s0, s1, istar, W)
      out[b,c,e] = x[b, s0[c] + e] if e < istar[c] else x[b, s1[c] + e]
  chunk_gather_blend_rowlaw(x, NC, v, vpad, Wt)
      the blend with s0, s1, istar from the chunk index by the law of
      ``rowlaw_offsets`` (the row compaction of ``ops/modperm.py``)

Every start is clamped into [0, P - W] of the buffer it reads, by the
kernel and by the plain version alike, so out-of-range starts (the deal
leg's boundary rows, which it overwrites afterwards) are memory-safe and
both versions agree on the whole output.  Offsets are int64 tensors.

Each wrapper takes the plain version for a CPU tensor, launches the kernel
for a CUDA tensor at every size, and raises for any other device.
``LAUNCHES`` counts kernel launches per entry point.
"""

from __future__ import annotations

import torch

from quantumcomputer_tpu_torch.ops import _build

#: Kernel launches per entry point (CUDA tensors only).
LAUNCHES = {"gather": 0, "src2": 0, "blend": 0, "rowlaw": 0}

_MODES = {"gather": 0, "src2": 1, "blend": 2, "rowlaw": 3}
_DTYPES = (torch.float32, torch.float64, torch.bfloat16)


def _check_x(x: torch.Tensor, W: int, what: str = "x") -> None:
    if x.dim() != 2:
        raise ValueError(f"{what} must be (B, P), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} must be float32, float64 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if W <= 0 or x.shape[1] < W:
        raise ValueError(f"{what} of length {x.shape[1]} is too short for chunks of W={W}")


def _offsets(x: torch.Tensor, *arrays) -> list:
    """Each index array as a contiguous int64 vector on x's device."""
    n = arrays[0].shape[0]
    out = []
    for a in arrays:
        if a.dim() != 1 or a.shape[0] != n:
            raise ValueError("offset arrays must be 1-D and of one length")
        out.append(a.to(device=x.device, dtype=torch.int64).contiguous())
    return out


def _windows(x: torch.Tensor, starts: torch.Tensor, W: int) -> torch.Tensor:
    """(B, NC, W): x[b, clamp(starts[c], 0, P - W) + e]."""
    s = starts.clamp(0, x.shape[1] - W)
    idx = s[:, None] + torch.arange(W, device=x.device, dtype=torch.int64)[None, :]
    return x[:, idx]


def chunk_gather_plain(x: torch.Tensor, starts: torch.Tensor, W: int) -> torch.Tensor:
    return _windows(x, starts, W)


def chunk_gather_src2_plain(x, x2, starts, flags, W: int) -> torch.Tensor:
    alt = flags != 0
    return torch.where(alt[None, :, None], _windows(x2, starts, W), _windows(x, starts, W))


def chunk_gather_blend_plain(x, s0, s1, istar, W: int) -> torch.Tensor:
    lane = torch.arange(W, device=x.device, dtype=torch.int64)
    first = lane[None, :] < istar[:, None]
    return torch.where(first[None], _windows(x, s0, W), _windows(x, s1, W))


def rowlaw_offsets(NC: int, v: int, vpad: int, Wt: int, P: int, device) -> tuple:
    """(s0, s1, istar) of the row-compaction law for chunks 0..NC-1 (the JAX
    package's in-kernel law, pallas_chunkgather.py:110-117):

        f0 = c*Wt; q0 = f0 // v; t0 = f0 - q0*v
        istar = clamp(v - t0, 0, Wt)
        s0 = clamp(q0*vpad + t0, 0, P - Wt)
        s1 = clamp((q0 + 1)*vpad - istar, 0, P - Wt)"""
    f0 = torch.arange(NC, device=device, dtype=torch.int64) * Wt
    q0 = f0 // v
    t0 = f0 - q0 * v
    istar = (v - t0).clamp(0, Wt)
    s0 = (q0 * vpad + t0).clamp(0, P - Wt)
    s1 = ((q0 + 1) * vpad - istar).clamp(0, P - Wt)
    return s0, s1, istar


def chunk_gather_blend_rowlaw_plain(x, NC: int, v: int, vpad: int, Wt: int) -> torch.Tensor:
    s0, s1, istar = rowlaw_offsets(NC, v, vpad, Wt, x.shape[1], x.device)
    return chunk_gather_blend_plain(x, s0, s1, istar, Wt)


def _launch(form: str, x, x2, a0, a1, a2, NC: int, W: int, v: int = 0, vpad: int = 0) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"no chunk_gather path for device {x.device}")
    B, P = x.shape
    out = torch.empty((B, NC, W), dtype=x.dtype, device=x.device)
    if NC == 0:
        return out
    P2 = 0
    if x2 is not None:
        if x2.dtype != x.dtype or x2.device != x.device or x2.shape[0] != B:
            raise ValueError("x2 must match x's dtype, device and batch")
        P2 = x2.shape[1]
    fn = _build.entry("qc_chunk_gather", x.dtype)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), ptr(x2), out.data_ptr(), ptr(a0), ptr(a1), ptr(a2), _MODES[form],
            B, P, P2, NC, W, v, vpad, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, f"chunk_gather {form}")
    LAUNCHES[form] += 1
    return out


def chunk_gather(x: torch.Tensor, starts: torch.Tensor, W: int) -> torch.Tensor:
    """out[b, c, :] = x[b, s : s + W], s = clamp(starts[c], 0, P - W)."""
    _check_x(x, W)
    (starts,) = _offsets(x, starts)
    if x.device.type == "cpu":
        return chunk_gather_plain(x, starts, W)
    return _launch("gather", x, None, starts, None, None, starts.shape[0], W)


def chunk_gather_src2(x, x2, starts, flags, W: int) -> torch.Tensor:
    """chunk_gather from x2 (B, P2) where flags[c] != 0 and from x elsewhere,
    each start clamped into its own buffer."""
    _check_x(x, W)
    _check_x(x2, W, "x2")
    starts, flags = _offsets(x, starts, flags)
    if x.device.type == "cpu":
        return chunk_gather_src2_plain(x, x2, starts, flags, W)
    return _launch("src2", x, x2, starts, flags, None, starts.shape[0], W)


def chunk_gather_blend(x, s0, s1, istar, W: int) -> torch.Tensor:
    """Two chunk gathers split at a per-chunk element: out[b, c, e] is
    x[b, s0[c] + e] for e < istar[c], x[b, s1[c] + e] from there on."""
    _check_x(x, W)
    s0, s1, istar = _offsets(x, s0, s1, istar)
    if x.device.type == "cpu":
        return chunk_gather_blend_plain(x, s0, s1, istar, W)
    return _launch("blend", x, None, s0, s1, istar, s0.shape[0], W)


def chunk_gather_blend_rowlaw(x, NC: int, v: int, vpad: int, Wt: int) -> torch.Tensor:
    """chunk_gather_blend over NC chunks with its offsets computed from the
    chunk index (``rowlaw_offsets``): no offset arrays exist."""
    _check_x(x, Wt)
    if v <= 0 or vpad < v:
        raise ValueError(f"need 0 < v <= vpad, got v={v}, vpad={vpad}")
    if x.device.type == "cpu":
        return chunk_gather_blend_rowlaw_plain(x, NC, v, vpad, Wt)
    return _launch("rowlaw", x, None, None, None, None, NC, Wt, v, vpad)
