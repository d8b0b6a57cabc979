"""Probe kernels of the chunk-gather and lane-rotate microbenchmarks:
wrappers and plain versions.

The counterparts of the Pallas probes in the JAX package's
``scripts/prof_chunkgather.py`` (``_copy_kernel``, ``_roll2_kernel``,
``_mxuroll_kernel``) and ``scripts/prof_rowperm.py`` (``kern``, ``kern2``).
The CUDA kernels are ``csrc/probes.cu``; the scripts that time them are
``quantumcomputer_tpu_torch/scripts/prof_chunkgather.py`` and
``prof_rowperm.py``.  float32 planes and int32 starts or shifts, as on the
TPU:

  chunk_copy(x, s, W)      out[i*W + e] = x[(s_i >> 10 << 10) + e]
  chunk_roll2(x, s, W)     out[i*W + e] = x[s_i + e]
  chunk_mxuroll(x, s, W)   the same function; the lane rotation is a
                           tensor-core product with a permutation matrix
  dynroll(x3, c)           (B, 8, 128): out[b,k,l] = x[b,k,(l + c_b) mod 128]
  rowroll(x3, c)           out[b,k,l] = x[b,k,(l + c_{8b+k}) mod 128]

x is flat for the chunk probes, with len(x) and W multiples of 1024 (the
TPU probes' (8, 128) tiles); every start is clamped into [0, len(x) - W],
by the kernels and the plain versions alike, so any start is memory-safe
and both agree on the whole output.

Each wrapper takes the plain version for a CPU tensor, launches its kernel
for a CUDA tensor at every size, and raises for any other device.
``LAUNCHES`` counts kernel launches per probe.
"""

from __future__ import annotations

import torch

from quantumcomputer_tpu_torch.ops import _build

#: Kernel launches per probe (CUDA tensors only).
LAUNCHES = {"copy": 0, "roll2": 0, "mxuroll": 0, "dynroll": 0, "rowroll": 0}

TILE = 1024  # floats of one (8, 128) tile
LANE = 128


def _device_kind(x: torch.Tensor, what: str) -> str:
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no {what} probe path for device {x.device}")
    return kind


def _check_f32(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{what} must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _chunk_starts(x: torch.Tensor, starts: torch.Tensor, W: int) -> torch.Tensor:
    """Validate a chunk probe's arguments; the starts as contiguous int32 on
    x's device."""
    _check_f32(x, "x")
    if x.dim() != 1:
        raise ValueError(f"x must be a flat plane, got shape {tuple(x.shape)}")
    if W <= 0 or W % TILE or x.numel() % TILE or x.numel() < W:
        raise ValueError(f"W={W} and len(x)={x.numel()} must be multiples of {TILE} with W <= len(x)")
    if starts.dim() != 1 or starts.numel() == 0:
        raise ValueError("starts must be a non-empty 1-D tensor")
    return starts.to(device=x.device, dtype=torch.int32).contiguous()


def _gather_chunks(x: torch.Tensor, base: torch.Tensor, W: int) -> torch.Tensor:
    return x[(base[:, None] + torch.arange(W, device=x.device)).reshape(-1)]


def chunk_copy_plain(x: torch.Tensor, starts: torch.Tensor, W: int) -> torch.Tensor:
    """out[i*W + e] = x[clamp(s_i >> 10 << 10) + e]."""
    s = _chunk_starts(x, starts, W).to(torch.int64)
    return _gather_chunks(x, ((s >> 10) << 10).clamp(0, x.numel() - W), W)


def chunk_gather_plain(x: torch.Tensor, starts: torch.Tensor, W: int) -> torch.Tensor:
    """out[i*W + e] = x[clamp(s_i) + e]: the function of roll2 and mxuroll."""
    s = _chunk_starts(x, starts, W).to(torch.int64)
    return _gather_chunks(x, s.clamp(0, x.numel() - W), W)


def _chunk_probe(name: str, x: torch.Tensor, starts: torch.Tensor, W: int, plain) -> torch.Tensor:
    s = _chunk_starts(x, starts, W)
    if _device_kind(x, name) == "cpu":
        return plain(x, s, W)
    if x.data_ptr() % 16:
        raise ValueError(f"the {name} probe needs a 16-byte aligned plane")
    out = torch.empty(s.numel() * W, dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = getattr(lib, f"qc_probe_{name}")(
            x.data_ptr(), s.data_ptr(), out.data_ptr(), x.numel(), s.numel(), W,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, f"probe {name}")
    LAUNCHES[name] += 1
    return out


def chunk_copy(x: torch.Tensor, starts: torch.Tensor, W: int) -> torch.Tensor:
    """Chunk copy from 1024-aligned tiles (``_copy_kernel``)."""
    return _chunk_probe("copy", x, starts, W, chunk_copy_plain)


def chunk_roll2(x: torch.Tensor, starts: torch.Tensor, W: int) -> torch.Tensor:
    """Chunks at arbitrary starts, realigned in shared memory (``_roll2_kernel``)."""
    return _chunk_probe("roll2", x, starts, W, chunk_gather_plain)


def chunk_mxuroll(x: torch.Tensor, starts: torch.Tensor, W: int) -> torch.Tensor:
    """Chunks at arbitrary starts, the lane rotation on the tensor cores
    (``_mxuroll_kernel``)."""
    return _chunk_probe("mxuroll", x, starts, W, chunk_gather_plain)


def _roll_shifts(x: torch.Tensor, shifts: torch.Tensor, per_row: bool) -> torch.Tensor:
    _check_f32(x, "x")
    if x.dim() != 3 or tuple(x.shape[1:]) != (8, LANE):
        raise ValueError(f"x must be (B, 8, {LANE}), got {tuple(x.shape)}")
    want = x.shape[0] * (8 if per_row else 1)
    if shifts.dim() != 1 or shifts.numel() != want:
        raise ValueError(f"shifts must be 1-D of length {want}, got {tuple(shifts.shape)}")
    return shifts.to(device=x.device, dtype=torch.int32).contiguous()


def _roll_plain(x: torch.Tensor, shifts: torch.Tensor, per_row: bool) -> torch.Tensor:
    c = _roll_shifts(x, shifts, per_row).to(torch.int64)
    c = c.view(-1, 8) if per_row else c[:, None].expand(-1, 8)
    lanes = (torch.arange(LANE, device=x.device) + c[..., None]) % LANE
    return torch.gather(x, 2, lanes)


def dynroll_plain(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """out[b,k,l] = x[b,k,(l + c_b) mod 128]: one shift per 8-row block."""
    return _roll_plain(x, shifts, False)


def rowroll_plain(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """out[b,k,l] = x[b,k,(l + c_{8b+k}) mod 128]: one shift per row."""
    return _roll_plain(x, shifts, True)


def _roll_probe(name: str, x: torch.Tensor, shifts: torch.Tensor, per_row: bool) -> torch.Tensor:
    c = _roll_shifts(x, shifts, per_row)
    if _device_kind(x, name) == "cpu":
        return _roll_plain(x, c, per_row)
    out = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = getattr(lib, f"qc_probe_{name}")(
            x.data_ptr(), c.data_ptr(), out.data_ptr(), x.shape[0], torch.cuda.current_stream(x.device).cuda_stream
        )
    _build.check(err, f"probe {name}")
    LAUNCHES[name] += 1
    return out


def dynroll(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """The lane roll with one shift per 8-row block (``kern``)."""
    return _roll_probe("dynroll", x, shifts, False)


def rowroll(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """The lane roll with one shift per row (``kern2``)."""
    return _roll_probe("rowroll", x, shifts, True)
