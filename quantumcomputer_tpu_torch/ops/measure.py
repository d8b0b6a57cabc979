"""Measurement: |amp|^2 block sums (plain and CUDA) + hierarchical sampler.

The counterpart of the JAX package's ``ops/pallas_measure.py``.  A
two-level inverse-CDF replaces a full-state cumulative scan:

  1. one pass over the planar state computes per-block probability sums
     (``csrc/block_sums.cu`` on the card; the probability vector never
     exists in device memory);
  2. a cumulative scan over the <= 1024 block sums picks the block, and a
     local scan inside the picked block picks the element (torch glue, as
     it is XLA glue in the JAX package).

The result is the smallest index whose cumulative probability reaches
r * total, falling through to the last index.  The draw is scaled by the
total, as in the JAX package.  bf16 ("complex32") states sum in float32,
block sums, scans and draws alike (``statevec.compute_dtype``).
"""

from __future__ import annotations

import torch

from quantumcomputer_tpu_torch.ops import _build
from quantumcomputer_tpu_torch.sim import statevec as sv

LANE = 128
BLOCK_ROWS = 64
MAX_BLOCKS = 1024
# The hierarchical path serves f32 and bf16 states of at least this many amplitudes.
HIERARCHICAL_MIN_DIM = 1 << 16

#: Kernel launches made by block_sums (CUDA tensors only).
LAUNCHES = 0


def block_geom(dim: int) -> tuple:
    """(block_rows, block) for a state of `dim` amplitudes: the JAX
    package's _block_geom, so both packages cut the same blocks."""
    if dim > (1 << 31):
        raise ValueError(
            f"dim = 2^{dim.bit_length() - 1} exceeds the 2^31 index budget of the hierarchical sampler"
        )
    rows = dim // LANE
    block_rows = max(BLOCK_ROWS, rows // MAX_BLOCKS)
    return block_rows, block_rows * LANE


def _nblocks_block(planar: torch.Tensor) -> tuple:
    dim = 1 << sv.num_qubits(planar)
    _, block = block_geom(dim)
    if dim % block:
        raise ValueError(f"state of {dim} amplitudes is too small for the block-sum path")
    return dim // block, block


def block_sums_plain(planar: torch.Tensor) -> torch.Tensor:
    """Per-block sums of |amp|^2, shape (nblocks,), in the compute dtype
    (float32 for bf16 planes)."""
    nblocks, block = _nblocks_block(planar)
    return sv.probabilities(planar).view(nblocks, block).sum(dim=1)


def block_sums(planar: torch.Tensor) -> torch.Tensor:
    """block_sums_plain through the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor; any other device raises."""
    global LAUNCHES
    nblocks, block = _nblocks_block(planar)
    if planar.device.type == "cpu":
        return block_sums_plain(planar)
    if planar.device.type != "cuda":
        raise ValueError(f"no block-sum path for device {planar.device}")
    if planar.dtype not in _build.SUFFIX or not planar.is_contiguous():
        raise TypeError("block sums need a contiguous float32, float64 or bfloat16 planar state")
    out = torch.empty(nblocks, dtype=sv.compute_dtype(planar.dtype), device=planar.device)
    fn = _build.entry("qc_block_sums", planar.dtype)
    with torch.cuda.device(planar.device):
        err = fn(
            planar[0].data_ptr(), planar[1].data_ptr(), out.data_ptr(), nblocks, block,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "block_sums")
    LAUNCHES += 1
    return out


def _first_reaching(cum: torch.Tensor, value: torch.Tensor) -> int:
    """Smallest index with cum >= value, clamped to the last index."""
    idx = int(torch.searchsorted(cum, value.view(1), side="left").item())
    return min(idx, cum.shape[0] - 1)


def sample_index_planes(planar: torch.Tensor, r: float, plain: bool = False) -> int:
    """Hierarchical inverse-CDF sample with draw r in [0, 1).  plain=True
    takes the block sums from block_sums_plain on any device (the torch
    backend's spec path); otherwise from block_sums."""
    sums = block_sums_plain(planar) if plain else block_sums(planar)
    cum = torch.cumsum(sums, 0)
    scaled = torch.as_tensor(r, dtype=cum.dtype, device=cum.device) * cum[-1]
    b = _first_reaching(cum, scaled)
    offset = cum[b] - sums[b]
    _, block = _nblocks_block(planar)
    start = b * block
    local = torch.cumsum(sv.probabilities(planar[:, start : start + block]), 0)
    return start + _first_reaching(local, scaled - offset)


def sample_index_flat(planar: torch.Tensor, r: float) -> int:
    """Flat inverse-CDF sample over the full cumulative sum (small or f64
    states), the draw scaled by the total."""
    cum = torch.cumsum(sv.probabilities(planar), 0)
    return _first_reaching(cum, torch.as_tensor(r, dtype=cum.dtype, device=cum.device) * cum[-1])


def sample_index(planar: torch.Tensor, r: float, plain: bool = False) -> int:
    """The engine's sampler switch (JAX engine._sample_index_planes): f32
    and bf16 states of at least 2^16 amplitudes sample hierarchically, the
    rest flat."""
    if planar.dtype in (torch.float32, torch.bfloat16) and planar.shape[-1] >= HIERARCHICAL_MIN_DIM:
        return sample_index_planes(planar, r, plain)
    return sample_index_flat(planar, r)
