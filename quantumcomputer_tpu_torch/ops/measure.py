"""Measurement: |amp|^2 block sums (plain and CUDA) + hierarchical sampler.

The counterpart of the JAX package's ``ops/pallas_measure.py``.  A
two-level inverse-CDF replaces a full-state cumulative scan:

  1. one pass over the planar state computes per-block probability sums
     (``csrc/block_sums.cu`` on the card; the probability vector never
     exists in device memory);
  2. a cumulative scan over the <= 1024 block sums picks the block, and a
     local scan inside the picked block picks the element (torch glue, as
     it is XLA glue in the JAX package).  A batch of draws shares the one
     block-sum pass (``sample_indices_planes``).

The result is the smallest index whose cumulative probability reaches
r * total, falling through to the last index.  The draw is scaled by the
total, as in the JAX package.  bf16 ("complex32") states sum in float32,
block sums, scans and draws alike (``statevec.compute_dtype``).

Up to 2^31 amplitudes the blocks and the scans are the JAX package's,
which stops there (its indices are int32).  The port's indices are int64,
so a larger state (n = 32 on one card) keeps the same block rule, 1024
blocks of 2^22 amplitudes at n = 32, and scans in float64 past the block
sums (``FLOAT64_SCAN_ABOVE``): its blocks are twice the largest a float32
scan has served, and the float64 pick costs one block's worth of work.
"""

from __future__ import annotations

from typing import Optional

import torch

from quantumcomputer_tpu_torch.ops import _build
from quantumcomputer_tpu_torch.sim import statevec as sv

LANE = 128
BLOCK_ROWS = 64
MAX_BLOCKS = 1024
# The hierarchical path serves f32 and bf16 states of at least this many amplitudes.
HIERARCHICAL_MIN_DIM = 1 << 16

#: The JAX package's index budget (int32): up to it both packages sample
#: alike; a larger state's draw, block pick and in-block scan run in float64.
FLOAT64_SCAN_ABOVE = 1 << 31

#: Kernel launches made by block_sums (CUDA tensors only).
LAUNCHES = 0


def block_geom(dim: int) -> tuple:
    """(block_rows, block) for a state of `dim` amplitudes: the JAX
    package's _block_geom up to 2^31 amplitudes, so both packages cut the
    same blocks; past it (where the JAX package raises) the same rule."""
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


def _clamped_search(cum: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Smallest index with cum >= value per value (along cum's last axis),
    clamped to the last index."""
    return torch.searchsorted(cum, values, side="left").clamp_(max=cum.shape[-1] - 1)


def _draws(rs, dtype, device) -> torch.Tensor:
    return torch.as_tensor(rs if isinstance(rs, torch.Tensor) else list(map(float, rs)), dtype=torch.float64).to(
        device=device, dtype=dtype
    ).reshape(-1)


def sample_geometry(planar: torch.Tensor) -> tuple:
    """(blocks, block) of the sampler sample_indices takes for `planar`:
    the hierarchical blocks, or one block of the whole state (flat)."""
    if _hierarchical(planar):
        return _nblocks_block(planar)
    return 1, planar.shape[-1]


def _hierarchical(planar: torch.Tensor) -> bool:
    return planar.dtype in (torch.float32, torch.bfloat16) and planar.shape[-1] >= HIERARCHICAL_MIN_DIM


def sample_indices_planes(
    planar: torch.Tensor,
    rs,
    plain: bool = False,
    absolute: bool = False,
    sums: Optional[torch.Tensor] = None,
    float64_above: int = FLOAT64_SCAN_ABOVE,
) -> torch.Tensor:
    """Hierarchical inverse-CDF samples, one per draw in `rs` (each in
    [0, 1)), without collapsing: ONE block-sum pass for all draws (the
    block sums from block_sums_plain with plain=True, the torch backend's
    spec path; else from block_sums), then for each shot a one-dimensional
    scan of its own block (the JAX package's sample_indices_planes scans
    chunks of shots together).  One block per scan is what makes a shot find
    the same index whether it is drawn alone or in a batch: torch.cumsum on a
    CUDA tensor picks its algorithm and thread layout from the number of
    rows, and rounds differently at knife edges.  It also keeps a lone
    draw's temporaries at one block.  Returns the indices as an int64 CPU
    tensor, after one host sync.

    With `absolute` each draw is a target on the state's own probability
    scale, not scaled by the total (a shard of a sharded state picks at the
    draw less the shards before it); `sums` passes block sums the caller
    already has.  A state of more than `float64_above` amplitudes takes
    the block sums to float64 and scans, draws and picks there, its
    block's probabilities squared in float64 too."""
    if sums is None:
        sums = block_sums_plain(planar) if plain else block_sums(planar)
    nblocks, block = _nblocks_block(planar)
    wide = planar.shape[-1] > float64_above
    if wide:
        sums = sums.to(torch.float64)
    cum = torch.cumsum(sums, 0)
    scaled = _draws(rs, cum.dtype, cum.device)
    if not absolute:
        scaled = scaled * cum[-1]
    b = _clamped_search(cum, scaled)
    target = scaled - (cum[b] - sums[b])
    blocks = planar.view(2, nblocks, block)
    local = []
    for i in range(b.shape[0]):
        picked = blocks.index_select(1, b[i : i + 1]).view(2, block)
        probs = sv.probabilities(picked.to(torch.float64) if wide else picked)
        local.append(_clamped_search(torch.cumsum(probs, 0), target[i : i + 1]))
    return (b * block + torch.cat(local)).cpu()


def sample_indices_flat(planar: torch.Tensor, rs, absolute: bool = False) -> torch.Tensor:
    """Flat inverse-CDF samples over ONE full cumulative sum for all draws
    (small or f64 states), each draw scaled by the total unless
    `absolute`."""
    cum = torch.cumsum(sv.probabilities(planar), 0)
    scaled = _draws(rs, cum.dtype, cum.device)
    return _clamped_search(cum, scaled if absolute else scaled * cum[-1]).cpu()


def sample_indices(
    planar: torch.Tensor, rs, plain: bool = False, absolute: bool = False, sums: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The engine's sampler switch (JAX engine.sample and
    _sample_index_planes): f32 and bf16 states of at least 2^16 amplitudes
    sample hierarchically, the rest flat.  One index per draw in `rs`, as an
    int64 CPU tensor.  `absolute` and `sums` as in sample_indices_planes
    (`sums` serves the hierarchical path only)."""
    if _hierarchical(planar):
        return sample_indices_planes(planar, rs, plain, absolute, sums)
    return sample_indices_flat(planar, rs, absolute)


def sample_index_planes(planar: torch.Tensor, r: float, plain: bool = False) -> int:
    """sample_indices_planes for one draw r."""
    return int(sample_indices_planes(planar, [r], plain)[0])


def sample_index_flat(planar: torch.Tensor, r: float) -> int:
    """sample_indices_flat for one draw r."""
    return int(sample_indices_flat(planar, [r])[0])


def sample_index(planar: torch.Tensor, r: float, plain: bool = False) -> int:
    """sample_indices for one draw r: the index the draw gets in a batch."""
    return int(sample_indices(planar, [r], plain)[0])
