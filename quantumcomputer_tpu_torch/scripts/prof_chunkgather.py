"""Microbenchmarks of the unaligned chunk-gather primitive on the card.

The port of the JAX package's ``scripts/prof_chunkgather.py``, its probe
kernels in ``ops/probes.py`` (``csrc/probes.cu``).  Rows, on one float32
plane of 2^M elements cut into chunks of W:

  copy       chunk copy at identity starts (the copy ceiling)
  aligned    the same kernel at random 1024-aligned starts
  roll2      chunks at arbitrary starts, realigned in shared memory
  mxuroll    the same, the lane rotation as a tensor-core product
  transpose  ops/transpose.tiled_transpose_padded at the JAX script's shapes

Each row: kernel ms per call (CUDA events), GB/s for one read and one write,
ok = exactly equal to the plain version, and the plain version's ms.

    python -m quantumcomputer_tpu_torch.scripts.prof_chunkgather   # PROF_M=26 PROF_W=16384 by default
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from quantumcomputer_tpu_torch.ops import probes
from quantumcomputer_tpu_torch.ops import transpose as tr
from quantumcomputer_tpu_torch.scripts import probe_row

TRANSPOSE_SHAPES = ((8192, 8192), (16384, 4096), (4100, 16384))


def chunk_rows(M: int = 26, W: int = 16384, reps: int = 5, seed: int = 0, device="cuda") -> list:
    """The four chunk-gather rows on a seeded 2^M plane."""
    dim = 1 << M
    nc = dim // W
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(dim, generator=gen, device=device)
    rng = np.random.default_rng(seed)

    def starts_for(align):
        if align is None:
            s = np.arange(nc) * W
        else:
            s = rng.integers(0, dim - W - 1024, nc) // align * align
        return torch.from_numpy(s.astype(np.int32)).to(device)

    nbytes = 2 * dim * 4
    rows = []
    for name, fn, plain, align in (
        ("copy    ", probes.chunk_copy, probes.chunk_copy_plain, None),
        ("aligned ", probes.chunk_copy, probes.chunk_copy_plain, 1024),
        ("roll2   ", probes.chunk_roll2, probes.chunk_gather_plain, 1),
        ("mxuroll ", probes.chunk_mxuroll, probes.chunk_gather_plain, 1),
    ):
        st = starts_for(align)
        rows.append(probe_row(name, lambda: fn(x, st, W), lambda: plain(x, st, W), nbytes, device, reps))
    return rows


def transpose_rows(shapes=TRANSPOSE_SHAPES, reps: int = 5, seed: int = 0, device="cuda") -> list:
    """The tiled transpose at each (R, C) shape, as (1, R, C) float32."""
    rows = []
    for shape in shapes:
        gen = torch.Generator(device=device).manual_seed(seed)
        y = torch.randn((1,) + tuple(shape), generator=gen, device=device)
        rows.append(
            probe_row(
                f"transpose {shape}", lambda: tr.tiled_transpose_padded(y), lambda: tr.transpose_plain(y),
                2 * y.numel() * 4, device, reps,
            )
        )
    return rows


def run(M: int = 26, W: int = 16384, reps: int = 5, device="cuda", shapes=TRANSPOSE_SHAPES) -> list:
    rows = chunk_rows(M, W, reps, device=device) + transpose_rows(shapes, reps, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("prof_chunkgather: no CUDA device is available; it times kernels on the card", file=sys.stderr)
        return 1
    M = int(os.environ.get("PROF_M", "26"))
    W = int(os.environ.get("PROF_W", "16384"))
    print(f"prof_chunkgather: M={M} W={W} on {torch.cuda.get_device_name(0)}", flush=True)
    rows = run(M, W)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
