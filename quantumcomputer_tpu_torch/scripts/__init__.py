"""Microbenchmark scripts of the port, run as modules on a CUDA card:

    python -m quantumcomputer_tpu_torch.scripts.prof_chunkgather
    python -m quantumcomputer_tpu_torch.scripts.prof_rowperm

Each row holds one kernel (or one plain torch formulation) against its
reference on the same input: ``ok`` is exact equality.  Times are CUDA
events on the card; on a CPU device the rows are checked and not timed
(their times read "not measured"), which is how the tests run them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def exact_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference of two tensors that must be equal (inf on a shape
    mismatch)."""
    if got.shape != want.shape:
        return float("inf")
    return float((got - want).abs().max()) if got.numel() else 0.0


def probe_row(
    name: str,
    fn: Callable[[], torch.Tensor],
    reference: Callable[[], torch.Tensor],
    nbytes: int,
    device,
    reps: int = 5,
    time_reference: bool = True,
) -> dict:
    """Check fn() against reference() exactly and, on a CUDA device, time
    both (profiling.cuda_ms: mean of `reps` calls after a warm-up).
    `nbytes` is the memory traffic of one call, for the GB/s column.
    Prints the row and returns it as a dict."""
    from quantumcomputer_tpu_torch.utils.profiling import cuda_ms

    err = exact_err(fn(), reference())
    ms: Optional[float] = None
    ref_ms: Optional[float] = None
    if torch.device(device).type == "cuda":
        ms = cuda_ms(fn, reps)
        if time_reference:
            ref_ms = cuda_ms(reference, reps)
    row = {
        "name": name, "ms": ms, "gbps": nbytes / (ms * 1e6) if ms else None,
        "ok": err == 0.0, "max_abs_err": err, "plain_ms": ref_ms,
    }
    timing = "not measured" if ms is None else f"{ms:8.3f} ms  ({row['gbps']:7.1f} GB/s 1R+1W)"
    plain = f"  plain {ref_ms:.3f} ms" if ref_ms is not None else ""
    print(f"{name}: {timing}  ok={row['ok']}{plain}", flush=True)
    return row
