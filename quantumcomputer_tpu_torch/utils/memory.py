"""Device memory model: how much memory the engine may plan to hold.

The counterpart of the JAX package's ``utils/memory.py``.  The budget comes
from the engine's own device (``torch.cuda.mem_get_info``); a CPU device
reports none, and then nothing is checked.
"""

from __future__ import annotations

from typing import Optional

import torch

# Fraction of the device's memory one engine may plan to occupy: headroom
# for the allocator's caching, the gather oracle's half-plane temporary and
# the CUDA context.
_USABLE_FRACTION = 0.92


def device_memory_budget(device) -> Optional[int]:
    """Usable bytes on `device` for state planning, or None off CUDA."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    _, total = torch.cuda.mem_get_info(device)
    return int(total * _USABLE_FRACTION)


def state_fits(n: int, real_dtype: torch.dtype, device) -> bool:
    """True when a (2, 2^n) planar state of `real_dtype` plus the oracle's
    half-plane gather temporary fits the device budget (always on CPU)."""
    budget = device_memory_budget(device)
    if budget is None:
        return True
    itemsize = torch.empty((), dtype=real_dtype).element_size()
    state = 2 * (1 << n) * itemsize
    return state + state // 4 <= budget
