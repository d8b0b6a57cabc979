"""Device memory model: how much memory the engine may plan to hold.

The counterpart of the JAX package's ``utils/memory.py``.  The budget comes
from the ``QC_TPU_HBM_BYTES`` override when it is set (any device, as in the
JAX package: tests and unusual deployments), else from the engine's own
device (``torch.cuda.mem_get_info``); a CPU device reports none, and then
nothing is checked.  A sharded state's gates (``mesh_fits``) count every
shard that shares a physical card against that card's one budget.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

# Fraction of the device's memory one engine may plan to occupy: headroom
# for the allocator's caching, the gather oracle's half-plane temporary and
# the CUDA context.
_USABLE_FRACTION = 0.92


def device_memory_budget(device) -> Optional[int]:
    """Usable bytes on `device` for state planning, or None off CUDA when
    no override is set."""
    env = os.environ.get("QC_TPU_HBM_BYTES")
    if env:
        try:
            val = int(env)
        except ValueError:
            val = -1
        if val > 0:
            return val
        from quantumcomputer_tpu_torch.utils.logging import get_logger

        get_logger("memory").warning(
            "ignoring invalid QC_TPU_HBM_BYTES=%r (want a positive byte count)", env
        )
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


def _states_fit(k: int, M: int, real_dtype: torch.dtype, device) -> bool:
    budget = device_memory_budget(device)
    if budget is None:
        return True
    itemsize = torch.empty((), dtype=real_dtype).element_size()
    return k * (2 * (1 << M) * itemsize) <= budget


def fused_attempt_fits(M: int, real_dtype: torch.dtype, device) -> bool:
    """True when FOUR (2, 2^M) work-register states fit the budget: the
    semiclassical structured step's envelope (the state, the rotated
    branch and the permutation legs' plane-sized transients), the JAX
    package's 4-state ``fused_attempt_fits``."""
    return _states_fit(4, M, real_dtype, device)


def step_program_fits(M: int, real_dtype: torch.dtype, device) -> bool:
    """True when THREE (2, 2^M) work-register states fit the budget: the
    semiclassical gather step's envelope (state, rotated branch and their
    temporaries), the JAX package's 3-state ``step_program_fits``."""
    return _states_fit(3, M, real_dtype, device)


def two_state_programs_fit(n: int, real_dtype: torch.dtype, device) -> bool:
    """True when TWO (2, 2^n) planar states of `real_dtype` fit the budget
    (always on a CPU device with no override): the one predicate for "the
    out-of-place ladder kernel fits", as in the JAX package's engine."""
    return _states_fit(2, n, real_dtype, device)


def mesh_fits(states: float, n_local: int, real_dtype: torch.dtype, mesh) -> bool:
    """True when `states` buffers of one (2, 2^n_local) shard, for every
    shard of `mesh`, fit each card's budget: the shards that share a
    physical card (several virtual shards on one card, in one process or
    in several) are counted together, so each shard's budget is its card's
    divided among them.  The budgets are the mesh's, recorded when it was
    built (over several processes, gathered from all), so every process
    decides alike.  Always true for devices with no budget (CPU with no
    override)."""
    itemsize = torch.empty((), dtype=real_dtype).element_size()
    shard = 2 * (1 << n_local) * itemsize
    for card, count in mesh.cards().items():
        budget = mesh.budgets[card]
        if budget is not None and count * states * shard > budget:
            return False
    return True
