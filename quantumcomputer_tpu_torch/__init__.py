"""quantumcomputer_tpu_torch: the state-vector simulator on PyTorch and CUDA.

A port of ``quantumcomputer_tpu`` (JAX, Pallas kernels for the TPU) to
PyTorch, with hand-written CUDA kernels for Hopper (``ops/csrc``).  The JAX
package stays beside it as the reference; this package never imports jax.
The state is a (2, 2^n) planar tensor (plane 0 = Re, plane 1 = Im) on the
engine's device.
"""

from quantumcomputer_tpu_torch.algorithms.shor import (  # noqa: F401
    Outcome,
    ShorResult,
    find_period,
    read_omega,
    shors_algorithm,
)
from quantumcomputer_tpu_torch.models import circuit  # noqa: F401
from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_reference  # noqa: F401
from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine  # noqa: F401
