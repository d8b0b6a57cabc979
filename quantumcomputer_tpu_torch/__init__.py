"""quantumcomputer_tpu_torch: the state-vector simulator on PyTorch and CUDA.

A port of ``quantumcomputer_tpu`` (JAX, Pallas kernels for the TPU) to
PyTorch, with hand-written CUDA kernels for Hopper (``ops/csrc``).  The JAX
package stays beside it as the reference; this package never imports jax.
The state is a (2, 2^n) planar tensor (plane 0 = Re, plane 1 = Im) on the
engine's device.
"""

from quantumcomputer_tpu_torch.algorithms.amplitude_estimation import amplitude_estimate  # noqa: F401
from quantumcomputer_tpu_torch.algorithms.grover import grover_circuit, grover_search  # noqa: F401
from quantumcomputer_tpu_torch.algorithms.oracle_algorithms import (  # noqa: F401
    bernstein_vazirani,
    deutsch_jozsa,
)
from quantumcomputer_tpu_torch.algorithms.qpe import estimate_phase  # noqa: F401
from quantumcomputer_tpu_torch.algorithms.quantum_volume import run_quantum_volume  # noqa: F401
from quantumcomputer_tpu_torch.algorithms.semiclassical import run_semiclassical  # noqa: F401
from quantumcomputer_tpu_torch.algorithms.shor import (  # noqa: F401
    Outcome,
    ShorResult,
    find_period,
    read_omega,
    shors_algorithm,
)
from quantumcomputer_tpu_torch.algorithms.variational import (  # noqa: F401
    HardwareEfficientAnsatz,
    expectation,
    expectation_on_engine,
    pauli_term,
    qaoa_maxcut,
    vqe,
)
from quantumcomputer_tpu_torch.models import circuit  # noqa: F401
from quantumcomputer_tpu_torch.models.shor_circuit import (  # noqa: F401
    shor_circuit,
    shor_circuit_mhigh,
    shor_circuit_reference,
)
from quantumcomputer_tpu_torch.algorithms.simon import simon_search  # noqa: F401
from quantumcomputer_tpu_torch.parallel.mesh import build_mesh  # noqa: F401
from quantumcomputer_tpu_torch.parallel.sharded import ShardedStateVectorEngine  # noqa: F401
from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine  # noqa: F401

__version__ = "0.3.0"
