"""Single-device state-vector engine on planar torch tensors.

The counterpart of the JAX package's ``sim/engine.py`` for the standard
layout.  PyTorch runs eagerly, so there is no compiled program per circuit;
the engine caches the fused-segment plan per circuit instead.  Backends:

  * ``torch``: every gate through the plain torch ops (``ops/gates.py``),
    per gate.  The CPU path and the spec the kernels are tested against.
  * ``cuda``: the circuit is planned into fused segments
    (``ops/fused.plan_circuit``), each applied by the fused-segment kernel
    in one in-place pass; the gates with no op form (the controlled modular
    multiply) run as torch gathers, as they run as XLA gathers in the JAX
    package.  Measurement of f32 states of >= 2^16 amplitudes goes through
    the block-sum kernel (``ops/measure.py``).
  * ``auto``: ``cuda`` when a CUDA device is present, else ``torch``.

Randomness is injected: every measuring entry point takes its uniform draw
``r`` in [0, 1) as an argument, so one draw can drive both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from quantumcomputer_tpu_torch.models.circuit import (
    DENSE_1Q,
    DIAGONAL_1Q,
    Circuit,
    Gate,
    gate_matrix_1q,
    gate_matrix_2q,
)
from quantumcomputer_tpu_torch.ops import fused
from quantumcomputer_tpu_torch.ops import gates as tops
from quantumcomputer_tpu_torch.ops import measure
from quantumcomputer_tpu_torch.sim import statevec as sv
from quantumcomputer_tpu_torch.utils.memory import device_memory_budget, state_fits


@dataclass(frozen=True)
class Register:
    """Qubit register geometry (qc_shor.c:194-203): L counting qubits in the
    high bits [M, N), M work qubits in the low bits [0, M)."""

    L: int
    M: int

    @property
    def n(self) -> int:
        return self.L + self.M


def apply_gate(state: torch.Tensor, g: Gate, M: int) -> torch.Tensor:
    """Dispatch one Gate onto a flat complex state with the plain ops."""
    name = g.name
    if name in DENSE_1Q:
        return tops.apply_1q(state, gate_matrix_1q(g), g.qubits[0])
    if name in DIAGONAL_1Q:
        return tops.apply_diag_1q(state, np.diagonal(gate_matrix_1q(g)), g.qubits[0])
    if name in ("cz", "cphase"):
        q_hi, q_lo = g.qubits if g.qubits[0] > g.qubits[1] else (g.qubits[1], g.qubits[0])
        return tops.apply_diag_2q(state, np.diagonal(gate_matrix_2q(g)), q_hi, q_lo)
    if name == "mcphase":
        return tops.apply_mcphase(state, g.qubits, g.params[0])
    if name in ("cnot", "swap", "u2q"):
        m = gate_matrix_2q(g)
        q_hi, q_lo = g.qubits
        if q_hi < q_lo:
            q_hi, q_lo = q_lo, q_hi
            p = [0, 2, 1, 3]
            m = m[np.ix_(p, p)]
        return tops.apply_2q(state, m, q_hi, q_lo)
    if name == "camodc":
        C, atox = g.meta
        return tops.apply_c_amodc(state, C, atox, g.qubits[0], M)
    if name == "iqft_stage":
        return tops.apply_iqft_stage(state, g.qubits[0], M)
    raise ValueError(f"gate not supported by quantumcomputer_tpu_torch: {g}")


def _store_(planar: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    planar[0].copy_(z.real)
    planar[1].copy_(z.imag)
    return planar


def apply_gate_planes_(planar: torch.Tensor, g: Gate, M: int) -> torch.Tensor:
    """One gate on a planar state, in place: the oracle as an in-place
    per-plane gather, anything else through the complex plain ops."""
    if g.name == "camodc":
        C, atox = g.meta
        return tops.apply_c_amodc_planes_(planar, C, atox, g.qubits[0], M)
    return _store_(planar, apply_gate(sv.to_complex(planar), g, M))


def apply_circuit_plain_(planar: torch.Tensor, circuit: Circuit, M: int) -> torch.Tensor:
    """The torch backend: every gate through the plain ops; the result is
    written back into `planar`."""
    z = sv.to_complex(planar)
    for g in circuit:
        z = apply_gate(z, g, M)
    return _store_(planar, z)


def apply_circuit_fused_(planar: torch.Tensor, circuit: Circuit, M: int, plan=None) -> torch.Tensor:
    """The cuda backend's path, in place: fused segments through
    fused.apply_fused (the kernel for CUDA tensors, its plain version for
    CPU tensors), single gates through apply_gate_planes_."""
    if plan is None:
        plan = fused.plan_circuit(circuit, sv.num_qubits(planar), M, fused.TILE_BITS[planar.dtype])
    for seg in plan:
        if seg[0] == "fused":
            fused.apply_fused(planar, seg[1], seg[2], M)
        else:
            apply_gate_planes_(planar, seg[1], M)
    return planar


def resolve_backend(backend: str) -> str:
    if backend == "auto":
        return "cuda" if torch.cuda.is_available() else "torch"
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r} (auto, torch or cuda)")
    return backend


class StateVectorEngine:
    """Executes circuits on a (2, 2^n) planar state resident on `device`.

    States are planar real tensors (plane 0 = Re, plane 1 = Im); float32
    planes for complex64, float64 for complex128."""

    def __init__(
        self,
        register: Register,
        dtype=torch.complex64,
        backend: str = "auto",
        device=None,
    ):
        self.backend = resolve_backend(backend)
        if device is None:
            device = "cuda" if self.backend == "cuda" else "cpu"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise ValueError("no CUDA device is available")
        if self.backend == "cuda" and self.device.type != "cuda":
            raise ValueError(f"backend='cuda' runs on a CUDA device, not {self.device}")
        self.register = register
        self.real_dtype = sv.real_dtype_of(dtype)
        self.dtype = torch.complex64 if self.real_dtype == torch.float32 else torch.complex128
        self.layout = "standard"
        self.m_eff = register.M
        if not state_fits(register.n, self.real_dtype, self.device):
            raise ValueError(
                f"a 2^{register.n} state of {self.dtype} does not fit the "
                f"{device_memory_budget(self.device)} usable bytes of {self.device}"
            )
        self._plans: dict = {}

    # -- state lifecycle ----------------------------------------------------

    def initial_state(self) -> torch.Tensor:
        """|00...01> (qc_shor.c:318-324), planar."""
        return sv.initial_planar(self.register.n, self.real_dtype, 1, self.device)

    def logical_index(self, phys: int) -> int:
        """Physical to logical basis index (the identity: standard layout)."""
        return phys

    # -- execution ----------------------------------------------------------

    def _plan(self, circuit: Circuit):
        plan = self._plans.get(circuit)
        if plan is None:
            plan = fused.plan_circuit(
                circuit, self.register.n, self.m_eff, fused.TILE_BITS[self.real_dtype]
            )
            self._plans[circuit] = plan
        return plan

    def run(self, circuit: Circuit, state: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply a circuit and return the planar state.  With no input state
        the run starts from the |0..01> reset.  A caller-supplied `state` is
        CONSUMED: it is updated in place (the counterpart of the JAX
        engine's buffer donation) and returned."""
        if state is None:
            state = self.initial_state()
        if self.backend == "cuda":
            return apply_circuit_fused_(state, circuit, self.m_eff, self._plan(circuit))
        return apply_circuit_plain_(state, circuit, self.m_eff)

    def run_norm(self, circuit: Circuit) -> float:
        """Reset -> circuit -> norm (probability conservation check)."""
        return self.norm(self.run(circuit))

    def run_and_measure_index(self, circuit: Circuit, r: float) -> int:
        """Reset -> circuit -> inverse-CDF measured index for draw r."""
        return self._sample(self.run(circuit), r)

    def run_and_measure(self, circuit: Circuit, r: float) -> Tuple[int, torch.Tensor]:
        """Reset -> circuit -> (measured index, collapsed planar state)."""
        return self.measure(self.run(circuit), r)

    # -- measurement ----------------------------------------------------------

    def _sample(self, planar: torch.Tensor, r: float) -> int:
        return measure.sample_index(planar, r, plain=self.backend == "torch")

    def measure(self, state: torch.Tensor, r: float) -> Tuple[int, torch.Tensor]:
        """Inverse-CDF measurement with draw r, then collapse
        (qc_shor.c:272-306).  CONSUMES `state`: it is overwritten in place
        with the collapsed basis state, which is returned."""
        idx = self._sample(state, r)
        state.zero_()
        state[0, idx] = 1.0
        return idx, state

    def sample(self, state: torch.Tensor, rs) -> torch.Tensor:
        """One basis index per draw in `rs`, without collapsing the state."""
        return torch.tensor([self._sample(state, float(r)) for r in rs], dtype=torch.int64)

    def norm(self, state: torch.Tensor) -> float:
        return float(sv.norm(state))
