"""Variational algorithms: Pauli observables, differentiable ansätze, VQE, QAOA.

The counterpart of the JAX package's ``algorithms/variational.py``, with its
names and signatures in PyTorch idiom.  The parameters are tensors, the
state evolution is plain torch (the JAX package leaves it to XLA), and
gradients come from autograd straight through the evolution: exact, one
backward pass a step whatever the parameter count.
``expectation_on_engine`` measures an observable through an engine's gate
path instead (``engine.run``, the fused kernel on the card).  QAOA on a
CUDA device runs through the engine too (``qaoa_step``): the mixers as
fused segments, the cost layer and the adjoint gradient's reductions as the
kernels of ``ops/qaoa.py``, with two states live whatever p; the CPU keeps
the tape evolution (``algorithms/qaoa_plain.py``).

Layout conventions match the engine (``sim/statevec.py``): qubit b is bit b
of the basis index, LSB-first; states are planar (2, 2^n) real tensors, and
the arithmetic runs on a flat complex64 / complex128 tensor.

Randomness is explicit: ``initial_parameters`` draws from a
``torch.Generator``, ``vqe`` and ``qaoa_maxcut`` seed one from ``seed`` or
take the initial parameters as an argument (``jax.random`` and torch draw
different numbers, so a test passes the JAX package's draws in).  Every
entry point runs on ``device``: the CUDA device when one is present and none
is named, else the CPU; all arithmetic stays there, with one host fetch of
the energy a step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from quantumcomputer_tpu_torch.models import circuit as cir
from quantumcomputer_tpu_torch.sim import statevec as sv

# ---------------------------------------------------------------------------
# Pauli-string observables
# ---------------------------------------------------------------------------

#: A Pauli term: (coefficient, ((qubit, 'X'|'Y'|'Z'), ...)).  Identity on all
#: unlisted qubits; the empty tuple is the identity term.
PauliTerm = Tuple[float, Tuple[Tuple[int, str], ...]]


def pauli_term(coeff: float, ops: Dict[int, str] | Iterable[Tuple[int, str]]) -> PauliTerm:
    """Normalize a {qubit: 'X'|'Y'|'Z'} mapping into a canonical PauliTerm."""
    items = ops.items() if isinstance(ops, dict) else ops
    norm = tuple(sorted((int(q), s.upper()) for q, s in items))
    seen = [q for q, _ in norm]
    if len(set(seen)) != len(seen):
        raise ValueError(f"duplicate qubit in Pauli term: {norm}")
    for q, s in norm:
        if s not in ("X", "Y", "Z"):
            raise ValueError(f"not a Pauli axis: {s!r}")
        if q < 0:
            raise ValueError(f"negative qubit index: {q}")
    return (float(coeff), norm)


def _qubit_view(z: torch.Tensor, q: int) -> torch.Tensor:
    # Bit q of the flat index as the middle axis of a (hi, 2, lo) view: axis
    # n-1-q of the C-order (2,)*n tensor, without one dimension a qubit.
    return z.reshape(-1, 2, 1 << q)


def apply_pauli(z: torch.Tensor, ops: Tuple[Tuple[int, str], ...], n: int) -> torch.Tensor:
    """P|psi> for a Pauli string, as flips and phases on the qubits' axes
    (new tensors, differentiable).  X_q reverses qubit q's axis; Y_q reverses
    it with the [-i, +i] phase pair; Z_q is the diagonal [+1, -1].  `z` is a
    flat (2^n,) complex tensor."""
    t = z
    for q, s in ops:
        if not 0 <= q < n:
            raise ValueError(f"qubit {q} out of range for n={n}")
        v = _qubit_view(t, q)
        if s == "X":
            v = torch.flip(v, dims=(1,))
        elif s == "Y":
            # After the flip, new[b] = old[1-b]; Y wants new[1] = i*old[0],
            # new[0] = -i*old[1]  =>  phase [-i, +i] along the axis.
            phase = torch.tensor([-1j, 1j], dtype=t.dtype, device=t.device).reshape(1, 2, 1)
            v = torch.flip(v, dims=(1,)) * phase
        else:  # Z
            sign = torch.tensor([1.0, -1.0], dtype=t.real.dtype, device=t.device).reshape(1, 2, 1)
            v = v * sign
        t = v.reshape(-1)
    return t


def expectation(planar: torch.Tensor, terms: Sequence[PauliTerm]) -> torch.Tensor:
    """<psi| H |psi> for H = sum_k c_k P_k, from a planar (2, 2^n) state, as
    a 0-d real tensor of the planes' dtype (summed in the compute dtype:
    float32 for bf16 planes).  Plain torch, differentiable in `planar`."""
    n = sv.num_qubits(planar)
    z = sv.to_complex(planar)
    acc = torch.zeros((), dtype=sv.compute_dtype(planar.dtype), device=planar.device)
    for coeff, ops in terms:
        pz = apply_pauli(z, ops, n) if ops else z
        acc = acc + coeff * torch.vdot(z, pz).real
    return acc.to(planar.dtype)


def _re_inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re <a|b> of two planar states, sum(ar br + ai bi), as one dot product
    over both planes (no state-sized temporaries): bf16 planes widen to and
    accumulate in float32 (bf16 sums lose everything); f32 / f64 keep their
    own precision."""
    acc = sv.compute_dtype(a.dtype)
    return torch.dot(a.reshape(-1).to(acc), b.reshape(-1).to(acc))


def expectation_on_engine(engine, state: torch.Tensor, terms: Sequence[PauliTerm]) -> float:
    """<psi| H |psi> through an ENGINE's gate path: each Pauli string is
    applied as X / Y / Z gates by `engine.run` (the fused kernel on the
    card), on a fresh copy of `state`, then one inner product.  Peak memory
    is two states (|psi> and P|psi>).  `state` is not consumed."""
    gate_of = {"X": cir.X, "Y": cir.Y, "Z": cir.Z}
    state = state.detach()
    total = 0.0
    for coeff, ops in terms:
        if not ops:
            total += coeff * float(_re_inner(state, state))
            continue
        pz = engine.run(tuple(gate_of[s](q) for q, s in ops), state.clone())
        total += coeff * float(_re_inner(state, pz))
        del pz
    return total


def dense_hamiltonian(terms: Sequence[PauliTerm], n: int) -> np.ndarray:
    """Dense 2^n x 2^n matrix of a Pauli-sum — test/diagnostic oracle only
    (exact ground energies for small n); never used on the compute path."""
    paulis = {
        "I": np.eye(2, dtype=np.complex128),
        "X": np.array([[0, 1], [1, 0]], dtype=np.complex128),
        "Y": np.array([[0, -1j], [1j, 0]], dtype=np.complex128),
        "Z": np.array([[1, 0], [0, -1]], dtype=np.complex128),
    }
    H = np.zeros((1 << n, 1 << n), dtype=np.complex128)
    for coeff, ops in terms:
        by_q = dict(ops)
        m = np.eye(1, dtype=np.complex128)
        # Tensor order: qubit n-1 is the most-significant index bit.
        for q in range(n - 1, -1, -1):
            m = np.kron(m, paulis[by_q.get(q, "I")])
        H += coeff * m
    return H


# ---------------------------------------------------------------------------
# Model Hamiltonians
# ---------------------------------------------------------------------------


def tfim_hamiltonian(n: int, J: float = 1.0, h: float = 1.0, periodic: bool = False) -> List[PauliTerm]:
    """Transverse-field Ising chain: H = -J sum Z_q Z_{q+1} - h sum X_q."""
    terms = [pauli_term(-J, {q: "Z", q + 1: "Z"}) for q in range(n - 1)]
    if periodic and n > 2:
        terms.append(pauli_term(-J, {n - 1: "Z", 0: "Z"}))
    terms.extend(pauli_term(-h, {q: "X"}) for q in range(n))
    return terms


def heisenberg_hamiltonian(n: int, J: float = 1.0) -> List[PauliTerm]:
    """Heisenberg XXX chain: H = J sum (X X + Y Y + Z Z) on neighbors."""
    terms: List[PauliTerm] = []
    for q in range(n - 1):
        for s in ("X", "Y", "Z"):
            terms.append(pauli_term(J, {q: s, q + 1: s}))
    return terms


# ---------------------------------------------------------------------------
# Differentiable state evolution primitives (tensor angles)
# ---------------------------------------------------------------------------


def _rot_y(z: torch.Tensor, q: int, n: int, theta: torch.Tensor) -> torch.Tensor:
    """RY(theta) on qubit q with a tensor angle: the qubit as the length-2
    axis of a view, the 2x2 rotation as two multiply-adds."""
    t = _qubit_view(z, q)
    c = torch.cos(theta / 2).to(z.real.dtype)
    s = torch.sin(theta / 2).to(z.real.dtype)
    a, b = t[:, 0, :], t[:, 1, :]
    return torch.stack([c * a - s * b, s * a + c * b], dim=1).reshape(-1)


def _rot_x(z: torch.Tensor, q: int, n: int, theta: torch.Tensor) -> torch.Tensor:
    """RX(theta) on qubit q with a tensor angle."""
    t = _qubit_view(z, q)
    c = torch.cos(theta / 2).to(z.real.dtype)
    s = torch.sin(theta / 2).to(z.real.dtype)
    a, b = t[:, 0, :], t[:, 1, :]
    return torch.stack([c * a - 1j * s * b, -1j * s * a + c * b], dim=1).reshape(-1)


def _rot_z(z: torch.Tensor, q: int, n: int, theta: torch.Tensor) -> torch.Tensor:
    """RZ(theta) on qubit q with a tensor angle (diagonal phase pair)."""
    t = _qubit_view(z, q)
    half = (theta / 2).to(z.real.dtype)
    ph = torch.exp(1j * torch.stack([-half, half])).reshape(1, 2, 1)
    return (t * ph).reshape(-1)


_ROT = {"X": _rot_x, "Y": _rot_y, "Z": _rot_z}


def _on_pair(n: int, a: int, b: int, table: np.ndarray) -> np.ndarray:
    """A symmetric 2x2 table over (bit a, bit b), shaped to broadcast over
    the (2,)*n view of a flat 2^n vector (bit q is axis n-1-q); for a == b
    its diagonal over the one bit."""
    shape = [1] * n
    shape[n - 1 - a] = shape[n - 1 - b] = 2
    return (np.diagonal(table) if a == b else table).reshape(shape)


def _cz_ring_signs(n: int, pairs: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Combined diagonal of a CZ entangler layer: the product of per-pair
    (-1)^{bit_a & bit_b} signs, built on the host once as ONE f32 vector so
    the whole entangler is a single elementwise multiply on the device.
    Each pair is one broadcast multiply over the (2,)*n view (the JAX
    package's per-index form gives the same vector)."""
    sign = np.ones(1 << n, dtype=np.float32)
    view = sign.reshape((2,) * n)
    for a, b in pairs:
        view *= _on_pair(n, int(a), int(b), np.array([[1.0, 1.0], [1.0, -1.0]], dtype=np.float32))
    return sign


@dataclasses.dataclass(frozen=True)
class HardwareEfficientAnsatz:
    """RY + brick-CZ hardware-efficient ansatz with tensor parameters.

    depth entangling layers; parameters shape (depth + 1, n).  Layer k:
    RY(theta[k, q]) on every qubit, then a CZ brick layer — even layers
    entangle pairs (0,1),(2,3),..., odd layers (1,2),(3,4),... plus the
    ring closure (n-1,0).  A final RY layer closes.  The brick alternation
    matters: a uniform all-pairs CZ ring every layer leaves an invariant
    subspace the optimizer cannot leave (the JAX package's measurement:
    TFIM n=4 ground-state fidelity caps at 0.981 for ANY depth with the
    ring, reaches >0.9999 at depth 3 with bricks); `entangler='ring'` keeps
    the uniform layer for comparison.  Real amplitudes throughout (RY and
    CZ are real); pass `rotation='XY'` for alternating RX / RY layers when
    complex amplitudes are needed."""

    n: int
    depth: int
    rotation: str = "Y"  # 'Y' | 'XY'
    entangler: str = "brick"  # 'brick' | 'ring'
    # The entangler diagonals on the device, built at first use:
    # (layer parity, dtype, device) -> tensor.
    _signs: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def parameter_shape(self) -> Tuple[int, int]:
        """Shape of the parameter tensor `apply` expects: (depth + 1, n)."""
        return (self.depth + 1, self.n)

    @property
    def num_parameters(self) -> int:
        """Total parameter COUNT (the shape lives at `parameter_shape`)."""
        return (self.depth + 1) * self.n

    def initial_parameters(self, generator: torch.Generator, scale: float = 0.1) -> torch.Tensor:
        """float32 normals times `scale`, drawn from `generator` (a CPU
        generator gives a CPU tensor)."""
        return scale * torch.randn(self.parameter_shape, generator=generator, dtype=torch.float32)

    def _pairs(self, layer: int) -> List[Tuple[int, int]]:
        n = self.n
        if n < 2:
            return []
        if self.entangler == "ring":
            pairs = [(q, q + 1) for q in range(n - 1)]
            if n > 2:
                pairs.append((n - 1, 0))
            return pairs
        if layer % 2 == 0:
            return [(q, q + 1) for q in range(0, n - 1, 2)]
        pairs = [(q, q + 1) for q in range(1, n - 1, 2)]
        if n > 2:
            pairs.append((n - 1, 0))
        return pairs

    def _layer_signs(self, parity: int, rdtype: torch.dtype, device) -> torch.Tensor:
        key = (parity, rdtype, torch.device(device))
        if key not in self._signs:
            self._signs[key] = torch.as_tensor(_cz_ring_signs(self.n, self._pairs(parity)), dtype=rdtype).to(device)
        return self._signs[key]

    def apply(self, thetas: torch.Tensor, rdtype: torch.dtype = torch.float32) -> torch.Tensor:
        """|psi(theta)> from |0...0>, returned planar (2, 2^n) on
        `thetas`'s device; differentiable in `thetas`."""
        n, depth, device = self.n, self.depth, thetas.device
        z = torch.zeros(1 << n, dtype=sv.complex_dtype_of(rdtype), device=device)
        z[0] = 1.0
        signs = [self._layer_signs(parity, sv.compute_dtype(rdtype), device) for parity in (0, 1)]

        def rot_layer(z, k, row):
            kind = "Y" if self.rotation == "Y" or (k % 2 == 0) else "X"
            for q in range(n):
                z = _ROT[kind](z, q, n, row[q])
            return z

        for k in range(depth):
            z = rot_layer(z, k, thetas[k])
            z = z * signs[k % 2 if self.entangler == "brick" else 0]
        z = rot_layer(z, depth, thetas[depth])
        return sv.from_complex(z)


def _device(device) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


# ---------------------------------------------------------------------------
# VQE
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VQEResult:
    energy: float
    parameters: np.ndarray
    energies: np.ndarray  # per-step trace
    n: int
    depth: int
    steps: int

    @property
    def state(self) -> Optional[np.ndarray]:  # populated by vqe()
        return getattr(self, "_state", None)


def vqe(
    terms: Sequence[PauliTerm],
    n: int,
    depth: int = 3,
    steps: int = 300,
    learning_rate: float = 0.05,
    ansatz: Optional[HardwareEfficientAnsatz] = None,
    rdtype: torch.dtype = torch.float32,
    restarts: int = 1,
    initial_parameters: Optional[Sequence] = None,
    seed: int = 0,
    device=None,
) -> VQEResult:
    """Minimize <psi(theta)| H |psi(theta)> by Adam over exact gradients.

    Each step: the ansatz, the energy, one backward pass and one Adam update
    (torch.optim.Adam, betas (0.9, 0.999), eps 1e-8: optax.adam's update),
    with the energy fetched to the host for the trace.  The parameters are
    float32, as the JAX package's are, whatever `rdtype`.

    `restarts` runs independent Adam trajectories from initial parameters
    of growing scale (0.1 + 0.35 r) and keeps the one of least final energy
    — the defense against the barren / local minima a hardware-efficient
    ansatz is prone to.  `initial_parameters` gives one array per restart;
    without it they are drawn in turn from a CPU torch.Generator seeded
    with `seed`."""
    device = _device(device)
    ans = ansatz or HardwareEfficientAnsatz(n, depth)
    restarts = max(1, restarts)
    if initial_parameters is not None and len(initial_parameters) < restarts:
        raise ValueError(f"{restarts} restarts need {restarts} initial parameter arrays, got {len(initial_parameters)}")
    gen = torch.Generator().manual_seed(int(seed))

    def energy(th):
        return expectation(ans.apply(th, rdtype), terms)

    best: Optional[VQEResult] = None
    for r in range(restarts):
        if initial_parameters is None:
            theta0 = ans.initial_parameters(gen, scale=0.1 + 0.35 * r)
        else:
            theta0 = torch.tensor(np.asarray(initial_parameters[r]), dtype=torch.float32)
        theta = theta0.to(device).requires_grad_()
        opt = torch.optim.Adam([theta], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        trace = np.zeros(steps, dtype=np.float64)
        for i in range(steps):
            opt.zero_grad(set_to_none=True)
            e = energy(theta)
            e.backward()
            opt.step()
            trace[i] = float(e.detach())
        with torch.no_grad():
            final = float(energy(theta))
            if best is None or final < best.energy:
                best = VQEResult(
                    energy=final, parameters=theta.detach().cpu().numpy(), energies=trace,
                    n=n, depth=ans.depth, steps=steps,
                )
                best._state = sv.to_numpy_complex(ans.apply(theta, rdtype))
    return best


# ---------------------------------------------------------------------------
# QAOA (MaxCut)
# ---------------------------------------------------------------------------


def random_regular_graph(n: int, degree: int = 3, seed: int = 0) -> List[Tuple[int, int]]:
    """The edges (a < b, sorted) of a random `degree`-regular graph on n
    vertices by the pairing model: n * degree stubs shuffled by a numpy
    Generator seeded with `seed` and paired in order, the draw repeated
    until it has no loop and no double edge."""
    if (n * degree) % 2 or degree >= n:
        raise ValueError(f"no {degree}-regular graph on {n} vertices")
    rng = np.random.default_rng(int(seed))
    while True:
        stubs = np.repeat(np.arange(n), degree)
        rng.shuffle(stubs)
        pairs = [tuple(sorted((int(a), int(b)))) for a, b in stubs.reshape(-1, 2)]
        if all(a != b for a, b in pairs) and len(set(pairs)) == len(pairs):
            return sorted(pairs)


def maxcut_cost_vector(n: int, edges: Sequence[Tuple[int, int]] | Sequence[Tuple[int, int, float]]) -> np.ndarray:
    """Cut size of every basis assignment, built on the host: the QAOA cost
    Hamiltonian is diagonal, so it lives as one f32 vector and both the
    phase separator and the expectation are single elementwise passes.
    Each edge adds float32(w) where its bits differ, as one broadcast add
    over the (2,)*n view, in edge order: the JAX package's vector bit for
    bit."""
    cost = np.zeros(1 << n, dtype=np.float32)
    view = cost.reshape((2,) * n)
    for e in edges:
        a, b = int(e[0]), int(e[1])
        w = float(e[2]) if len(e) > 2 else 1.0
        view += _on_pair(n, a, b, np.array([[0.0, w], [w, 0.0]], dtype=np.float32))
    return cost


@dataclasses.dataclass
class QAOAResult:
    best_bitstring: int
    best_cut: float
    expected_cut: float
    optimal_cut: float
    approximation_ratio: float
    parameters: np.ndarray  # (2, p): gammas; betas
    expectations: np.ndarray  # per-step trace


def qaoa_initial_parameters(p: int, seed: int = 0) -> torch.Tensor:
    """(2, p) float32: gammas 0.1 + 0.05 N(0, 1) then betas 0.4 + 0.05 N(0, 1),
    drawn from a CPU torch.Generator seeded with `seed`."""
    gen = torch.Generator().manual_seed(int(seed))
    gammas = 0.1 + 0.05 * torch.randn(p, generator=gen, dtype=torch.float32)
    betas = 0.4 + 0.05 * torch.randn(p, generator=gen, dtype=torch.float32)
    return torch.stack([gammas, betas])


def qaoa_engine(n: int, dtype=torch.complex64, device=None):
    """The engine a QAOA step runs on: an n-qubit register with no work
    register (Register(n, 0)); the cuda backend (fused segments) on a CUDA
    device, the torch backend (plain ops) on the CPU.  `dtype` complex64,
    complex128 or "complex32" (bf16 planes, on the card)."""
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    device = _device(device)
    backend = "cuda" if device.type == "cuda" else "auto"
    return StateVectorEngine(Register(n, 0), dtype=dtype, backend=backend, device=device)


def _qaoa_forward(engine, table, phases, mixers) -> torch.Tensor:
    """|psi(gamma, beta)> from |+>^n on the engine's device: each layer k the
    cost phase (one pass, ops/qaoa.apply_phase, with phases[k]) then the
    mixer (ops/qaoa.apply_mixer, with mixers[k]: the fused segments on the
    card)."""
    from quantumcomputer_tpu_torch.ops import qaoa as qops
    from quantumcomputer_tpu_torch.utils import profiling

    dev = engine.device
    psi = qops.plus_state(engine.register.n, engine.real_dtype, dev)
    for k in range(len(mixers)):
        with profiling.span("qaoa.cost", dev, bytes=2 * qops.state_bytes(psi) + table.levels.numel()):
            qops.apply_phase(psi, table, phases[k])
        qops.apply_mixer(psi, mixers[k])
    return psi


def qaoa_step(engine, table, params) -> Tuple[float, np.ndarray]:
    """One evaluation of the QAOA MaxCut objective and its exact gradient by
    the adjoint method, through the engine: returns (the expected cut,
    the (2, p) float64 gradient in gammas; betas) after one host read.

    The forward runs |+>^n through p layers (the cost phase, ops/qaoa.py,
    and the mixer's RX(2 beta) gates as the engine's fused segments, planned
    once and given the step's angles at launch) and reads E = sum |psi|^2 c
    while it writes lambda = C psi.  The backward walks the layers down:
    dE/dbeta_k = 2 Im <lambda|sum_q X_q|psi> (ops/qaoa.mixer_grad, a pass a
    tile group), the mixer undone on psi and on lambda (its segments with
    RX(-2 beta)), dE/dgamma_k = 2 Im <lambda|C|psi> in the pass that undoes
    the cost layer on both (ops/qaoa.cost_grad; the last layer's writes are
    skipped).  Two states live at once, whatever p; the step's angles go to
    the device in two copies at its start, and no plan or descriptor is
    made after the first step.  `table` is an ops/qaoa.CostTable on the
    engine's device; `params` a (2, p) array of gammas and betas (host
    numbers)."""
    from quantumcomputer_tpu_torch.ops import qaoa as qops
    from quantumcomputer_tpu_torch.utils import profiling

    prm = np.asarray(params, dtype=np.float64)
    gammas, betas = prm[0], prm[1]
    p, n, dev, dtype = prm.shape[1], engine.register.n, engine.device, engine.real_dtype
    with profiling.span("qaoa.step", dev), torch.no_grad():
        phases = qops.phase_tables(table.K, np.concatenate([gammas, gammas]), 1.0, dtype, dev)
        phases[:p, :, 1].neg_()  # exp(-i gamma k) forward, exp(+i gamma k) to undo
        mixers = qops.mixer_values(n, np.concatenate([betas, -betas]), dtype, dev)
        with profiling.span("qaoa.forward", dev):
            psi = _qaoa_forward(engine, table, phases, mixers[:p])
        with profiling.span("qaoa.expect", dev):
            lam = torch.empty_like(psi)
            energy = qops.expect(psi, table, lam)
        grad = torch.empty((2, p), dtype=torch.float64, device=dev)
        groups = qops.mixer_groups(n, dtype)
        sb = qops.state_bytes(psi)
        with profiling.span("qaoa.backward", dev):
            for k in reversed(range(p)):
                with profiling.span("qaoa.grad", dev, bytes=2 * sb * len(groups), passes=len(groups)):
                    grad[1, k] = 2.0 * sum(qops.mixer_grad(psi, lam, g) for g in groups)
                qops.apply_mixer(psi, mixers[p + k])
                qops.apply_mixer(lam, mixers[p + k])
                write = k > 0
                with profiling.span("qaoa.grad", dev, bytes=(4 if write else 2) * sb + table.levels.numel(), passes=1):
                    grad[0, k] = 2.0 * qops.cost_grad(psi, lam, table, phases[p + k], write)
        out = torch.cat([energy.view(1), grad.view(-1)]).cpu().numpy()
    return float(out[0]), out[1:].reshape(2, p)


class QAOAOptimizer:
    """Adam over qaoa_step's gradients: the card route of qaoa_maxcut.
    `step()` evaluates the objective and its gradient at the current
    parameters and takes one Adam step (torch.optim.Adam on the float32
    parameters on the host, betas (0.9, 0.999), eps 1e-8, maximize=True);
    it returns (the expected cut, the gradient) at the parameters it
    started from."""

    def __init__(self, engine, table, params0, learning_rate: float = 0.05):
        self.engine, self.table = engine, table
        self.params = torch.tensor(np.asarray(params0), dtype=torch.float32).requires_grad_()
        self.opt = torch.optim.Adam([self.params], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, maximize=True)

    def step(self) -> Tuple[float, np.ndarray]:
        energy, grad = qaoa_step(self.engine, self.table, self.params.detach().numpy())
        self.params.grad = torch.from_numpy(grad).to(torch.float32)
        self.opt.step()
        return energy, grad


def qaoa_maxcut(
    n: int,
    edges: Sequence[Tuple[int, int]] | Sequence[Tuple[int, int, float]],
    p: int = 2,
    steps: int = 200,
    learning_rate: float = 0.05,
    initial_parameters=None,
    seed: int = 0,
    device=None,
) -> QAOAResult:
    """QAOA for MaxCut: |+>^n at complex64, p alternating (phase-separator,
    RX-mixer) layers with angles (gamma, beta), Adam-maximized expected cut.

    The route follows the device.  On a CUDA device each step is qaoa_step:
    the engine's fused segments for the mixers, the cost table and its
    kernels built on the card, the adjoint gradient, then Adam on the host
    (QAOAOptimizer); memory stays at two states whatever p.  Its cost table
    takes whole weights >= 0 summing under 256 and raises ValueError for
    any other edges (ops/qaoa.CostTable).  Elsewhere the evolution is plain torch with tape
    autograd (algorithms/qaoa_plain.py) on a host-built cost vector: the
    JAX package's computation.  Either way the expectation is
    sum(|psi|^2 * c) and Adam takes betas (0.9, 0.999), eps 1e-8.
    `initial_parameters` is a (2, p) array (gammas; betas); without it
    qaoa_initial_parameters(p, seed)."""
    from quantumcomputer_tpu_torch.algorithms import qaoa_plain
    from quantumcomputer_tpu_torch.ops import qaoa as qops

    device = _device(device)
    if initial_parameters is None:
        params0 = qaoa_initial_parameters(p, seed)
    else:
        params0 = torch.tensor(np.asarray(initial_parameters), dtype=torch.float32)

    if device.type == "cuda":
        engine = qaoa_engine(n, device=device)
        table = qops.CostTable(n, edges, device)
        run = QAOAOptimizer(engine, table, params0, learning_rate)
        trace = np.array([run.step()[0] for _ in range(steps)], dtype=np.float64)
        params = run.params.detach()
        prm = params.numpy().astype(np.float64)
        with torch.no_grad():
            phases = qops.phase_tables(table.K, prm[0], -1.0, engine.real_dtype, device)
            mixers = qops.mixer_values(n, prm[1], engine.real_dtype, device)
            psi = _qaoa_forward(engine, table, phases, mixers)
            e_final = float(qops.expect(psi, table))
            best = int(torch.argmax(psi[0].float() ** 2 + psi[1].float() ** 2))
            best_cut = float(table.levels[best])
            optimal = float(table.optimal())
    else:
        cost_np = maxcut_cost_vector(n, edges)
        optimal = float(cost_np.max())
        cost = torch.from_numpy(cost_np).to(device)
        params, trace = qaoa_plain.optimize(cost, n, params0, steps, learning_rate)
        with torch.no_grad():
            e_final, probs = qaoa_plain.expected_cut(cost, n, params)
            best = int(torch.argmax(probs))
        e_final = float(e_final)
        best_cut = float(cost_np[best])
    return QAOAResult(
        best_bitstring=best,
        best_cut=best_cut,
        expected_cut=e_final,
        optimal_cut=optimal,
        approximation_ratio=e_final / optimal if optimal > 0 else 1.0,
        parameters=params.detach().cpu().numpy(),
        expectations=trace,
    )
