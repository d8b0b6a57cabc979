"""The strip pass (quantumcomputer_tpu_torch/ops/oracle.py,
apply_camodc_run_inplace_planar; csrc/oracle_strip.cu on the card) and the
engine's merging of adjacent complex32 walks into it, against the JAX
package on the same seeded inputs.

A run of K controlled modular multiplies is the same gates applied one by
one, and the pass only moves data, so the port's plain version (the CPU
path) must equal the JAX package's XLA apply_camodc_high gate by gate, and
its Pallas cycle kernel in interpret mode, exactly, on float32 and bf16
planes.  The engine's merged run must equal its plan applied entry by entry
bit for bit, and the JAX complex32 m_high engine within the complex32
circuit bound (tests/test_torch_complex32.py).  The kernel itself is held
against the plain version on the card by
quantumcomputer_tpu_torch/utils/kernel_checks.py (strip_runs), run by
chip_smoke.py."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.models.shor_circuit import shor_circuit_mhigh as jshor_circuit_mhigh
from quantumcomputer_tpu.ops import gates as xops
from quantumcomputer_tpu.ops import pallas_oracle as po
from quantumcomputer_tpu.sim import engine as jengine
from quantumcomputer_tpu_torch import interop
from quantumcomputer_tpu_torch.models import circuit as cir
from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit_mhigh
from quantumcomputer_tpu_torch.ops import oracle
from quantumcomputer_tpu_torch.sim import engine
from quantumcomputer_tpu_torch.sim import statevec as sv

CIRCUIT_TOL = 2e-3  # tests/test_complex32.py:35, the complex32 Shor circuit bound
NP_DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _planes(rng, n, dtype):
    return rng.standard_normal((2, 1 << n)).astype(NP_DTYPES[dtype])


def _run_controls(rng, kind, bits):
    """A run's controls: 2, 5 or all `bits` column bits, controls 0-3 among
    them, in a seeded unsorted order."""
    K = {"two": 2, "five": 5, "all": bits}[kind]
    low = list(range(min(K, 4)))
    high = [int(c) for c in rng.choice(np.arange(4, bits), K - len(low), replace=False)]
    return tuple(int(c) for c in rng.permutation(low + high))


def _bits(x: np.ndarray) -> np.ndarray:
    """The raw bits of float32 or bf16 planes (interop.state_to_numpy gives
    bf16 planes as their uint16 bits already)."""
    if x.dtype == np.uint16:
        return x
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x.view(np.uint32)


# (n, M, C, a): n = 12-18, M = 6-10, C below 2^M.
RUN_CASES = [(12, 6, 33, 7), (14, 8, 251, 13), (16, 10, 1021, 3), (18, 9, 509, 3), (17, 7, 127, 5)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["two", "five", "all"])
@pytest.mark.parametrize("n,M,C,a", RUN_CASES)
def test_plain_run_equals_jax_gate_by_gate(n, M, C, a, kind, dtype):
    rng = np.random.default_rng(n * 100 + M)
    controls = _run_controls(rng, kind, n - M)
    A_list = tuple(pow(a, 1 << k, C) for k in range(len(controls)))
    x = _planes(rng, n, dtype)
    want = [jnp.asarray(p) for p in x]
    for c, A in zip(controls, A_list):
        want = [xops.apply_camodc_high(p, C, A, c, M) for p in want]
    state = interop.state_from_numpy(x)
    before = dict(oracle.LAUNCHES)
    got = oracle.apply_camodc_run_inplace_planar(state, C, A_list, controls, M)
    assert got is state and got.dtype == getattr(torch, dtype)
    assert oracle.LAUNCHES == before  # the plain version: no kernel on a CPU tensor
    np.testing.assert_array_equal(_bits(interop.state_to_numpy(got)), _bits(np.stack([np.asarray(w) for w in want])))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_run_equals_the_pallas_cycle_kernel_gate_by_gate(dtype):
    """The JAX package's cycle kernel (interpret mode, as its suite runs it)
    applied gate by gate, at controls 3 and 0 (unsorted)."""
    C, a, M, n, controls = 33, 29, 6, 13, (3, 0)
    A_list = tuple(pow(a, 1 << k, C) for k in range(len(controls)))
    x = _planes(np.random.default_rng(7), n, dtype)
    re, im = jnp.asarray(x[0]), jnp.asarray(x[1])
    for c, A in zip(controls, A_list):
        re, im = po.apply_camodc_high_cycle_planar(re, im, C, A, c, M)
    got = oracle.apply_camodc_run_inplace_planar(interop.state_from_numpy(x), C, A_list, controls, M)
    np.testing.assert_array_equal(_bits(interop.state_to_numpy(got)), _bits(np.stack([np.asarray(re), np.asarray(im)])))


# ---------------------------------------------------------------------------
# The engine: runs of adjacent bf16 walks merge into one strip pass.

MHIGH = (33, 29, 8, 6)  # C, a, L, M: n = 14, the eight oracles all single walks


def _count_runs(monkeypatch) -> list:
    calls = []
    run = oracle.apply_camodc_run_inplace_planar

    def counted(planar, C, A_list, controls, M, **kw):
        calls.append(tuple(controls))
        return run(planar, C, A_list, controls, M, **kw)

    monkeypatch.setattr(oracle, "apply_camodc_run_inplace_planar", counted)
    return calls


def _amps(planar) -> np.ndarray:
    """Complex128 amplitudes of a JAX or port state, bf16 widened exactly."""
    a = planar.float().numpy() if isinstance(planar, torch.Tensor) else np.asarray(planar).astype(np.float32)
    return a[0].astype(np.float64) + 1j * a[1].astype(np.float64)


def _mhigh_c32(norms=None, nan_checks=False, dtype=torch.bfloat16):
    C, a, L, M = MHIGH
    n = L + M
    circuit = shor_circuit_mhigh(C, a, L, M)
    plan = engine.plan_circuit(circuit, 0, n, dtype, "cpu")
    state = sv.initial_planar(n, dtype, 1 << L)
    return engine.apply_circuit_fused_(state, circuit, 0, plan, norms=norms, nan_checks=nan_checks), plan


def test_engine_merges_the_walks_into_one_strip_pass(monkeypatch):
    calls = _count_runs(monkeypatch)
    merged, plan = _mhigh_c32()
    walks = [e[1].qubits[0] for e in plan if e[0] == "single" and e[1].name == "camodc_high"]
    assert walks == list(range(8)) and calls == [tuple(walks)]
    per_entry, _ = _mhigh_c32(norms=[])
    assert len(calls) == 1  # with norms, no merge
    assert torch.equal(merged, per_entry)
    C, a, L, M = MHIGH
    j32 = jengine.StateVectorEngine(jengine.Register(L=L, M=M), dtype="complex32", backend="pallas", layout="m_high")
    want = j32.run(jshor_circuit_mhigh(C, a, L, M))
    assert np.abs(_amps(merged) - _amps(want)).max() < CIRCUIT_TOL


def test_norms_and_nan_checks_keep_one_entry_per_plan_step(monkeypatch):
    calls = _count_runs(monkeypatch)
    norms = []
    _, plan = _mhigh_c32(norms=norms)
    assert len(norms) == len(plan) and all(v.dtype == torch.float32 for v in norms)
    _mhigh_c32(nan_checks=True)
    assert calls == []


def test_float32_planes_never_merge(monkeypatch):
    calls = _count_runs(monkeypatch)
    state, _ = _mhigh_c32(dtype=torch.float32)
    assert state.dtype == torch.float32 and calls == []


def _single(c, C=33, A=29, M=6):
    return ("single", cir.Gate("camodc_high", (c,), meta=(C, A, M)))


def test_strip_run_takes_only_adjacent_bf16_walks():
    """Runs stop at a fused segment, a perm_supported gate, another C or
    work register, and a repeated control; a lone walk is a run of one,
    which the engine leaves to the walk."""
    n = 21
    planar = torch.zeros((2, 1 << n), dtype=torch.bfloat16)
    assert not oracle.perm_supported(13, 6, n, 2) and oracle.perm_supported(14, 6, n, 2)
    seg = ("fused", (), ())
    plan = [_single(0), _single(3), seg, _single(5), _single(14), _single(2), _single(1), _single(2),
            _single(4, C=35), _single(6), _single(7, M=7)]
    runs = [[g.qubits[0] for g in engine.strip_run(planar, plan, i)] for i in range(len(plan))]
    assert runs == [[0, 3], [3], [], [5], [], [2, 1], [1, 2], [2], [4], [6], [7]]
    assert engine.strip_run(planar.float(), plan, 0) == []


def test_lone_and_perm_supported_gates_keep_their_kernels(monkeypatch):
    calls = _count_runs(monkeypatch)
    walked = []
    monkeypatch.setattr(oracle, "apply_camodc_high_cycle_planar", lambda p, *a: walked.append(a[2]) or p)
    permuted = []
    monkeypatch.setattr(oracle, "apply_camodc_high_perm_planar", lambda p, *a: permuted.append(a[2]) or p)
    n = 21
    planar = torch.zeros((2, 1 << n), dtype=torch.bfloat16)
    plan = [_single(3), _single(14), _single(5)]  # lone walk, perm_supported gate, lone walk
    engine.apply_circuit_fused_(planar, (), 0, plan)
    assert calls == [] and walked == [3, 5] and permuted == [14]


def test_flagship_plans_merge_their_walks_into_one_run():
    """At n = 28 (C = 8191, M = 13) the complex32 m_high plan's twelve walks
    (controls 0-11) form one run; below two states' memory its fourteen
    (0-13) do, and control 14 stays the masked walk."""
    C, a, L, M = 8191, 3, 15, 13
    n = L + M
    circuit = shor_circuit_mhigh(C, a, L, M)
    planar = torch.empty((2, 1 << n), dtype=torch.bfloat16, device="meta")
    for budget, want in ((None, list(range(12))), (str(2 * (1 << n) * 2 * 3 // 2), list(range(14)))):
        with pytest.MonkeyPatch.context() as mp:
            if budget is not None:
                mp.setenv("QC_TPU_HBM_BYTES", budget)
            plan = engine.plan_circuit(circuit, 0, n, torch.bfloat16, "cpu")
        first = next(i for i, e in enumerate(plan) if e[0] == "single")
        assert [g.qubits[0] for g in engine.strip_run(planar, plan, first)] == want


# ---------------------------------------------------------------------------
# The wrapper's limits, which it takes on every device.


def test_strip_run_supported_limits():
    room = oracle.STRIP_ROOM_SM90
    assert oracle.strip_run_supported(13, 28, 2, True, room)
    assert oracle.strip_run_supported(13, 28, 4, True, room)
    assert not oracle.strip_run_supported(14, 28, 2, True, room)  # 2^14 x 16 bytes exceed a block's shared memory
    assert not oracle.strip_run_supported(13, 28, 8, True, room)  # no float64 instance
    assert not oracle.strip_run_supported(13, 28, 2, False, room)
    assert oracle.strip_run_supported(6, 10, 2, True, room) and not oracle.strip_run_supported(6, 9, 2, True, room)
    assert not oracle.strip_run_supported(13, 28, 2, True, 100 * 1024)  # a smaller card's room


def test_strip_room_and_width():
    """A CPU run takes the H100's room; 32-byte strips where C of their rows
    fit it (C = 4093 at M = 12), else 16-byte ones (C = 8191 at M = 13)."""
    assert oracle.strip_room(torch.device("cpu")) == oracle.STRIP_ROOM_SM90 == 232448 - 1024
    assert oracle.strip_room(torch.device("meta")) == oracle.STRIP_ROOM_SM90
    assert oracle.strip_bytes(4093, oracle.STRIP_ROOM_SM90) == 32
    assert oracle.strip_bytes(8191, oracle.STRIP_ROOM_SM90) == 16


# Runs whose strip pass and walks were both timed at n = 28, bf16, on an H100
# (scripts/prof_strip.py, PERF.md §6): (C, controls, pass ms, walks' sum ms).
# Where the two lie within 5% of each other either choice is right.
TIMED_RUNS = [
    (8191, (0,), 1.6223, 0.8224),
    (8191, (0, 1, 2), 1.6359, 2.4766),
    (8191, (4, 5), 1.4008, 1.2136),
    (8191, (4, 5, 6), 1.4896, 1.7299),
    (8191, (6, 7), 1.2395, 0.9890),
    (8191, (8, 9), 1.2431, 0.9168),
    (8191, (8, 9, 10, 11), 1.5255, 1.8300),
    (8191, (11, 12), 1.2387, 0.9517),
    (8191, tuple(range(12)), 1.6425, 7.3931),
    (4093, (0, 1), 1.2833, 1.6384),
    (4093, (4, 5), 1.0437, 1.2107),
    (4093, (8, 9, 10), 1.1227, 1.3732),
    (4093, tuple(range(12)), 1.2715, 7.3759),
]


@pytest.mark.parametrize("C,controls,strip_ms,walks_ms", TIMED_RUNS)
def test_strip_pays_where_the_card_measured_it_faster(C, controls, strip_ms, walks_ms):
    assert oracle.strip_pays(controls, C, 2, oracle.STRIP_ROOM_SM90) == (strip_ms < walks_ms)


@pytest.mark.parametrize("C", [8191, 4093, 33])
@pytest.mark.parametrize("control", [0, 3, 4, 9])
def test_strip_pays_never_for_a_lone_gate(C, control):
    assert not oracle.strip_pays((control,), C, 2, oracle.STRIP_ROOM_SM90)


def test_wrapper_validates_its_arguments():
    n, C, M = 16, 33, 6
    state = interop.state_from_numpy(_planes(np.random.default_rng(3), n, "bfloat16"))
    with pytest.raises(ValueError, match="distinct controls"):
        oracle.apply_camodc_run_inplace_planar(state, C, (7, 4), (2, 2), M)
    with pytest.raises(ValueError, match="distinct controls"):
        oracle.apply_camodc_run_inplace_planar(state, C, (), (), M)
    with pytest.raises(ValueError, match="shared memory"):
        oracle.apply_camodc_run_inplace_planar(torch.zeros((2, 1 << 18), dtype=torch.bfloat16), C, (7, 4), (0, 1), 14)
    buf = torch.zeros(2 * (1 << n) + 8, dtype=torch.bfloat16)
    unaligned = buf[1:1 + (2 << n)].view(2, 1 << n)
    with pytest.raises(ValueError, match="16-byte aligned"):
        oracle.apply_camodc_run_inplace_planar(unaligned, C, (7, 4), (0, 1), M)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        oracle.apply_camodc_run_inplace_planar(state.double(), C, (7, 4), (0, 1), M)
    with pytest.raises(ValueError, match="not unitary"):
        oracle.apply_camodc_run_inplace_planar(state, 65, (7, 4), (0, 1), M)
    with pytest.raises(ValueError, match="column bits"):
        oracle.apply_camodc_run_inplace_planar(state, C, (7, 4), (0, n - M), M)
    with pytest.raises(ValueError, match="no strip path for device meta"):
        oracle.apply_camodc_run_inplace_planar(torch.empty((2, 1 << n), dtype=torch.bfloat16, device="meta"),
                                               C, (7, 4), (0, 1), M)
