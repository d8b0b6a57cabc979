"""The strip pass (quantumcomputer_tpu_torch/ops/oracle.py,
apply_camodc_run_inplace_planar; csrc/oracle_strip.cu on the card) and the
engine's merging of adjacent complex32 walks into it, against the JAX
package on the same seeded inputs.

A run of K controlled modular multiplies is the same gates applied one by
one, and the pass only moves data, so the port's plain version (the CPU
path) must equal the JAX package's XLA apply_camodc_high gate by gate, and
its Pallas cycle kernel in interpret mode, exactly, on float32 and bf16
planes.  The engine merges a plan's adjacent cycle walks and out-of-place
ladders into one pass where oracle.strip_pays says so; the merged run must
equal its plan applied entry by entry bit for bit, and the JAX complex32
m_high engine within the complex32 circuit bound
(tests/test_torch_complex32.py).  The kernel itself is held
against the plain version on the card by
quantumcomputer_tpu_torch/utils/kernel_checks.py (strip_runs), run by
chip_smoke.py."""

import math

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
# The engine: runs of adjacent walks and ladders merge into one strip pass.

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


def test_float32_planes_merge_where_strip_pays(monkeypatch):
    """complex64 planes merge their walks as bf16 planes do, bit for bit
    equal to the plan applied entry by entry; where strip_pays says no, the
    walks run one by one."""
    calls = _count_runs(monkeypatch)
    merged, plan = _mhigh_c32(dtype=torch.float32)
    assert merged.dtype == torch.float32 and calls == [tuple(range(8))]
    per_entry, _ = _mhigh_c32(norms=[], dtype=torch.float32)
    assert torch.equal(merged, per_entry)
    monkeypatch.setattr(oracle, "strip_pays", lambda *a: False)
    walked, _ = _mhigh_c32(dtype=torch.float32)
    assert len(calls) == 1 and torch.equal(walked, per_entry)


LADDER_MHIGH = (21, 2, 15, 5)  # C, a, L, M: n = 20, walks then an out-of-place ladder


@pytest.mark.parametrize("dtype,walks", [(torch.float32, 11), (torch.bfloat16, 12)])
def test_a_ladder_joins_the_run_with_no_scratch_state(monkeypatch, dtype, walks):
    """The plan's walks (controls 0-10 at float32, 0-11 at bf16) and the
    ladder after them (the rest up to 14) run as one strip pass on the
    input planes, which apply_circuit_fused_ returns, with no ladder launch
    and no second state; bit for bit the plan applied entry by entry, whose
    ladder runs out of place."""
    C, a, L, M = LADDER_MHIGH
    n = L + M
    circuit = shor_circuit_mhigh(C, a, L, M)
    plan = engine.plan_circuit(circuit, 0, n, dtype, "cpu")
    singles = [e[1] for e in plan if e[0] == "single"]
    assert [g.name for g in singles] == ["camodc_high"] * walks + ["camodc_ladder_high"]
    assert singles[-1].qubits == tuple(range(walks, L))
    calls = _count_runs(monkeypatch)
    ladders = []
    ladder = oracle.apply_camodc_ladder_high_planar
    monkeypatch.setattr(oracle, "apply_camodc_ladder_high_planar",
                        lambda p, out, *a: ladders.append(a) or ladder(p, out, *a))
    state = sv.initial_planar(n, dtype, 1 << L)
    merged = engine.apply_circuit_fused_(state, circuit, 0, plan)
    assert merged is state and calls == [tuple(range(L))] and ladders == []
    state = sv.initial_planar(n, dtype, 1 << L)
    per_entry = engine.apply_circuit_fused_(state, circuit, 0, plan, norms=[])
    assert per_entry is not state and len(ladders) == 1  # the ladder's scratch state holds the result
    assert torch.equal(merged, per_entry)


def _single(c, C=33, A=29, M=6):
    return ("single", cir.Gate("camodc_high", (c,), meta=(C, A, M)))


def test_strip_run_takes_only_adjacent_bf16_walks():
    """Runs stop at a fused segment, a perm_supported gate, another C or
    work register, and a repeated control; a lone walk is a run of one,
    which the engine leaves to the walk.  float32 planes take the same runs,
    float64 planes none."""
    n = 21
    planar = torch.zeros((2, 1 << n), dtype=torch.bfloat16)
    assert not oracle.perm_supported(13, 6, n, 2) and oracle.perm_supported(14, 6, n, 2)
    seg = ("fused", (), ())
    plan = [_single(0), _single(3), seg, _single(5), _single(14), _single(2), _single(1), _single(2),
            _single(4, C=35), _single(6), _single(7, M=7)]
    runs = [[g.qubits[0] for g in engine.strip_run(planar, plan, i)] for i in range(len(plan))]
    assert runs == [[0, 3], [3], [], [5], [], [2, 1], [1, 2], [2], [4], [6], [7]]
    wide = planar.float()
    assert [[g.qubits[0] for g in engine.strip_run(wide, plan, i)] for i in range(len(plan))] == runs
    assert engine.strip_run(planar.double(), plan, 0) == []


def _ladder(controls, C=33, M=6, A=29):
    return ("single", cir.Gate("camodc_ladder_high", tuple(controls), meta=(C, M) + (A,) * len(controls)))


def test_strip_run_takes_out_of_place_ladders():
    """A ladder joins the walks around it where its controls are new and
    its C and work register the run's; an in-place pair (no second state
    to save) and a ladder on another C end a run."""
    n = 21
    planar = torch.zeros((2, 1 << n), dtype=torch.float32)
    assert oracle.pair_inplace_supported((13, 14), 6, n, 4) and not oracle.pair_inplace_supported((11, 12), 6, n, 4)
    plan = [_single(0), _single(1), _ladder((11, 12)), _single(2), _ladder((1, 3)), _single(4), _ladder((5, 6), C=35),
            _single(7), _ladder((13, 14))]
    runs = [[g.qubits for g in engine.strip_run(planar, plan, i)] for i in range(len(plan))]
    assert runs[0] == [(0,), (1,), (11, 12), (2,)]
    assert runs[4] == [(1, 3), (4,)] and runs[6] == [(5, 6)] and runs[7] == [(7,)] and runs[8] == []


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
    (controls 0-11) and its ladder (12-14) form one run; below two states'
    memory its fourteen walks (0-13) do, and control 14 stays the masked
    walk.  The complex64 plan's eleven walks (0-10) and its ladder form one
    run, at n = 28 (ladder 11-14) as at n = 32 (11-18)."""
    C, a, M = 8191, 3, 13
    cases = (
        (15, torch.bfloat16, None, list(range(15)), 13),
        (15, torch.bfloat16, 1.5, list(range(14)), 14),
        (15, torch.float32, None, list(range(15)), 12),
        (19, torch.float32, None, list(range(19)), 12),
    )
    for L, dtype, budget_states, want, entries in cases:
        n = L + M
        circuit = shor_circuit_mhigh(C, a, L, M)
        planar = torch.empty((2, 1 << n), dtype=dtype, device="meta")
        with pytest.MonkeyPatch.context() as mp:
            if budget_states is not None:
                mp.setenv("QC_TPU_HBM_BYTES", str(int(budget_states * planar.element_size() * (2 << n))))
            plan = engine.plan_circuit(circuit, 0, n, dtype, "cpu")
        first = next(i for i, e in enumerate(plan) if e[0] == "single")
        run = engine.strip_run(planar, plan, first)
        assert [c for g in run for c in g.qubits] == want and len(run) == entries


def _pass_bytes_by_masks(C, A_list, n, M, itemsize):
    """oracle.pass_bytes's in-place count mask by mask: every nonzero mask
    of K controls, its composed multiplier mu, C - gcd(mu - 1, C) rows."""
    moved = 0
    for m in range(1, 1 << len(A_list)):
        mu = 1
        for k, A in enumerate(A_list):
            if m >> k & 1:
                mu = mu * A % C
        moved += C - math.gcd(mu - 1, C)
    return 2 * 2 * itemsize * moved << (n - M - len(A_list))


@pytest.mark.parametrize("C,M", [(8191, 13), (21, 5), (15, 4), (33, 6), (8187, 13)])
@pytest.mark.parametrize("K", [1, 2, 5, 11])
def test_pass_bytes_counts_masks_by_their_product(C, M, K):
    """The count by products mod C equals the count mask by mask, also for
    multipliers that share a factor with C (no permutation)."""
    rng = np.random.default_rng(C * 100 + K)
    A_list = tuple(int(a) for a in rng.integers(1, C, K))
    for itemsize in (2, 4):
        assert oracle.pass_bytes(C, A_list, 28, M, itemsize, True) == _pass_bytes_by_masks(C, A_list, 28, M, itemsize)
    assert oracle.pass_bytes(C, A_list, 28, M, 4, False) == 2 * 2 * 4 << 28


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
    walks = [(c,) for c in controls]
    assert oracle.strip_pays(walks, C, 2, oracle.STRIP_ROOM_SM90, 28) == (strip_ms < walks_ms)


def _walks(lo, hi):
    return tuple((c,) for c in range(lo, hi))


# Runs of plan entries (a control: a walk; a tuple: a ladder out of place)
# whose strip pass and entries were both timed on an H100, at both item
# sizes and at n = 28 and 32 (scripts/prof_strip.py, PERF.md §6): (n, item
# size, C, entries, pass ms, entries' sum ms).  Where the two lie within 2%
# of each other either choice is right.  At n = 32 the float32 pass reads
# 0.31 of the memory rate against 0.415 at n = 28, and still beats the
# complex64 plan's eleven walks and ladder by 3.4 times.
TIMED_RUNS_WIDE = [
    (28, 2, 8191, _walks(0, 2), 1.5736, 1.6524),
    (28, 2, 8191, _walks(0, 3), 1.5883, 2.4869),
    (28, 2, 8191, _walks(2, 4), 1.5821, 1.6635),
    (28, 2, 8191, _walks(3, 5), 1.5767, 1.5034),
    (28, 2, 8191, _walks(4, 6), 1.3375, 1.2333),
    (28, 2, 8191, _walks(4, 7), 1.4581, 1.7403),
    (28, 2, 8191, _walks(6, 8), 1.1969, 0.9852),
    (28, 2, 8191, _walks(6, 9), 1.3879, 1.4545),
    (28, 2, 8191, _walks(8, 10), 1.2128, 0.9318),
    (28, 2, 8191, _walks(8, 11), 1.4267, 1.4155),
    (28, 2, 8191, _walks(8, 12), 1.5108, 1.8699),
    (28, 2, 8191, _walks(11, 13), 1.2038, 0.9516),
    (28, 2, 8191, _walks(11, 14), 1.3891, 1.4027),
    (28, 2, 8191, _walks(12, 14), 1.1997, 0.9351),
    (28, 2, 4093, _walks(0, 2), 1.2486, 1.6719),
    (28, 2, 4093, _walks(3, 5), 1.2451, 1.5081),
    (28, 2, 4093, _walks(4, 6), 1.0087, 1.2311),
    (28, 2, 4093, _walks(6, 8), 0.9485, 0.9637),
    (28, 2, 4093, _walks(8, 10), 0.9446, 0.9203),
    (28, 2, 4093, _walks(8, 11), 1.0971, 1.3884),
    (28, 2, 4093, _walks(8, 12), 1.1838, 1.8879),
    (28, 2, 4093, _walks(11, 13), 0.9287, 0.9322),
    (28, 4, 8191, _walks(0, 2), 3.0601, 3.2502),
    (28, 4, 8191, _walks(0, 3), 3.0721, 4.9895),
    (28, 4, 8191, _walks(2, 4), 3.0660, 2.9425),
    (28, 4, 8191, _walks(3, 5), 2.5492, 2.3855),
    (28, 4, 8191, _walks(4, 6), 2.5326, 1.9133),
    (28, 4, 8191, _walks(4, 7), 2.7474, 2.6801),
    (28, 4, 8191, _walks(6, 8), 2.3132, 1.5761),
    (28, 4, 8191, _walks(8, 10), 2.3072, 1.5960),
    (28, 4, 8191, _walks(8, 11), 2.6981, 2.3671),
    (28, 4, 8191, (*_walks(9, 11), (11, 12, 13, 14)), 3.0245, 3.0362),
    (28, 4, 8191, (*_walks(10, 11), (11, 12, 13, 14)), 2.9938, 2.2596),
    (28, 4, 8191, (*_walks(0, 11), (11, 12, 13, 14)), 3.1106, 13.4733),
    (28, 4, 4093, _walks(0, 2), 2.2024, 3.2623),
    (28, 4, 4093, _walks(3, 5), 1.8104, 2.3568),
    (28, 4, 4093, _walks(8, 10), 1.6491, 1.6009),
    (28, 4, 4093, _walks(8, 11), 1.9302, 2.3670),
    (28, 4, 4093, _walks(0, 12), 2.2492, 12.8126),
    (32, 4, 8191, _walks(0, 2), 67.0102, 51.2692),
    (32, 4, 8191, _walks(0, 3), 66.9493, 77.0319),
    (32, 4, 8191, _walks(2, 4), 66.8552, 46.2777),
    (32, 4, 8191, _walks(3, 5), 49.9744, 36.7686),
    (32, 4, 8191, _walks(4, 6), 50.0485, 29.2564),
    (32, 4, 8191, _walks(4, 7), 58.4646, 41.5816),
    (32, 4, 8191, _walks(6, 8), 51.5546, 24.2760),
    (32, 4, 8191, _walks(8, 10), 50.3406, 24.5988),
    (32, 4, 8191, _walks(8, 11), 58.7648, 36.8448),
    (32, 4, 8191, (*_walks(9, 11), (11, 12, 13, 14)), 65.9827, 47.4921),
    (32, 4, 8191, (*_walks(10, 11), (11, 12, 13, 14)), 64.5419, 35.2388),
    (32, 4, 8191, (*_walks(0, 11), tuple(range(11, 19))), 67.0811, 211.1011),
    (32, 4, 4093, _walks(0, 2), 66.3057, 50.5139),
    (32, 4, 4093, _walks(8, 10), 49.8140, 24.5730),
    (32, 4, 4093, _walks(0, 12), 66.4788, 199.0743),
    (32, 2, 8191, _walks(0, 2), 24.7379, 26.1953),
    (32, 2, 8191, _walks(4, 6), 21.5422, 18.4318),
    (32, 2, 8191, _walks(8, 10), 18.7439, 13.5719),
    (32, 2, 8191, _walks(8, 12), 23.5203, 27.1965),
    (32, 2, 8191, (*_walks(0, 12), tuple(range(12, 19))), 25.7642, 132.2960),
    (32, 2, 4093, _walks(0, 2), 25.1544, 25.2348),
    (32, 2, 4093, _walks(8, 10), 18.9577, 13.5836),
    (32, 2, 4093, _walks(0, 12), 25.2771, 110.2981),
]


@pytest.mark.parametrize("n,itemsize,C,entries,strip_ms,entries_ms", TIMED_RUNS_WIDE)
def test_strip_pays_agrees_with_the_cards_timed_runs(n, itemsize, C, entries, strip_ms, entries_ms):
    if abs(strip_ms - entries_ms) > 0.02 * entries_ms:
        assert oracle.strip_pays(entries, C, itemsize, oracle.STRIP_ROOM_SM90, n) == (strip_ms < entries_ms)


def test_strip_pays_reads_the_shares_of_its_register_size():
    """n below 28 reads the shares of 28, n = 29-31 those of 28, 32 and up
    those of 32: the complex64 n = 32 pass at 0.27 of the memory rate loses
    to two walks at controls 0 and 1, which it beats at n = 28."""
    walks = _walks(0, 2)
    assert [oracle.strip_pays(walks, 8191, 4, oracle.STRIP_ROOM_SM90, n) for n in (20, 28, 31, 32, 34)] == [
        True, True, True, False, False]


@pytest.mark.parametrize("C", [8191, 4093, 33])
@pytest.mark.parametrize("control", [0, 3, 4, 9])
def test_strip_pays_never_for_a_lone_gate(C, control):
    """Nor for a lone ladder, at either item size or register size."""
    for itemsize in (2, 4):
        for n in (20, 28, 32):
            assert not oracle.strip_pays([(control,)], C, itemsize, oracle.STRIP_ROOM_SM90, n)
            assert not oracle.strip_pays([(control, 11, 12)], C, itemsize, oracle.STRIP_ROOM_SM90, n)


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
