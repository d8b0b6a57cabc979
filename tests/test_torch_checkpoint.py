"""The port's checkpoint/resume (quantumcomputer_tpu_torch/sim/checkpoint.py,
the checkpointed Shor and semiclassical attempts) against the JAX package's.

Tolerances: snapshots round-trip exactly (f32, f64 and bf16 bit patterns, in
both directions between the packages); a complex64 resume from the other
package's segments ends within the complex64 circuit bound, 3e-5, of the
JAX state; complex128 states within 1e-12; a resumed run equals the
uninterrupted segmented run exactly.  The guard cases put the same snapshot
directory before both packages and require the same choice: resume from the
same segment, or a cold start."""

import math
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.algorithms import semiclassical as jsc
from quantumcomputer_tpu.algorithms import shor as jshor
from quantumcomputer_tpu.models import circuit as jcir
from quantumcomputer_tpu.models.shor_circuit import shor_circuit as jshor_circuit
from quantumcomputer_tpu.models.shor_circuit import shor_circuit_mhigh as jshor_circuit_mhigh
from quantumcomputer_tpu.sim import checkpoint as jckpt
from quantumcomputer_tpu.sim.dd_engine import DDStateVectorEngine
from quantumcomputer_tpu.sim.engine import Register as JRegister
from quantumcomputer_tpu.sim.engine import StateVectorEngine as JEngine
from quantumcomputer_tpu_torch import Register, StateVectorEngine, interop
from quantumcomputer_tpu_torch.algorithms import semiclassical as sc
from quantumcomputer_tpu_torch.algorithms import shor
from quantumcomputer_tpu_torch.models import circuit as tcir
from quantumcomputer_tpu_torch.sim import checkpoint as ckpt
from quantumcomputer_tpu_torch.utils import logging as tlog

C64_TOL = 3e-5
C128_TOL = 1e-12
PLANES = {"float32": np.float32, "float64": np.float64, "bfloat16": ml_dtypes.bfloat16}


@pytest.fixture(autouse=True)
def _reset_verbosity():
    yield
    tlog.configure(False, False)


def _planes(dtype: str, n: int = 9, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((2, 1 << n)).astype(PLANES[dtype])


def _bits(a: np.ndarray) -> np.ndarray:
    """A numpy planar array as raw bits, so equality is bit for bit."""
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_snapshot_round_trip_between_the_packages(dtype, tmp_path):
    planes = _planes(dtype)
    meta = {"fingerprint": "0123456789abcdef", "segment": 3}
    # port -> JAX
    ckpt.save_state(str(tmp_path / "p.npz"), interop.state_from_numpy(planes), meta)
    got, got_meta = jckpt.load_state(str(tmp_path / "p.npz"))
    assert got_meta == meta and str(got.dtype) == dtype
    np.testing.assert_array_equal(_bits(np.asarray(got)), _bits(planes))
    # JAX -> port, and port -> port
    jckpt.save_state(str(tmp_path / "j.npz"), jnp.asarray(planes), meta)
    for path in ("j.npz", "p.npz"):
        t, t_meta = ckpt.load_state(str(tmp_path / path))
        assert t_meta == meta and t.dtype == {"float32": torch.float32, "float64": torch.float64}.get(dtype, torch.bfloat16)
        np.testing.assert_array_equal(_bits(interop.state_to_numpy(t)), _bits(planes))
    # The JAX package's older format (separate re / im keys) loads as two planes.
    np.savez(str(tmp_path / "old.npz"), re=planes[0].astype(np.float64), im=planes[1].astype(np.float64),
             meta='{"k": 1}')
    old, old_meta = ckpt.load_state(str(tmp_path / "old.npz"))
    assert old_meta == {"k": 1} and old.shape == planes.shape


def _circuits():
    rng = np.random.default_rng(5)
    u = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    return {
        "shor": jshor_circuit(21, 2, 4, 5),
        "mhigh": jshor_circuit_mhigh(33, 29, 8, 6),
        "u2q": (jcir.U2Q(3, 1, np.linalg.qr(u)[0]), jcir.MCZ(0, 2, 3), jcir.RY(2, 0.3)),
    }


@pytest.mark.parametrize("name", ["shor", "mhigh", "u2q"])
def test_circuit_fingerprint_matches_jax(name):
    jc = _circuits()[name]
    assert ckpt.circuit_fingerprint(interop.circuit_from_reference(jc)) == jckpt.circuit_fingerprint(jc)


def test_fingerprint_distinguishes_matrices():
    a = (tcir.U2Q(1, 0, np.eye(4)),)
    b = (tcir.U2Q(1, 0, np.diag([1, 1, 1, -1])),)
    assert ckpt.circuit_fingerprint(a) != ckpt.circuit_fingerprint(b)
    assert ckpt.circuit_fingerprint(a) == ckpt.circuit_fingerprint(a)


def test_run_with_checkpoints_matches_direct(tmp_path):
    C, a, L, M = 21, 2, 4, 5
    circ = interop.circuit_from_reference(jshor_circuit(C, a, L, M))
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch")
    direct = interop.state_to_numpy(eng.run(circ))
    seg = interop.state_to_numpy(ckpt.run_with_checkpoints(eng, circ, str(tmp_path), segment_gates=3))
    np.testing.assert_allclose(seg, direct, atol=C128_TOL)
    assert ckpt.latest_segment(str(tmp_path)) == -(-len(circ) // 3)
    assert ckpt.all_segments(str(tmp_path)) == list(range(1, -(-len(circ) // 3) + 1))


def _counting(eng):
    """Wrap eng.run to count the segments it executes."""
    calls = []
    run = eng.run
    eng.run = lambda circuit, state=None: (calls.append(len(circuit)), run(circuit, state))[1]
    return calls


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_from_the_other_packages_segments(writer, tmp_path):
    """One package writes every segment of a complex64 run; the last two
    are dropped (a preemption); the other package resumes from the rest,
    runs only the missing segments and ends within the complex64 bound of
    the JAX state."""
    C, a, L, M = 21, 2, 4, 5
    jc = jshor_circuit(C, a, L, M)
    tc = interop.circuit_from_reference(jc)
    jeng = JEngine(JRegister(L=L, M=M), dtype=jnp.complex64)
    want = np.asarray(jeng.run(jc))
    teng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex64, backend="torch")
    d = str(tmp_path)
    if writer == "jax":
        jckpt.run_with_checkpoints(jeng, jc, d, segment_gates=4)
    else:
        ckpt.run_with_checkpoints(teng, tc, d, segment_gates=4)
    total = ckpt.latest_segment(d)
    for s in (total, total - 1):
        os.remove(os.path.join(d, f"segment_{s:05d}.npz"))
    if writer == "jax":
        calls = _counting(teng)
        got = interop.state_to_numpy(ckpt.run_with_checkpoints(teng, tc, d, segment_gates=4))
    else:
        calls = _counting(jeng)
        got = np.asarray(jckpt.run_with_checkpoints(jeng, jc, d, segment_gates=4))
    assert len(calls) == 2
    np.testing.assert_allclose(got, want, atol=C64_TOL)


def _guard_case(case: str, d: str):
    """Write the snapshot directory of one guard case with the JAX package:
    returns (JAX engine, port engine, JAX circuit, segment_gates to resume
    with)."""
    C, a, L, M = 15, 7, 3, 4
    jc = jshor_circuit(C, a, L, M)
    j128 = JEngine(JRegister(L=L, M=M), dtype=jnp.complex128)
    t128 = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch")
    if case == "fingerprint":
        jckpt.run_with_checkpoints(j128, jshor_circuit(15, 13, L, M), d, segment_gates=2)
        return j128, t128, jc, 2
    if case == "segment_gates":
        jckpt.run_with_checkpoints(j128, jc, d, segment_gates=2)
        os.remove(jckpt._segment_path(d, jckpt.latest_segment(d)))
        return j128, t128, jc, 3
    if case == "plane_count":
        # Four dd planes before a two-plane engine: the JAX guard's case
        # turned round, since the port has no four-plane engine.
        jckpt.run_with_checkpoints(DDStateVectorEngine(JRegister(L=L, M=M)), jc, d, segment_gates=3)
        os.remove(jckpt._segment_path(d, jckpt.latest_segment(d)))
        return j128, t128, jc, 3
    if case == "dtype":
        j64 = JEngine(JRegister(L=L, M=M), dtype=jnp.complex64)
        jckpt.run_with_checkpoints(j64, jc, d, segment_gates=3)
        os.remove(jckpt._segment_path(d, jckpt.latest_segment(d)))
        return j128, t128, jc, 3
    if case == "stale_higher":
        jckpt.run_with_checkpoints(j128, jc, d, segment_gates=2)
        total = jckpt.latest_segment(d)
        for s in (total, total - 1):
            os.remove(jckpt._segment_path(d, s))
        jckpt.save_state(jckpt._segment_path(d, total + 3), j128.initial_state(),
                         {"fingerprint": "feedfacedeadbeef", "segment": total + 3, "segment_gates": 2, "n": L + M})
        with open(jckpt._segment_path(d, total + 5), "wb") as f:
            f.write(b"garbage")
        return j128, t128, jc, 2
    assert case == "all_done"
    jckpt.run_with_checkpoints(j128, jc, d, segment_gates=2)
    return j128, t128, jc, 2


@pytest.mark.parametrize("case", ["fingerprint", "segment_gates", "plane_count", "dtype", "stale_higher", "all_done"])
def test_resume_guards_match_jax(case, tmp_path):
    """The JAX package's guards (tests/test_checkpoint.py), each as a parity
    case: both packages, handed copies of one directory, execute the same
    number of segments and end in the same state."""
    jeng, teng, jc, seg_gates = _guard_case(case, str(tmp_path / "jax"))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    jcalls, tcalls = _counting(jeng), _counting(teng)
    want = np.asarray(jckpt.run_with_checkpoints(jeng, jc, str(tmp_path / "jax"), segment_gates=seg_gates))
    got = ckpt.run_with_checkpoints(teng, interop.circuit_from_reference(jc), str(tmp_path / "port"),
                                    segment_gates=seg_gates)
    assert tcalls == jcalls
    cold = -(-len(jc) // seg_gates)
    assert len(tcalls) == {"stale_higher": 2, "all_done": 0}.get(case, cold)
    np.testing.assert_allclose(interop.state_to_numpy(got), want, atol=C128_TOL)


class _Die(RuntimeError):
    pass


def test_find_period_kill_and_resume_matches_jax(tmp_path):
    """find_period killed after two segments resumes from them without
    re-running them, measures what an uninterrupted run measures with the
    same draw (the JAX package's too), and removes its attempt directory."""
    C, a, L, M = 21, 2, 4, 5
    key = jax.random.PRNGKey(3)
    want = jshor.find_period(JEngine(JRegister(L=L, M=M), dtype=jnp.complex128), C, a, key,
                             checkpoint_dir=str(tmp_path / "jax"), checkpoint_segment_gates=3)
    r = float(jax.random.uniform(key, dtype=jnp.float64))
    ref = shor.find_period(StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch"),
                           C, a, r, checkpoint_dir=str(tmp_path / "ref"), checkpoint_segment_gates=3)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch")
    run, done = eng.run, []

    def dying_run(circuit, state=None):
        if len(done) >= 2:
            raise _Die("simulated preemption")
        done.append(1)
        return run(circuit, state)

    eng.run = dying_run
    ckdir = str(tmp_path / "ck")
    with pytest.raises(_Die):
        shor.find_period(eng, C, a, r, checkpoint_dir=ckdir, checkpoint_segment_gates=3)
    assert ckpt.latest_segment(os.path.join(ckdir, f"C{C}_a{a}")) == 2
    eng2 = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch")
    calls = _counting(eng2)
    rec = shor.find_period(eng2, C, a, r, checkpoint_dir=ckdir, checkpoint_segment_gates=3)
    assert len(calls) == -(-len(jshor_circuit(C, a, L, M)) // 3) - 2
    assert rec.measured_index == ref.measured_index == want.measured_index
    assert rec.period == ref.period == want.period == 6
    assert not os.path.isdir(os.path.join(ckdir, f"C{C}_a{a}"))


@pytest.mark.parametrize("layout", ["standard", "m_high"])
def test_find_period_checkpoint_measures_as_the_plain_run(layout, tmp_path):
    C, a, L, M = 15, 7, 3, 4
    for r in (0.1, 0.45, 0.8):
        engines = [StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch", layout=layout)
                   for _ in range(2)]
        plain = shor.find_period(engines[0], C, a, r)
        ck = shor.find_period(engines[1], C, a, r, checkpoint_dir=str(tmp_path / "ck"))
        assert (plain.measured_index, plain.period) == (ck.measured_index, ck.period)
    assert os.listdir(tmp_path / "ck") == []


def test_checkpoint_wins_over_very_verbose(tmp_path, monkeypatch, capsys):
    """-V with checkpoint_dir still snapshots, as in the JAX package."""
    tlog.configure(True, True)
    wrote = []
    save = ckpt.save_state
    monkeypatch.setattr(ckpt, "save_state", lambda *a, **k: wrote.append(a[0]) or save(*a, **k))
    eng = StateVectorEngine(Register(L=3, M=4), dtype=torch.complex128, backend="torch")
    rec = shor.find_period(eng, 15, 7, 0.3, checkpoint_dir=str(tmp_path / "vck"), checkpoint_segment_gates=3)
    assert rec.period == 4 and wrote
    assert "per-phase -V progress is replaced by per-segment snapshots" in capsys.readouterr().out


def test_shors_algorithm_checkpoint_dir_matches_jax(tmp_path):
    C, L, M = 15, 3, 4
    want = jshor.shors_algorithm(C, L, M, forced_trial_int=7, seed=0, checkpoint_dir=str(tmp_path / "j"))
    got = shor.shors_algorithm(C, L, M, forced_trial_int=7, seed=0, checkpoint_dir=str(tmp_path / "t"))
    plain = shor.shors_algorithm(C, L, M, forced_trial_int=7, seed=0)
    assert got.factors == want.factors == plain.factors == (5, 3)
    assert [x.measured_index for x in got.attempts] == [x.measured_index for x in plain.attempts]
    assert os.listdir(tmp_path / "t") == []


SC_CASES = [(21, 2, 8, 5), (33, 29, 9, 6)]


@pytest.mark.parametrize("C,a,L,M", SC_CASES)
@pytest.mark.parametrize("forced", [False, True])
def test_semiclassical_checkpoint_matches_jax(C, a, L, M, forced, tmp_path):
    """A checkpointed attempt returns the JAX package's bits and branch
    probabilities for the same draws, forced and free; killed after its
    step-4 snapshot and called again, it resumes there and returns the
    same record as the run without checkpoint_dir."""
    key = jax.random.PRNGKey(7)
    rs = np.asarray(jax.random.uniform(key, (L,), dtype=jnp.float32))
    fb = [(0b1011001 >> k) & 1 for k in range(L)] if forced else None
    want = jsc.run_semiclassical(C, a, L, M, key, forced_bits=fb, checkpoint_dir=str(tmp_path / "jax"))
    plain = sc.run_semiclassical(C, a, L, M, rs, forced_bits=fb)
    ckdir = str(tmp_path / "port")
    got = sc.run_semiclassical(C, a, L, M, rs, forced_bits=fb, checkpoint_dir=ckdir)
    assert got.bits == plain.bits == want.bits
    assert got.branch_probs == plain.branch_probs
    np.testing.assert_allclose(got.branch_probs, want.branch_probs, rtol=0, atol=1e-6)
    assert os.listdir(ckdir) == [] and os.listdir(tmp_path / "jax") == []

    save = ckpt.save_state

    def save_and_die(path, state, meta):
        save(path, state, meta)
        raise _Die(meta["step"])

    ckpt.save_state = save_and_die
    try:
        with pytest.raises(_Die):
            sc.run_semiclassical(C, a, L, M, rs, forced_bits=fb, checkpoint_dir=ckdir)
    finally:
        ckpt.save_state = save
    (attempt,) = os.listdir(ckdir)
    assert ckpt.all_segments(os.path.join(ckdir, attempt)) == [4]
    _, meta = ckpt.load_state(ckpt._segment_path(os.path.join(ckdir, attempt), 4))
    assert meta["bits"] == want.bits[:4] and meta["step"] == 4
    resumed = sc.run_semiclassical(C, a, L, M, rs, forced_bits=fb, checkpoint_dir=ckdir)
    assert (resumed.bits, resumed.branch_probs) == (plain.bits, plain.branch_probs)
    assert os.listdir(ckdir) == []


def test_semiclassical_structured_checkpoint_equals_gather(tmp_path):
    """The structured oracle (the transpose and chunk-gather kernels' plain
    versions here) under checkpointing, killed after its step-3 snapshot
    and resumed: the gather attempt's record, exactly."""
    C, L, M = (1 << 18) - 3, 6, 18
    for a in range(2, 400):
        a_invs = [pow(pow(a, 1 << (L - 1 - s), C), -1, C) for s in range(L)]
        if math.gcd(a, C) == 1 and sum(p is not None for p in sc._structured_plans(C, a_invs, M)) >= 2:
            break
    rs = np.random.default_rng(4).random(L).astype(np.float32)
    gather = sc.run_semiclassical(C, a, L, M, rs, structured=False)
    save = ckpt.save_state

    def save_and_die(path, state, meta):
        save(path, state, meta)
        raise _Die(meta["step"])

    ckpt.save_state = save_and_die
    try:
        with pytest.raises(_Die):
            sc.run_semiclassical(C, a, L, M, rs, structured=True, checkpoint_dir=str(tmp_path), checkpoint_every=3)
    finally:
        ckpt.save_state = save
    got = sc.run_semiclassical(C, a, L, M, rs, structured=True, checkpoint_dir=str(tmp_path), checkpoint_every=3)
    assert (got.bits, got.branch_probs) == (gather.bits, gather.branch_probs)
    assert got.oracles.count("structured") >= 2


def test_semiclassical_fingerprint_follows_the_draws():
    rs = torch.tensor([0.1, 0.2, 0.3])
    fp = sc._attempt_fingerprint(15, 7, 3, 4, torch.float32, rs, [-1] * 3)
    assert fp == sc._attempt_fingerprint(15, 7, 3, 4, torch.float32, rs.clone(), [-1] * 3)
    assert fp != sc._attempt_fingerprint(15, 7, 3, 4, torch.float32, rs + 0.01, [-1] * 3)
    assert fp != sc._attempt_fingerprint(15, 7, 3, 4, torch.bfloat16, rs, [-1] * 3)
    assert fp != sc._attempt_fingerprint(15, 7, 3, 4, torch.float32, rs, [1, 0, 1])


def test_phi_from_bits_replays_the_step_recurrence():
    bits = [1, 0, 1, 1, 0, 1, 1, 1, 0, 1]
    for cdt in (torch.float32, torch.float64):
        phi = torch.zeros((), dtype=cdt)
        for m in bits:
            phi = (phi + torch.tensor(m).to(cdt)) / 2
        assert sc._phi_from_bits(bits, cdt, "cpu").item() == phi.item()
        want = jsc._phi_from_bits(bits, jnp.float32 if cdt == torch.float32 else jnp.float64)
        assert float(want) == phi.item()
