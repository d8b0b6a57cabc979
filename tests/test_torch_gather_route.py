"""The gather oracle on the CPU: a lone standard-layout camodc gate is the
one-op camodc segment (fused.gate_segment with the work register's M),
which sim/engine.apply_gate_planes_ hands to fused.apply_fused, whose
router (fused.kernel_body) picks the kernel: on the card one launch of the
camodc permutation through its case table, here the same route's CPU
gather through the same table.  The case tables are built on the device
that uses them (fused._case_tables) and held to fused.permute_descriptor,
the host specification; the torch gathers' int32 index table
(gates.inverse_index_table) to gates.modmul_inverse_permutation.  The
launch itself is held on the card by utils/kernel_checks.gather_oracle_flagship.
Data movement: held exactly."""

import numpy as np
import pytest
import torch

from quantumcomputer_tpu_torch.algorithms import shor
from quantumcomputer_tpu_torch.models import circuit as cir
from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit
from quantumcomputer_tpu_torch.ops import fused
from quantumcomputer_tpu_torch.ops import gates as tops
from quantumcomputer_tpu_torch.parallel.mesh import build_mesh
from quantumcomputer_tpu_torch.parallel.sharded import ShardedStateVectorEngine
from quantumcomputer_tpu_torch.sim import engine as tengine
from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
from quantumcomputer_tpu_torch.utils import profiling as prof

DTYPES = (torch.float32, torch.float64, torch.bfloat16)
CPU = torch.device("cpu")


def _segment(g, M: int, n: int, dtype):
    return fused.gate_segment(g, n, fused.TILE_BITS[dtype], M)


def _route(g, M: int, n: int, dtype, aligned: bool) -> str:
    """Where apply_gate_planes_ sends a gate: the kernel_body of its one-op
    segment, or the gate's name where it has none (its own branch)."""
    seg = _segment(g, M, n, dtype)
    return g.name if seg is None else fused.kernel_body(seg[0], M, dtype, aligned)


@pytest.mark.parametrize(
    "dtype,M,control,n",
    [(torch.float32, 13, 13, 28), (torch.float64, 13, 27, 28), (torch.bfloat16, 13, 20, 28),
     (torch.float32, 2, 2, 6), (torch.float64, 1, 3, 4), (torch.bfloat16, 3, 5, 8)],
)
def test_route_takes_the_kernel_shapes(dtype, M, control, n):
    """The gate's one-op segment, the planner's own for the gate alone, goes
    to the camodc permutation."""
    g = cir.CAMODC(3, 2, control)
    seg = _segment(g, M, n, dtype)
    assert seg == ((("camodc", control, 3, 2),), ())
    assert fused.plan_circuit((g,), n, M, fused.TILE_BITS[dtype], fuse_oracle=True) == [("fused",) + seg]
    assert _route(g, M, n, dtype, aligned=True) == "permute"


@pytest.mark.parametrize("dtype", DTYPES)
def test_route_takes_every_oracle_of_the_gather_flagship(dtype):
    """Every lone oracle gate of the n = 28 gather plan (the benchmark's
    cells) goes to the camodc permutation on the card."""
    C, a, L, M = 8191, 3, 15, 13
    plan = fused.plan_circuit(shor_circuit(C, a, L, M), L + M, M, fused.TILE_BITS[dtype],
                              group=fused.groups(dtype, L + M))
    single = [s[1] for s in plan if s[0] == "single"]
    assert len(single) == L and all(g.name == "camodc" for g in single)
    assert all(_route(g, M, L + M, dtype, aligned=True) == "permute" for g in single)


def _strict(g):
    return StateVectorEngine(Register(4, 5), strict_reference=True)._prep((g,))[0]


def _planes(n: int, dtype, seed: int, aligned: bool = True) -> torch.Tensor:
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((2, 1 << n))).to(dtype)
    if aligned:
        return x
    planar = torch.empty(x.numel() + 1, dtype=dtype)[1:].view(2, -1)
    assert planar.data_ptr() % 16 != 0
    return planar.copy_(x)


@pytest.mark.parametrize(
    "why,gate,M,n,dtype,aligned,where",
    [
        ("a CPU tensor: the permute route's CPU gather", cir.CAMODC(8191, 3, 13), 13, 16, torch.float32, True,
         "permute"),
        ("strict_reference: the scatter", _strict(cir.CAMODC(21, 2, 5)), 5, 9, torch.float32, True, "camodc_strict"),
        ("M = 14: the torch gather", cir.CAMODC(16381, 3, 14), 14, 16, torch.float32, True, "camodc"),
        ("an unaligned plane", cir.CAMODC(8191, 3, 13), 13, 16, torch.float32, False, "segment"),
        ("a bf16 work block of 8 bytes", cir.CAMODC(3, 2, 2), 2, 6, torch.bfloat16, True, "segment"),
        ("a float32 work block of 8 bytes", cir.CAMODC(2, 1, 1), 1, 4, torch.float32, True, "segment"),
        ("a control in the work register", cir.CAMODC(21, 2, 3), 5, 9, torch.float32, True, "raises"),
        ("a control past the state", cir.CAMODC(21, 2, 9), 5, 9, torch.float32, True, "raises"),
        ("an m_high oracle: the walks", cir.Gate("camodc_high", (0,), meta=(21, 2, 5)), 0, 9, torch.float32, True,
         "camodc_high"),
    ],
)
def test_route_falls_back(why, gate, M, n, dtype, aligned, where):
    """Each shape's route; a standard oracle applied on CPU planes of that
    alignment equals the torch gather bit for bit, or raises ValueError for
    a control outside [M, n)."""
    route = _route(gate, M, n, dtype, aligned)
    assert route == ("permute" if where == "raises" else where), why
    if gate.name != "camodc":
        return
    planes = _planes(n, dtype, seed=n + M, aligned=aligned)
    C, A = gate.meta
    if where == "raises":
        with pytest.raises(ValueError, match="L register"):
            tengine.apply_gate_planes_(planes, gate, M)
        return
    want = tops.apply_c_amodc_planes_(planes.clone(), C, A, gate.qubits[0], M)
    assert tengine.apply_gate_planes_(planes, gate, M) is planes and torch.equal(planes, want)


TABLE_CASES = [(8191, 3, 13), (8191, 3 + 2 * 8191, 13), (8189, 8188, 13), (4093, 2, 12), (251, 13, 8),
               (21, 5, 5), (15, 22, 4), (3, 2, 2), (2, 1, 1)]


@pytest.mark.parametrize("C,A,M", TABLE_CASES)
def test_table_is_the_inverse_permutation(C, A, M):
    """The one-op segment's case table: int16, the inverse table of
    gates.modmul_inverse_permutation (A >= C taken mod C), zero-padded to a
    multiple of 8 entries: permute_descriptor's row, element for element."""
    (ops, _) = _segment(cir.CAMODC(C, A, M), M, M + 1, torch.float32)
    positions, table = fused._permute_tables(ops, M + 1, M, CPU)
    stride = max(8, 1 << M)
    assert positions == (0,)
    assert table.dtype == torch.int16 and table.shape == (1, stride) and table.device.type == "cpu"
    want = tops.modmul_inverse_permutation(C, A, M)
    np.testing.assert_array_equal(table[0, : 1 << M].numpy().astype(np.int64), want)
    assert not table[0, 1 << M:].any()
    (_, _, _, rows) = fused.permute_descriptor(ops, M + 1, M)
    np.testing.assert_array_equal(rows.view(np.int16), table.numpy())


@pytest.mark.parametrize(
    "C,A,M,match",
    [(15, 6, 4, "not coprime"), (8191, 0, 13, "not coprime"), (21, 2, 4, "not unitary"), (8191, 3, 12, "not unitary")],
)
def test_table_raises_as_the_host_table(C, A, M, match):
    with pytest.raises(ValueError, match=match) as built:
        fused._permute_tables((("camodc", M, C, A % C),), M + 1, M, CPU)
    with pytest.raises(ValueError) as host:
        tops.modmul_inverse_permutation(C, A, M)
    assert str(built.value) == str(host.value)


def _recorded(fn):
    prof.record_spans(True)
    try:
        out = fn()
        return out, prof.span_records(clear=True)
    finally:
        prof.record_spans(False)
        prof.span_records(clear=True)


def test_table_cache_is_bounded_and_builds_only_on_a_miss():
    """At most 256 segments' tables stay cached, keyed by what they
    depend on (a lone gate's by C and A mod C: not its control, not n); a
    hit hands back the same tensor and records no span; a miss records one
    oracle.table span with the table's bytes."""
    fused._case_tables.cache_clear()
    C, M = 8191, 13
    (_, first), recs = _recorded(lambda: fused._permute_tables((("camodc", 13, C, 3),), 28, M, CPU))
    assert [(r.name, r.counts) for r in recs] == [("oracle.table", {"bytes": 2 << M})]
    (positions, again), recs = _recorded(lambda: fused._permute_tables((("camodc", 20, C, 3 + C),), 24, M, CPU))
    assert again is first and positions == (7,) and recs == []
    for A in range(2, 256 + 40):
        fused._permute_tables((("camodc", 13, C, A),), 14, M, CPU)
        assert fused._case_tables.cache_info().currsize <= 256
    info = fused._case_tables.cache_info()
    assert info.maxsize == info.currsize == 256
    assert fused._permute_tables((("camodc", 13, C, 3),), 14, M, CPU)[1] is not first  # evicted, built again
    fused._case_tables.cache_clear()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "n,M,C,A,control",
    [(16, 13, 8191, 3, 13), (16, 13, 8191, 910, 15), (16, 13, 8189, 2, 14), (14, 8, 251, 13, 8),
     (14, 8, 251, 250, 11), (14, 8, 129, 5, 13), (12, 5, 21, 2, 7), (10, 3, 5, 2, 9)],
)
def test_plain_counterpart_equals_the_torch_gather(dtype, n, M, C, A, control):
    """The permutation's plain version on the one-op segment (plain_permute,
    host tables), the CPU gather through the built case table, and
    apply_gate_planes_ all equal apply_c_amodc_planes_ bit for bit."""
    planes = _planes(n, dtype, seed=n + control)
    want = tops.apply_c_amodc_planes_(planes.clone(), C, A, control, M)
    ops = (("camodc", control, C, A % C),)
    assert torch.equal(fused.plain_permute(planes, ops, M), want)
    positions, table = fused._permute_tables(ops, n, M, CPU)
    assert torch.equal(fused._gather_cases(planes, positions, table, M), want)
    assert torch.equal(tengine.apply_gate_planes_(planes.clone(), cir.CAMODC(C, A, control), M), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_cpu_tensor_takes_the_permute_route_through_the_built_table(dtype, monkeypatch):
    """Off the card a lone oracle runs the one-op segment through
    fused._permute's CPU branch, in place, gathering through the cached
    case table, and counts no launch."""
    n, M, g = 14, 8, cir.CAMODC(251, 13, 12)
    planes = _planes(n, dtype, seed=5)
    want = tops.apply_c_amodc_planes_(planes.clone(), 251, 13, 12, M)
    calls, real = [], fused._permute
    monkeypatch.setattr(fused, "_permute", lambda p, ops, *a: calls.append(ops) or real(p, ops, *a))
    launches = fused.LAUNCHES, fused.PERMUTE_LAUNCHES, fused.CAMODC_LAUNCHES
    state = planes.clone()
    assert tengine.apply_gate_planes_(state, g, M) is state and torch.equal(state, want)
    assert calls == [(("camodc", 12, 251, 13),)]
    assert (fused.LAUNCHES, fused.PERMUTE_LAUNCHES, fused.CAMODC_LAUNCHES) == launches
    assert fused._permute_tables(calls[0], n, M, CPU)[1] is fused._permute_tables(calls[0], n, M, CPU)[1]


@pytest.mark.parametrize("fuse", [True, False])
def test_engine_sends_each_oracle_through_the_route(fuse, monkeypatch):
    """The cuda backend's planned and per-gate paths (complex32 off the card
    runs them on the CPU) hand every oracle gate of an attempt to the
    permute route as its one-op segment: L calls here, where the card
    launches L times."""
    C, a, L, M = 21, 2, 6, 5
    eng = StateVectorEngine(Register(L, M), dtype="complex32", fuse=fuse)
    assert eng.backend == "cuda" and eng.device.type == "cpu"
    calls, real = [], fused._permute
    monkeypatch.setattr(fused, "_permute", lambda p, ops, *args: calls.append(ops) or real(p, ops, *args))
    shor.find_period(eng, C, a, 0.4)
    assert len(calls) == L and all(len(ops) == 1 and ops[0][0] == "camodc" for ops in calls)


@pytest.mark.parametrize(
    "ops,n,M",
    [
        ((("camodc", 13, 8191, 3), ("camodc", 14, 8191, 9)), 16, 13),
        ((("camodc", 15, 8191, 81), ("camodc", 13, 8191, 6561)), 16, 13),
        ((("camodc", 14, 8191, 3), ("camodc", 14, 8191, 9)), 16, 13),
        ((("camodc", 9, 251, 13), ("camodc", 12, 251, 169)), 14, 8),
        ((("camodc", 6, 21, 2), ("camodc", 9, 21, 4)), 10, 5),
        ((("camodc", 3, 5, 2), ("camodc", 4, 5, 4)), 6, 3),
    ],
)
def test_built_tables_equal_the_descriptor_for_pairs(ops, n, M):
    """k = 2 segments (two controls, or two ops on one): the case tables
    built on the device, composed in op order, equal permute_descriptor's
    element for element, and its positions."""
    positions, tables = fused._permute_tables(ops, n, M, CPU)
    want_positions, _, _, rows = fused.permute_descriptor(ops, n, M)
    assert positions == want_positions and tables.dtype == torch.int16
    np.testing.assert_array_equal(tables.numpy(), rows.view(np.int16))


@pytest.mark.parametrize("dtype", DTYPES)
def test_built_tables_equal_the_descriptor_on_the_benes_flagship(dtype):
    """Every camodc-only segment of the benes n = 28 plan (the benchmark's
    cell): the built case tables equal permute_descriptor's."""
    C, a, L, M = 8191, 3, 15, 13
    plan = fused.plan_circuit(shor_circuit(C, a, L, M), L + M, M, fused.TILE_BITS[dtype], fuse_oracle=True,
                              group=fused.groups(dtype, L + M))
    pure = [ops for kind, ops, *_ in plan if kind == "fused" and all(op[0] == "camodc" for op in ops)]
    assert len(pure) == 8
    for ops in pure:
        positions, tables = fused._permute_tables(ops, L + M, M, CPU)
        want_positions, _, _, rows = fused.permute_descriptor(ops, L + M, M)
        assert positions == want_positions
        np.testing.assert_array_equal(tables.numpy(), rows.view(np.int16))


@pytest.mark.parametrize("C,A,M", TABLE_CASES)
def test_index_table_is_the_inverse_permutation(C, A, M):
    """The torch gathers' index: (2^M,) int32 on the device, equal to
    gates.modmul_inverse_permutation."""
    table = tops.inverse_index_table(C, A, M, "cpu")
    assert table.dtype == torch.int32 and table.shape == (1 << M,) and table.device.type == "cpu"
    np.testing.assert_array_equal(table.numpy().astype(np.int64), tops.modmul_inverse_permutation(C, A, M))


def test_index_table_cache_is_bounded_and_builds_only_on_a_miss():
    tops._index_table.cache_clear()
    C, M = 8191, 13
    first, recs = _recorded(lambda: tops.inverse_index_table(C, 3, M, "cpu"))
    assert [(r.name, r.counts) for r in recs] == [("oracle.table", {"bytes": 4 << M})]
    again, recs = _recorded(lambda: tops.inverse_index_table(C, 3 + C, M, CPU))
    assert again is first and recs == []
    for A in range(2, 256 + 40):
        tops.inverse_index_table(C, A, M, "cpu")
    info = tops._index_table.cache_info()
    assert info.maxsize == info.currsize == 256
    assert tops.inverse_index_table(C, 3, M, "cpu") is not first
    with pytest.raises(ValueError, match="not coprime"):
        tops.inverse_index_table(15, 6, 4, "cpu")
    tops._index_table.cache_clear()


@pytest.mark.parametrize("dtype", [torch.complex64, "complex32"])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_sharded_oracles_equal_the_single_device(d, dtype, monkeypatch):
    """The sharded engine's standard oracles on a random state: a
    shard-local one through apply_gate_planes_ (its one-op segment, once a
    shard), a global one through the index table; the state equals the
    single device's one-op segments bit for bit."""
    C, L, M = 21, 6, 5
    n = L + M
    gates = tuple(cir.CAMODC(C, pow(2, 1 << j, C), M + j) for j in range(L))
    gates += (cir.CAMODC(C, 5, n - 1), cir.CAMODC(C, 10, M))
    eng = ShardedStateVectorEngine(Register(L, M), dtype, mesh=build_mesh(1 << d), backend="cuda")
    planes = _planes(n, eng.real_dtype, seed=d)
    want = planes.clone()
    for g in gates:
        tengine.apply_gate_planes_(want, g, M)
    calls, real = [], fused.apply_fused
    monkeypatch.setattr(fused, "apply_fused", lambda p, ops, *a: calls.append(ops) or real(p, ops, *a))
    got = eng.to_planar(eng.run(gates, eng.from_planar(planes)))
    assert torch.equal(got, want)
    local = sum(g.qubits[0] < n - d for g in gates)
    assert len(calls) == (1 << d) * local and all(ops[0][0] == "camodc" for ops in calls)
