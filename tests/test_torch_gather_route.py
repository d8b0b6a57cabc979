"""The gather oracle's route on the CPU (ops/fused.py: gather_route,
gather_table, apply_camodc_gate).  On the card a lone standard-layout
camodc gate is one launch of the camodc permutation with one control and
one case table built on the card; here the route's predicate, its table and
its cache, and its plain counterpart (fused.plain_permute on the one-op
segment) against the torch gather it replaces,
gates.apply_c_amodc_planes_.  The launch itself is held on the card by
utils/kernel_checks.gather_route_flagship.  Data movement: held exactly."""

import numpy as np
import pytest
import torch

from quantumcomputer_tpu_torch.algorithms import shor
from quantumcomputer_tpu_torch.models import circuit as cir
from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit
from quantumcomputer_tpu_torch.ops import fused
from quantumcomputer_tpu_torch.ops import gates as tops
from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
from quantumcomputer_tpu_torch.utils import profiling as prof

DTYPES = (torch.float32, torch.float64, torch.bfloat16)


@pytest.mark.parametrize(
    "dtype,M,control,n",
    [(torch.float32, 13, 13, 28), (torch.float64, 13, 27, 28), (torch.bfloat16, 13, 20, 28),
     (torch.float32, 2, 2, 6), (torch.float64, 1, 3, 4), (torch.bfloat16, 3, 5, 8)],
)
def test_route_takes_the_kernel_shapes(dtype, M, control, n):
    assert fused.gather_route(cir.CAMODC(3, 2, control), M, n, dtype, "cuda", aligned=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_route_takes_every_oracle_of_the_gather_flagship(dtype):
    """Every lone oracle gate of the n = 28 gather plan (the benchmark's
    cells) goes to the camodc permutation on the card."""
    C, a, L, M = 8191, 3, 15, 13
    plan = fused.plan_circuit(shor_circuit(C, a, L, M), L + M, M, fused.TILE_BITS[dtype],
                              group=fused.groups(dtype, L + M))
    single = [s[1] for s in plan if s[0] == "single"]
    assert len(single) == L and all(g.name == "camodc" for g in single)
    assert all(fused.gather_route(g, M, L + M, dtype, torch.device("cuda", 0), aligned=True) for g in single)


def _strict(g):
    return StateVectorEngine(Register(4, 5), strict_reference=True)._prep((g,))[0]


@pytest.mark.parametrize(
    "why,gate,M,n,dtype,device,aligned",
    [
        ("a CPU tensor", cir.CAMODC(8191, 3, 13), 13, 28, torch.float32, "cpu", True),
        ("strict_reference", _strict(cir.CAMODC(21, 2, 5)), 5, 9, torch.float32, "cuda", True),
        ("M = 14", cir.CAMODC(16381, 3, 14), 14, 28, torch.float32, "cuda", True),
        ("an unaligned plane", cir.CAMODC(8191, 3, 13), 13, 28, torch.float32, "cuda", False),
        ("a bf16 work block of 8 bytes", cir.CAMODC(3, 2, 2), 2, 6, torch.bfloat16, "cuda", True),
        ("a float32 work block of 8 bytes", cir.CAMODC(2, 1, 1), 1, 4, torch.float32, "cuda", True),
        ("a control in the work register", cir.CAMODC(21, 2, 3), 5, 9, torch.float32, "cuda", True),
        ("a control past the state", cir.CAMODC(21, 2, 9), 5, 9, torch.float32, "cuda", True),
        ("an m_high oracle", cir.Gate("camodc_high", (0,), meta=(21, 2, 5)), 0, 9, torch.float32, "cuda", True),
    ],
)
def test_route_falls_back(why, gate, M, n, dtype, device, aligned):
    assert not fused.gather_route(gate, M, n, dtype, device, aligned), why


@pytest.mark.parametrize(
    "C,A,M",
    [(8191, 3, 13), (8191, 3 + 2 * 8191, 13), (8189, 8188, 13), (4093, 2, 12), (251, 13, 8),
     (21, 5, 5), (15, 22, 4), (3, 2, 2), (2, 1, 1)],
)
def test_table_is_the_inverse_permutation(C, A, M):
    """int16, the inverse table of gates.modmul_inverse_permutation (A >= C
    taken mod C), zero-padded to a multiple of 8 entries: the row
    permute_descriptor composes for the one-op segment."""
    table = fused.gather_table(C, A, M, "cpu")
    stride = max(8, 1 << M)
    assert table.dtype == torch.int16 and table.shape == (1, stride) and table.device.type == "cpu"
    want = tops.modmul_inverse_permutation(C, A, M)
    np.testing.assert_array_equal(table[0, : 1 << M].numpy().astype(np.int64), want)
    assert not table[0, 1 << M:].any()
    (_, _, _, rows) = fused.permute_descriptor((("camodc", M, C, A % C),), M + 1, M)
    np.testing.assert_array_equal(rows.view(np.int16), table.numpy())


@pytest.mark.parametrize(
    "C,A,M,match",
    [(15, 6, 4, "not coprime"), (8191, 0, 13, "not coprime"), (21, 2, 4, "not unitary"), (8191, 3, 12, "not unitary")],
)
def test_table_raises_as_the_host_table(C, A, M, match):
    with pytest.raises(ValueError, match=match) as built:
        fused.gather_table(C, A, M, "cpu")
    with pytest.raises(ValueError) as host:
        tops.modmul_inverse_permutation(C, A, M)
    assert str(built.value) == str(host.value)


def test_table_cache_is_bounded_and_builds_only_on_a_miss():
    """At most GATHER_TABLES tables stay cached; a hit hands back the same
    tensor and records no span; a miss records one oracle.table span with
    the table's bytes."""
    fused._gather_table.cache_clear()
    C, M = 8191, 13
    prof.record_spans(True)
    try:
        first = fused.gather_table(C, 3, M, "cpu")
        again = fused.gather_table(C, 3 + C, M, "cpu")
        recs = prof.span_records(clear=True)
    finally:
        prof.record_spans(False)
        prof.span_records(clear=True)
    assert again is first
    assert [(r.name, r.counts) for r in recs] == [("oracle.table", {"bytes": 2 << M})]
    for A in range(2, fused.GATHER_TABLES + 40):
        fused.gather_table(C, A, M, "cpu")
        assert fused._gather_table.cache_info().currsize <= fused.GATHER_TABLES
    info = fused._gather_table.cache_info()
    assert info.maxsize == info.currsize == fused.GATHER_TABLES
    assert fused.gather_table(C, 3, M, "cpu") is not first  # evicted, built again
    fused._gather_table.cache_clear()


def _planes(n: int, dtype, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((2, 1 << n))).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "n,M,C,A,control",
    [(16, 13, 8191, 3, 13), (16, 13, 8191, 910, 15), (16, 13, 8189, 2, 14), (14, 8, 251, 13, 8),
     (14, 8, 251, 250, 11), (14, 8, 129, 5, 13), (12, 5, 21, 2, 7), (10, 3, 5, 2, 9)],
)
def test_plain_counterpart_equals_the_torch_gather(dtype, n, M, C, A, control):
    """The route's plain counterpart, fused.plain_permute on the one-op
    segment, and the work blocks gathered through gather_table where the
    control is 1, both equal apply_c_amodc_planes_ bit for bit."""
    planes = _planes(n, dtype, seed=n + control)
    want = tops.apply_c_amodc_planes_(planes.clone(), C, A, control, M)
    assert torch.equal(fused.plain_permute(planes, (("camodc", control, C, A % C),), M), want)
    blocks = planes.clone().view(2, -1, 1 << M)
    on = ((torch.arange(blocks.shape[1]) >> (control - M)) & 1).bool()
    table = fused.gather_table(C, A, M, "cpu")[0, : 1 << M].long()
    blocks[:, on] = blocks[:, on][..., table]
    assert torch.equal(blocks.view_as(planes), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_camodc_gate_on_a_cpu_tensor_keeps_the_torch_gather(dtype):
    """Off the card apply_camodc_gate is the torch gather, in place, and
    counts a fallback and no launch."""
    n, M, g = 14, 8, cir.CAMODC(251, 13, 12)
    planes = _planes(n, dtype, seed=5)
    want = tops.apply_c_amodc_planes_(planes.clone(), 251, 13, 12, M)
    launches, fallbacks = fused.GATHER_PERMUTE_LAUNCHES, fused.GATHER_FALLBACKS
    state = planes.clone()
    assert fused.apply_camodc_gate(state, g, M) is state and torch.equal(state, want)
    assert (fused.GATHER_PERMUTE_LAUNCHES, fused.GATHER_FALLBACKS) == (launches, fallbacks + 1)


@pytest.mark.parametrize("fuse", [True, False])
def test_engine_sends_each_oracle_through_the_route(fuse):
    """The cuda backend's planned and per-gate paths (complex32 off the card
    runs them on the CPU) hand every oracle gate of an attempt to
    apply_camodc_gate: L fallbacks here, where the card launches L times."""
    C, a, L, M = 21, 2, 6, 5
    eng = StateVectorEngine(Register(L, M), dtype="complex32", fuse=fuse)
    assert eng.backend == "cuda" and eng.device.type == "cpu"
    launches, fallbacks = fused.GATHER_PERMUTE_LAUNCHES, fused.GATHER_FALLBACKS
    shor.find_period(eng, C, a, 0.4)
    assert (fused.GATHER_PERMUTE_LAUNCHES, fused.GATHER_FALLBACKS) == (launches, fallbacks + L)
