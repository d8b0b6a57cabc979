"""Kernel checks that need a CUDA card, each kernel against its plain version.

These are the card-only cases of the port's test suite.  They live in the
package, not under ``tests/``, because the tests import the JAX package to
compare against it and the card's machine has no JAX.  ``chip_smoke.py``
runs them as one phase (``run_all``); cases that another phase of the smoke
already runs at the same shapes are not repeated here.  The smoke's other
phases build their inputs with this module's helpers (``random_planar``,
``random_circuit``, ``plan_states``).

Every input is made from a numpy seed.  Data movement (oracles, transpose,
chunk gathers, probes, the stride permutation) must be exact; the fused
segment is held to 3e-5 (float32) / 1e-12 (float64) and the block sums to
1e-6, the tolerances of the CPU suite.  At bf16 ("complex32") the kernel
and its plain version both compute in float32 and round once, so they may
differ only where the two float32 results straddle a bf16 rounding
boundary: the fused segment is held to one bf16 ulp per pass
(``bf16_ulps``; a later pass would spread an ulp of its input), and a pass
with matrix groups, which also rounds its products' activations, to
``bf16_within``.  Each
check raises KernelCheckFailure on the first disagreement and returns one
line per case for the log.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import numpy as np
import torch

from quantumcomputer_tpu_torch.models import circuit as cir
from quantumcomputer_tpu_torch.algorithms import semiclassical
from quantumcomputer_tpu_torch.ops import _build, chunkgather, fused, measure, modperm, oracle, probes, qaoa, sc_step, transpose
from quantumcomputer_tpu_torch.ops import gates as tops
from quantumcomputer_tpu_torch.scripts import exact_err
from quantumcomputer_tpu_torch.sim import statevec as sv
from quantumcomputer_tpu_torch.utils import profiling

DTYPES = (torch.float32, torch.float64)
FUSED_TOL = {torch.float32: 3e-5, torch.float64: 1e-12}
BLOCK_SUMS_TOL = 1e-6
# The semiclassical step's sums: float64 in its kernel, the plane dtype in the
# step's PyTorch composition; the CPU suite's tolerances.
SC_SUM_RTOL = {torch.float32: 1e-6, torch.float64: 1e-13}
# The card's published HBM bandwidth (H100 SXM), for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
# bf16: one ulp of the plain result, taken at magnitudes of at least
# BF16_ULP_FLOOR.  Below it the two float32 results (each within a few
# float32 ulps of the exact value, at most 3e-5 apart on unit-variance
# states: FUSED_TOL) may straddle several bf16 boundaries; one ulp at the
# floor, 2^-15 = 3.05e-5, covers that difference.
BF16_ULP_TOL = 1.0
BF16_ULP_FLOOR = 2.0 ** -8
# A segment with matrix groups also rounds the activations of each of its
# lanemat / rowmat products to bf16 (as the JAX kernel's MXU dots do).  Where
# the two float32 activations straddle a bf16 boundary, one activation
# differs by a bf16 ulp and moves the outputs of its row or column by up to
# |W| ulp(x) <= ulp(x): more than an ulp of a small output, and a later
# product of the pass spreads it further (on deep random segments a third of
# the elements end an ulp apart).  Each side's roundings move the state by
# at most BF16_UNIT (the unit roundoff) of its norm, and every op of a pass
# keeps the norm, so a pass with R products is held within
# 2 (R + 1) BF16_UNIT of the norm, and every element within BF16_STRADDLE_REL
# of the largest magnitude (one bf16 ulp there).
BF16_UNIT = 2.0 ** -8
BF16_STRADDLE_REL = 2.0 ** -7


class KernelCheckFailure(AssertionError):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise KernelCheckFailure(msg)


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def random_unitary(rng, k: int) -> np.ndarray:
    z = rng.standard_normal((k, k)) + 1j * rng.standard_normal((k, k))
    q, r = np.linalg.qr(z)
    return q * (np.diagonal(r) / np.abs(np.diagonal(r)))


def random_planar(rng, n: int, dtype, device, normalize: bool = True) -> torch.Tensor:
    """Seeded random planar state (numpy, then to `device`): normalised, or
    of unit-variance components."""
    psi = rng.standard_normal((2, 1 << n))
    if normalize:
        psi /= np.sqrt(np.sum(psi * psi))
    return torch.from_numpy(psi).to(device=device, dtype=dtype)


def random_circuit(rng, n: int, count: int) -> tuple:
    """The iQFT stages of an n-qubit state, then `count` random gates of
    every fused op kind."""
    gates = [cir.IQFT_STAGE(q) for q in range(n - 1, -1, -1)]
    for _ in range(count):
        kind, q = int(rng.integers(6 if n > 1 else 3)), int(rng.integers(n))
        p = int(rng.integers(max(1, n - 1)))
        p += p >= q
        gates.append((
            lambda: cir.H(q), lambda: cir.U1Q(q, random_unitary(rng, 2)), lambda: cir.RZ(q, float(rng.uniform(0, 6.3))),
            lambda: cir.IQFT_STAGE(q), lambda: cir.CPHASE(q, p, float(rng.uniform(0, 6.3))),
            lambda: cir.U2Q(max(p, q), min(p, q), random_unitary(rng, 4)),
        )[kind]())
    return tuple(gates)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    """(max |got - want| in bf16 ulps of |want|, the ulp taken at magnitudes
    of at least BF16_ULP_FLOOR; the share of elements that differ)."""
    g, w = got.float(), want.float()
    _, exp = torch.frexp(w.abs().clamp_min(BF16_ULP_FLOOR))  # |w| in [2^(exp-1), 2^exp)
    ulps = (g - w).abs() / torch.ldexp(torch.ones_like(w), exp - 8)
    return float(ulps.max()), float((g != w).float().mean())


def bf16_within(got: torch.Tensor, want: torch.Tensor, products: int) -> bool:
    """bf16 results held to one ulp (bf16_ulps); a pass with `products`
    matrix products (lanemat / rowmat, segment_products) either so or
    within 2 (products + 1) BF16_UNIT of the norm and BF16_STRADDLE_REL of
    the largest magnitude (one ulp of it) everywhere."""
    g, w = got.double(), want.double()
    if bf16_ulps(g, w)[0] <= BF16_ULP_TOL:
        return True
    if not products:
        return False
    d = g - w
    return (float(torch.linalg.vector_norm(d)) <= 2 * (products + 1) * BF16_UNIT * float(torch.linalg.vector_norm(w))
            and float(d.abs().max()) <= BF16_STRADDLE_REL * float(w.abs().max()))


def bf16_circuit_within(got: torch.Tensor, want: torch.Tensor, pass_products) -> bool:
    """A whole bf16 circuit, one entry of `pass_products` per pass (its
    matrix products), held as bf16_within holds one pass, in root sum of
    squares over the passes: each pass's roundings move the state by at
    most 2 (products + 1) BF16_UNIT of its norm, every op keeps the norm,
    and the roundings of separate passes are independent errors in
    unrelated directions of a 2^n-dimensional space, so their norms add in
    quadrature (the elementwise straddle bound of one pass does not compose
    and is not held)."""
    d = got.double() - want.double()
    bound = 2 * math.sqrt(sum((p + 1) ** 2 for p in pass_products)) * BF16_UNIT
    return float(torch.linalg.vector_norm(d)) <= bound * float(torch.linalg.vector_norm(want.double()))


def ae_counting_probabilities(n: int, num_marked: int, t: int) -> np.ndarray:
    """The ideal distribution of amplitude estimation's counting register
    (algorithms/amplitude_estimation.py, n work qubits, `num_marked` of
    2^n marked, t counting bits), indexed by the register's value c as the
    state holds it (before qpe's bit reversal and negation): the
    uniform superposition is an equal mix of the iterate's eigenvectors of
    phases 1/2 +- theta_a / pi, and QPE reads phase phi as x with
    probability sin^2(pi 2^t d) / (2^2t sin^2(pi d)), d = x / 2^t - phi."""
    from quantumcomputer_tpu_torch.algorithms.qpe import _negate_readout

    size = 1 << t
    theta = math.asin(math.sqrt(num_marked / float(1 << n)))
    x = np.array([_negate_readout(int(f"{c:0{t}b}"[::-1], 2), t) for c in range(size)], dtype=np.float64)
    probs = np.zeros(size)
    for phi in (0.5 + theta / math.pi, 0.5 - theta / math.pi):
        d = x / size - phi
        den = size * size * np.sin(math.pi * d) ** 2
        near = den < 1e-300
        probs += 0.5 * np.where(near, 1.0, np.sin(math.pi * size * d) ** 2 / np.where(near, 1.0, den))
    return probs


def counting_marginal(planar: torch.Tensor, M: int) -> np.ndarray:
    """The probabilities of the register above bit M of a standard-layout
    state (sum over the low M bits), in float64, normalised."""
    probs = sv.probabilities(planar).view(-1, 1 << M).sum(1, dtype=torch.float64).cpu().numpy()
    return probs / probs.sum()


def readouts_within(probs: np.ndarray, r: float, slack: float) -> List[int]:
    """The values an inverse-CDF draw r picks from a distribution within
    total variation `slack` of `probs` (index order): every value whose
    cumulative interval meets [r - slack, r + slack]."""
    cum = np.cumsum(probs)
    lo = cum - probs
    return [int(c) for c in np.nonzero((cum >= r - slack) & (lo <= r + slack))[0]]


def segment_products(ops, M: int, dtype, n: int) -> int:
    """The matrix products (lanemat, rowmat) apply_fused runs the segment
    with: 0 when it runs no matrix group."""
    return sum(op[0] in ("lanemat", "rowmat") for op in fused.segment_ops(ops, M, dtype, n)[0])


def plan_states(planar: torch.Tensor, circuit, M: int, fuse_oracle: bool = False) -> tuple:
    """Run a circuit's fused plan on copies of `planar` through the kernel
    (in place) and through plain_segment (a segment the router sends to the
    camodc permutation also through plain_permute, which must equal it
    exactly): ([(kernel state, plain state)],
    fused-segment launches, segments), each pair with a third element, the
    segment's matrix products (segment_products).  One pair, the final states, for
    float32 / float64; one pair per segment for bf16, each segment's plain
    version applied to the kernel's state before it (a pass is where bf16
    rounds)."""
    n = int(planar.shape[1]).bit_length() - 1
    plan = fused.plan_circuit(
        circuit, n, M, fused.TILE_BITS[planar.dtype], fuse_oracle=fuse_oracle, group=fused.groups(planar.dtype, n)
    )
    _check(all(s[0] == "fused" for s in plan), f"unexpected single gates in plan {plan}")
    per_pass = planar.dtype == torch.bfloat16
    want, got = planar.clone(), planar.clone()
    pairs = []
    before = fused.LAUNCHES
    for _, ops, axes in plan:
        src = got if per_pass else want
        want = fused.plain_segment(src, ops, M)
        if fused.kernel_body(ops, M, planar.dtype, aligned=True) == "permute":
            _check(torch.equal(fused.plain_permute(src, ops, M), want), f"plain_permute differs from plain_segment on {ops}")
        fused.apply_fused(got, ops, axes, M)
        if per_pass:
            pairs.append((got.clone(), want, segment_products(ops, M, planar.dtype, n)))
    torch.cuda.synchronize()
    return pairs or [(got, want, 0)], fused.LAUNCHES - before, len(plan)


def compare_plan(planar: torch.Tensor, circuit, M: int, fuse_oracle: bool = False) -> Tuple[float, int, int]:
    """plan_states on float32 / float64 planes, compared: (max abs
    difference of the final planes, fused-segment launches, segments)."""
    ((got, want, _),), launched, segments = plan_states(planar, circuit, M, fuse_oracle)
    return float((got - want).abs().max()), launched, segments


def fused_random_circuit(device) -> List[str]:
    """A random 40-gate circuit at n = 18, M = 4: one launch per segment.
    At bf16 its ungrouped plan (the butterfly instance, apply_segment),
    each pass within one ulp of its plain version, on aligned planes and on
    planes one element into their buffer (element-wise copies)."""
    out = []
    for dtype in DTYPES:
        rng = np.random.default_rng(9)
        circuit = random_circuit(rng, 18, 40)
        err, launched, segments = compare_plan(random_planar(rng, 18, dtype, device), circuit, 4)
        _check(launched == segments, f"fused n=18: {launched} launches for {segments} segments")
        _check(err <= FUSED_TOL[dtype], f"fused n=18 {_name(dtype)}: {err} > {FUSED_TOL[dtype]}")
        out.append(f"fused_segment random n=18 M=4 {_name(dtype)}: max abs {err:.3e}, {launched} launches")
    for offset in (0, 1):
        rng = np.random.default_rng(9)
        circuit = random_circuit(rng, 18, 40)
        psi = random_planar(rng, 18, torch.bfloat16, device).reshape(-1)
        buf = torch.empty(psi.numel() + offset, dtype=torch.bfloat16, device=device)
        got = buf[offset:].view(2, -1)
        got.copy_(psi.view(2, -1))
        _check((got.data_ptr() % 16 != 0) == bool(offset), f"planes at offset {offset}: data_ptr {got.data_ptr()}")
        plan = fused.plan_circuit(circuit, 18, 4, fused.TILE_BITS[torch.bfloat16])
        worst, before = 0.0, fused.LAUNCHES
        for _, ops, axes in plan:
            want = fused.plain_ops(got, ops, 4)
            fused.apply_segment(got, ops, axes, 4)
            worst = max(worst, bf16_ulps(got, want)[0])
        torch.cuda.synchronize()
        launched = fused.LAUNCHES - before
        _check(launched == len(plan), f"fused bf16 n=18: {launched} launches for {len(plan)} segments")
        _check(worst <= BF16_ULP_TOL, f"fused bf16 n=18 offset {offset}: {worst} ulps > {BF16_ULP_TOL}")
        out.append(f"fused_segment random n=18 M=4 bf16, {'un' if offset else ''}aligned planes: max {worst:.3f} ulps a "
                   f"pass, {launched} launches")
    return out


def fused_split_angle(device) -> List[str]:
    """The iQFT stages of every bit plus 20 random gates, at the (n, M) the
    smoke's random circuits do not take."""
    out = []
    for dtype in DTYPES:
        for n, M in ((13, 4), (14, 13), (16, 0)):
            rng = np.random.default_rng(n * 5 + M)
            circuit = random_circuit(rng, n, 20)
            err, _, _ = compare_plan(random_planar(rng, n, dtype, device), circuit, M)
            _check(err <= FUSED_TOL[dtype], f"fused split angle n={n} M={M} {_name(dtype)}: {err}")
            out.append(f"fused_segment split angle n={n} M={M} {_name(dtype)}: max abs {err:.3e}")
    return out


def block_sums_f64(device) -> List[str]:
    """The block sums of a float64 state (the smoke's other phases take f32)."""
    rng = np.random.default_rng(6)
    psi = 1e-2 * rng.standard_normal((2, 1 << 20))
    psi[:, rng.choice(1 << 20, 48, replace=False)] += rng.standard_normal((2, 48))
    psi *= np.exp(-np.arange(1 << 20) / float(1 << 18))
    state = torch.from_numpy(psi / np.sqrt(np.sum(psi * psi))).to(device)
    before = measure.LAUNCHES
    got = measure.block_sums(state)
    _check(measure.LAUNCHES == before + 1, "block_sums float64 launched no kernel")
    err = float((got - measure.block_sums_plain(state)).abs().max())
    _check(err <= BLOCK_SUMS_TOL, f"block_sums float64: {err} > {BLOCK_SUMS_TOL}")
    return [f"block_sums float64 n=20: max abs {err:.3e}"]


def walk_flagship_multipliers(device) -> List[str]:
    """The segmented walk with its segment count S forced, on the flagship's
    multipliers at M = 13: the single gate at controls 0 and 3 for A = 3 and
    3^512, and the pair (3, 9) at controls (1, 2)."""
    C, M, n = 8191, 13, 20
    chosen = oracle.walk_segment_count
    out = []
    try:
        for dtype in DTYPES:
            for S in (1, 2, 3, 7, 16):
                oracle.walk_segment_count = lambda *args, S=S: S
                for A in ((3,), (pow(3, 512, C),), (3, 9)):
                    state = random_planar(np.random.default_rng(S), n, dtype, device)
                    if len(A) == 2:
                        want = tops.apply_camodc_ladder_high_planes_(state.clone(), C, A, (1, 2), M)
                        oracle.apply_camodc_pair_inplace_planar(state, C, A, (1, 2), M)
                        torch.cuda.synchronize()
                        _check(torch.equal(state, want), f"pair {A} S={S} {_name(dtype)} differs")
                        continue
                    for c in (0, 3):
                        want = tops.apply_camodc_high_planes_(state.clone(), C, A[0], c, M)
                        oracle.apply_camodc_high_cycle_planar(state, C, A[0], c, M)
                        torch.cuda.synchronize()
                        _check(torch.equal(state, want), f"cycle A={A[0]} control {c} S={S} {_name(dtype)} differs")
            out.append(f"cycle / cycle_masked flagship multipliers, S forced to 1, 2, 3, 7, 16, {_name(dtype)}: exact")
    finally:
        oracle.walk_segment_count = chosen
    return out


# (M, C, a) of the strip pass's cases at n = 20: the flagship's modulus at
# M = 13, primes just below 2^M elsewhere.
STRIP_CASES = ((6, 61, 2), (9, 509, 3), (13, 8191, 3))


def strip_controls(rng, K: int, bits: int) -> tuple:
    """K distinct column bits below `bits`, controls 0-3 among them (as many
    as K allows), in a seeded unsorted order."""
    low = list(range(min(K, 4)))
    high = [int(c) for c in rng.choice(np.arange(4, bits), K - len(low), replace=False)]
    return tuple(int(c) for c in rng.permutation(low + high))


def strip_runs(device) -> List[str]:
    """The strip pass (oracle.apply_camodc_run_inplace_planar) exactly
    against its plain version at n = 20: M = 6, 9 and 13 (STRIP_CASES), runs
    of 2, 5 and min(12, n - M) gates at unsorted controls that include 0-3,
    A_k = a^(2^k) mod C (at M = 13 the flagship's multipliers, and 16 bf16 /
    32 float32 strips a plane: fewer blocks than the card has SMs), both
    instances, 32-byte strips at M = 6 and 9, 16-byte ones at M = 13; then
    n = 10, M = 6, whose bf16 rows are one sector, and a run at controls
    4-5 only, whose strips with neither bit set stay as they were; then the
    card's shared-memory room against the one a CPU run takes
    (oracle.STRIP_ROOM_SM90), and the refusals: float64 planes, an
    unaligned plane, M = 14, and the kernel's own refusal of 32-byte strips
    of 8191 rows."""
    n = 20
    rng = np.random.default_rng(12)
    out = []
    room = oracle.strip_room(torch.device(device))
    _check(room == oracle.STRIP_ROOM_SM90, f"the card's strip room {room} != {oracle.STRIP_ROOM_SM90}")

    def held(state, C, A_list, controls, M, what):
        want = tops.apply_camodc_ladder_high_planes_(state.clone(), C, A_list, controls, M)
        before = oracle.LAUNCHES["strip"]
        oracle.apply_camodc_run_inplace_planar(state, C, A_list, controls, M)
        torch.cuda.synchronize()
        _check(oracle.LAUNCHES["strip"] == before + 1, "the strip pass launched no kernel")
        _check(torch.equal(state, want), f"strip {what} M={M} C={C} controls {controls} {_name(state.dtype)} differs")

    for M, C, a in STRIP_CASES:
        width = oracle.strip_bytes(C, room)
        for K in (2, 5, min(12, n - M)):
            controls = strip_controls(rng, K, n - M)
            A_list = tuple(pow(a, 1 << k, C) for k in range(K))
            for dtype in (torch.bfloat16, torch.float32):
                held(random_planar(rng, n, dtype, device, normalize=False), C, A_list, controls, M, f"n={n}")
            out.append(f"oracle_strip n={n} M={M} C={C} controls {controls}: bfloat16 and float32, "
                       f"{width}-byte strips: exact")
    # The narrowest rows the engine sends: one sector a bf16 row (one 32-byte strip, two 16-byte ones).
    M, C, controls = 6, 61, (3, 1, 0, 2)
    A_list = tuple(pow(2, 1 << k, C) for k in range(len(controls)))
    for dtype in (torch.bfloat16, torch.float32):
        held(random_planar(rng, M + len(controls), dtype, device, normalize=False), C, A_list, controls, M, "narrow")
    # Controls above a strip's column bits: a quarter of the strips skipped.
    for M, C, a in STRIP_CASES:
        held(random_planar(rng, n, torch.bfloat16, device, normalize=False), C, (a, a * a % C), (5, 4), M, "skip")
    out.append(f"oracle_strip n={M + len(controls)} M=6 (rows of one sector at bf16), and controls (5, 4) at "
               f"n={n}, M=6/9/13 (strips with neither bit set skipped): exact; the card's room {room} bytes")
    C, A_list, controls = 8191, (3, 9), (0, 3)
    refusals = (
        (TypeError, lambda: random_planar(rng, n, torch.float64, device), 13),
        (ValueError, lambda: torch.zeros(2 * (1 << n) + 8, dtype=torch.bfloat16, device=device)[1:1 + (2 << n)]
         .view(2, 1 << n), 13),
        (ValueError, lambda: torch.zeros((2, 1 << n), dtype=torch.bfloat16, device=device), 14),
    )
    for error, make, M in refusals:
        before = oracle.LAUNCHES["strip"]
        try:
            oracle.apply_camodc_run_inplace_planar(make(), C, A_list, controls, M)
        except error:
            pass
        else:
            raise KernelCheckFailure(f"the strip pass took M={M}: no {error.__name__}")
        _check(oracle.LAUNCHES["strip"] == before, "a refused strip pass counted a launch")
    state = torch.zeros((2, 1 << n), dtype=torch.bfloat16, device=device)
    tab = torch.tensor([pow(3, -1, C), pow(9, -1, C), 0, 3], dtype=torch.int32, device=device)
    err = _build.entry("qc_oracle_strip", torch.bfloat16)(
        state[0].data_ptr(), state[1].data_ptr(), tab.data_ptr(), 2, C, 13, n - 13, 32,
        torch.cuda.current_stream(device).cuda_stream)
    torch.cuda.synchronize()
    _check(err != 0, "the strip kernel took 32-byte strips of 8191 rows")
    out.append("oracle_strip refusals (float64, unaligned plane, M=14; the kernel: 32-byte strips at C=8191): raised")
    return out


def strip_merged_stage(device) -> List[str]:
    """The m_high oracle stage of the n = 28 flagship (GATHER_FLAGSHIP) run
    merged, at float32 and bf16: the plan applied by apply_circuit_fused_
    launches exactly one strip pass (the walks and the ladder, oracle.
    strip_pays) and no cycle walk or ladder, returns the input planes, and
    equals bit for bit the same plan applied entry by entry (norms=[]: the
    walks one by one, the ladder out of place)."""
    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit_mhigh
    from quantumcomputer_tpu_torch.sim import engine

    C, a, L, M = GATHER_FLAGSHIP
    n = L + M
    circuit = shor_circuit_mhigh(C, a, L, M)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        plan = engine.plan_circuit(circuit, 0, n, dtype, device)
        before = dict(oracle.LAUNCHES)
        state = sv.initial_planar(n, dtype, 1 << L, device)
        merged = engine.apply_circuit_fused_(state, circuit, 0, plan)
        torch.cuda.synchronize()
        launched = {k: oracle.LAUNCHES[k] - before[k] for k in before}
        _check(merged is state, f"the merged {_name(dtype)} stage returned another buffer than its input")
        _check(launched["strip"] == 1 and launched["cycle"] == launched["ladder"] == 0,
               f"the {_name(dtype)} oracle stage at n={n} did not run as one strip pass: {launched}")
        per_entry = engine.apply_circuit_fused_(sv.initial_planar(n, dtype, 1 << L, device), circuit, 0, plan, norms=[])
        torch.cuda.synchronize()
        _check(torch.equal(merged, per_entry),
               f"the merged {_name(dtype)} stage at n={n} differs from its plan applied entry by entry")
        singles = [e[1] for e in plan if e[0] == "single"]
        out.append(f"strip_merged_stage n={n} {_name(dtype)}: {len(singles)} plan entries "
                   f"({sum(len(g.qubits) for g in singles)} gates) in one strip pass, launches {launched}; equal bit "
                   f"for bit to the plan applied entry by entry")
        del state, merged, per_entry
        torch.cuda.empty_cache()
    return out


def ladder_unsorted_controls(device) -> List[str]:
    """The ladder at controls (0, 5, 3): low, unsorted column bits."""
    C, a, M, n, controls = 33, 7, 6, 21, (0, 5, 3)
    A_list = tuple(pow(a, 1 << k, C) for k in range(len(controls)))
    out = []
    for dtype in DTYPES:
        state = random_planar(np.random.default_rng(41), n, dtype, device)
        want = tops.apply_camodc_ladder_high_planes_(state.clone(), C, A_list, controls, M)
        got = oracle.apply_camodc_ladder_high_planar(state, torch.empty_like(state), C, A_list, controls, M)
        torch.cuda.synchronize()
        err = exact_err(got, want)
        _check(err == 0.0, f"ladder controls {controls} {_name(dtype)}: {err} != 0")
        out.append(f"ladder controls {controls} n={n} {_name(dtype)}: exact")
    return out


def gather_oracle_controls(device) -> List[str]:
    """The row-gather oracle at (n, control) (17, 3) and (21, 13), one launch
    each."""
    C, A, M = 33, 29, 6
    out = []
    for dtype in DTYPES:
        for n, c in ((17, 3), (21, 13)):
            state = random_planar(np.random.default_rng(n + c), n, dtype, device)
            want = tops.apply_camodc_high_planes_(state.clone(), C, A, c, M)
            before = oracle.LAUNCHES["gather"]
            got = oracle.apply_camodc_high_planar(state, torch.empty_like(state), C, A, c, M)
            torch.cuda.synchronize()
            _check(oracle.LAUNCHES["gather"] == before + 1, "the row gather launched no kernel")
            _check(torch.equal(got, want), f"row gather n={n} control {c} {_name(dtype)} differs")
            out.append(f"oracle_gather n={n} control {c} {_name(dtype)}: exact")
    return out


def chunk_gather_narrow(device) -> List[str]:
    """The four chunk-gather forms at P = 2^16 with 1536-wide chunks whose
    starts run past both ends of the plane."""
    out = []
    for dtype in DTYPES:
        g = torch.Generator().manual_seed(2)
        P, W, NC = 1 << 16, 1536, 300
        x = torch.randn((2, P), dtype=dtype, generator=g).to(device)
        x2 = torch.randn((2, 2 * W), dtype=dtype, generator=g).to(device)
        s0 = torch.randint(-W, P + W, (NC,), generator=g).to(device)
        s1 = torch.randint(-W, P + W, (NC,), generator=g).to(device)
        istar = torch.randint(-5, W + 5, (NC,), generator=g).to(device)
        flags = torch.randint(0, 2, (NC,), generator=g).to(device)
        pairs = [
            (chunkgather.chunk_gather(x, s0, W), chunkgather.chunk_gather_plain(x, s0, W)),
            (chunkgather.chunk_gather_src2(x, x2, s0, flags, W), chunkgather.chunk_gather_src2_plain(x, x2, s0, flags, W)),
            (chunkgather.chunk_gather_blend(x, s0, s1, istar, W), chunkgather.chunk_gather_blend_plain(x, s0, s1, istar, W)),
            (
                chunkgather.chunk_gather_blend_rowlaw(x, 200, 1700, 1792, W),
                chunkgather.chunk_gather_blend_rowlaw_plain(x, 200, 1700, 1792, W),
            ),
        ]
        torch.cuda.synchronize()
        for form, (got, want) in zip(("gather", "src2", "blend", "rowlaw"), pairs):
            _check(torch.equal(got, want), f"chunk_gather {form} W={W} {_name(dtype)} differs")
        out.append(f"chunk_gather four forms P=2^16 W={W} {_name(dtype)}: exact")
    return out


def _stride_multipliers_m22() -> List[int]:
    """The first three planned multipliers of C = 2^22 - 3 in a seeded draw."""
    M = 22
    C = (1 << M) - 3
    rng = np.random.default_rng(22)
    mults = []
    for a in rng.integers(2, C - 1, 4000):
        a = int(a)
        if math.gcd(a, C) == 1 and modperm.plan_stride_permute(C, a, M) is not None:
            mults.append(a)
            if len(mults) == 3:
                break
    return mults


def stride_permute_m22(device) -> List[str]:
    """apply_stride_permute at M = 22 (C = 2^22 - 3) for three planned
    multipliers, against the element map."""
    M = 22
    C = (1 << M) - 3
    mults = _stride_multipliers_m22()
    x = torch.randn((1, 1 << M), generator=torch.Generator().manual_seed(3))
    j = torch.arange(1 << M)
    for a_inv in mults:
        got = modperm.modmul_stride_permute(x.to(device), C, a_inv, M).cpu()
        _check(torch.equal(got, x[:, torch.where(j < C, (a_inv * j) % C, j)]), f"stride permute M=22 a_inv={a_inv} differs")
    return [f"apply_stride_permute M={M} a_inv {mults}: exact"]


# The semiclassical cell (C, a, L, M) and two of its planned steps: step 0
# (eps +1, u = 9179, v = 26974) and step 2 (eps -1, u = 2732, v = 6451).
SC_CELL = (1060314373, 2, 45, 30)
SC_CELL_STEPS = (0, 2)


def _old_leg_launches() -> int:
    return transpose.LAUNCHES + sum(chunkgather.LAUNCHES.values())


def _permute_exact(x: torch.Tensor, plan, a_inv: int, what: str) -> None:
    """apply_stride_permute on the card: one offset-transpose launch a leg
    of a plane and none of the old legs' kernels, equal bit for bit to the
    plain legs and to the gather."""
    C, M = plan.C, plan.M
    before, old = transpose.OFFSET_LAUNCHES, _old_leg_launches()
    got = modperm.apply_stride_permute(x, plan)
    torch.cuda.synchronize()
    launched = transpose.OFFSET_LAUNCHES - before
    _check(launched == len(modperm.legs(plan)) and _old_leg_launches() == old,
           f"{what}: {launched} offset-transpose launches for {len(modperm.legs(plan))} legs, "
           f"old legs {_old_leg_launches() - old}")
    want = x
    for R, m, leg, sign in modperm.legs(plan):
        want = transpose.offset_transpose_plain(want, C, R, m, sign, leg)
    _check(torch.equal(got, want), f"{what}: differs from the plain legs")
    del want
    gather = tops.modmul_permute_onchip(a_inv, torch.arange(1 << M, device=x.device), C)
    _check(torch.equal(got, x[:, gather]), f"{what}: differs from the gather")


def offset_transpose_legs(device) -> List[str]:
    """The offset transpose (ops/transpose.offset_transpose), one launch a
    leg of apply_stride_permute, against its plain version and the gather,
    bit for bit: at M = 22 (C = 2^22 - 3, the multipliers of
    ``stride_permute_m22``, one and two planes) and at M = 30 on the
    semiclassical cell's steps 0 and 2 (eps +1 and -1), float32 and bf16,
    counting one launch a leg and none of the old legs' kernels.  Each M = 30
    leg is timed alone beside its bound (one read and one write of the
    plane) and its plain version, and the plane's ``index_select`` by the
    same permutation beside it; the reversal alone (a_inv = -1, one launch
    with R = 1) likewise, beside the flip and concatenation it replaces.  Then whole M = 24 attempts at complex64 and
    complex32: len(legs) launches a plane of each structured step, none of
    the old legs'."""
    lines = []
    M = 22
    C = (1 << M) - 3
    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 2):
            x = torch.randn((B, 1 << M), generator=torch.Generator().manual_seed(B)).to(device=device, dtype=dtype)
            for a_inv in _stride_multipliers_m22():
                _permute_exact(x, modperm.plan_stride_permute(C, a_inv, M), a_inv, f"offset legs M=22 B={B} {_name(dtype)} a_inv={a_inv}")
        lines.append(f"offset transpose M=22 {_name(dtype)} B=1, 2 a_inv {_stride_multipliers_m22()}: exact, one launch a leg")
    C, a, L, M = SC_CELL
    ladder = [pow(pow(a, 1 << (L - 1 - s), C), -1, C) for s in range(L)]
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((1, 1 << M), generator=torch.Generator().manual_seed(30)).to(device=device, dtype=dtype)
        nbytes = 2 * x.numel() * x.element_size()
        bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        for step in SC_CELL_STEPS:
            plan = modperm.plan_stride_permute(C, ladder[step], M)
            what = f"offset legs M=30 {_name(dtype)} step {step} (eps {plan.eps}, u {plan.u}, v {plan.v})"
            _permute_exact(x, plan, ladder[step], what)
            torch.cuda.empty_cache()
            times = []
            for R, m, leg, sign in modperm.legs(plan):
                k_ms = profiling.cuda_ms(lambda: transpose.offset_transpose(x, C, R, m, sign, leg), reps=10)
                p_ms = profiling.cuda_ms(lambda: transpose.offset_transpose_plain(x, C, R, m, sign, leg), reps=2)
                times.append(f"{'collect' if leg == transpose.COLLECT else 'deal'} R={R} sign {sign} {k_ms:.4f} ms "
                             f"(bound {bound_ms:.4f}, {bound_ms / k_ms:.1%}; plain {p_ms:.3f})")
            idx = tops.modmul_permute_onchip(ladder[step], torch.arange(1 << M, device=device), C)
            lib_ms = profiling.cuda_ms(lambda: x.index_select(1, idx), reps=3)
            del idx
            torch.cuda.empty_cache()
            lines.append(f"{what}: exact against the plain legs and the gather; {'; '.join(times)}; "
                         f"index_select {lib_ms:.4f} ms")
        # The reversal alone (a_inv = -1: R = 1, a straight copy read
        # backwards), beside the flip and concatenation it replaces.
        plan = modperm.plan_stride_permute(C, C - 1, M)
        _permute_exact(x, plan, C - 1, f"reversal alone M=30 {_name(dtype)}")
        _check(torch.equal(modperm.apply_stride_permute(x, plan), modperm._negate_mod(x, C)),
               f"reversal alone M=30 {_name(dtype)}: differs from the flip and concatenation")
        torch.cuda.empty_cache()
        R, m, leg, sign = modperm.legs(plan)[0]
        k_ms = profiling.cuda_ms(lambda: transpose.offset_transpose(x, C, R, m, sign, leg), reps=10)
        f_ms = profiling.cuda_ms(lambda: modperm._negate_mod(x, C), reps=5)
        lines.append(f"reversal alone M=30 {_name(dtype)} (R={R} sign {sign}): exact against the plain leg, the gather "
                     f"and the flip and concatenation; {k_ms:.4f} ms (bound {bound_ms:.4f}, {bound_ms / k_ms:.1%}); "
                     f"flip and concatenation {f_ms:.4f} ms")
        del x
        torch.cuda.empty_cache()
    C, a, L, M = (1 << 24) - 3, 7, 8, 24
    rs = np.random.default_rng(24).random(L)
    for dtype in (torch.complex64, "complex32"):
        before, old = transpose.OFFSET_LAUNCHES, _old_leg_launches()
        rec = semiclassical.run_semiclassical(C, a, L, M, rs, dtype=dtype, structured=True, device=device)
        plans = semiclassical._structured_plans(C, [pow(pow(a, 1 << (L - 1 - s), C), -1, C) for s in range(L)], M)
        want = sum(2 * len(modperm.legs(p)) for p in plans if p is not None)
        launched = transpose.OFFSET_LAUNCHES - before
        _check(rec.oracles.count("structured") > 0, f"no step of the M={M} attempt planned")
        _check(launched == want and _old_leg_launches() == old,
               f"sc attempt {dtype} M={M}: {launched} offset-transpose launches, {want} legs, "
               f"old legs {_old_leg_launches() - old}")
        lines.append(f"sc attempt {dtype} M={M} L={L}: {launched} offset-transpose launches for "
                     f"{rec.oracles.count('structured')} structured steps (len(legs) a plane), old legs 0")
    return lines


def probe_kernels(device) -> List[str]:
    """The probes on a 2^16 plane (W = 2048): the three chunk probes at
    aligned, in-range and out-of-range starts, and both rolls; mxuroll also
    at W = 1024 (half of its 16-row step) and W = 20480 (a chunk over two
    blocks, the second of 32 rows)."""
    M = 16
    dim = 1 << M
    out = []
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(dim).astype(np.float32)).to(device)
    rng = np.random.default_rng(9)
    for name, W in (("copy", 2048), ("roll2", 2048), ("mxuroll", 2048), ("mxuroll", 1024), ("mxuroll", 20480)):
        nc = dim // W
        starts = (np.arange(nc) * W, rng.integers(0, dim - W - 1024, nc), rng.integers(-3000, dim + 3000, nc))
        fn = getattr(probes, f"chunk_{name}")
        plain = probes.chunk_copy_plain if name == "copy" else probes.chunk_gather_plain
        for st in starts:
            s = torch.from_numpy(st.astype(np.int32)).to(device)
            before = probes.LAUNCHES[name]
            got = fn(x, s, W)
            torch.cuda.synchronize()
            _check(probes.LAUNCHES[name] == before + 1, f"probe {name} launched no kernel")
            _check(torch.equal(got, plain(x, s, W)), f"probe {name} W={W} differs")
        out.append(f"probe_{name} M={M} W={W}, aligned / in-range / out-of-range starts: exact")
    rng = np.random.default_rng(10)
    x3 = torch.from_numpy(rng.standard_normal((300, 8, 128)).astype(np.float32)).to(device)
    for per_row in (False, True):
        c = torch.from_numpy(rng.integers(-300, 300, 2400 if per_row else 300).astype(np.int32)).to(device)
        fn, plain = (probes.rowroll, probes.rowroll_plain) if per_row else (probes.dynroll, probes.dynroll_plain)
        got = fn(x3, c)
        torch.cuda.synchronize()
        _check(torch.equal(got, plain(x3, c)), f"probe {'rowroll' if per_row else 'dynroll'} differs")
        out.append(f"probe_{'rowroll' if per_row else 'dynroll'} (300, 8, 128): exact")
    return out


def _camodc_segment(planar: torch.Tensor, gates, M: int) -> Tuple[int, int]:
    """The one fused segment of a camodc circuit, run in place on `planar`
    and held exactly against plain_segment and plain_permute: (its
    camodc-segment launches, its launches of the camodc permutation)."""
    n = int(planar.shape[1]).bit_length() - 1
    ((kind, ops, axes),) = fused.plan_circuit(gates, n, M, fused.TILE_BITS[planar.dtype], fuse_oracle=True)
    want = fused.plain_segment(planar, ops, M)
    _check(torch.equal(fused.plain_permute(planar, ops, M), want), f"plain_permute differs from plain_segment on {ops}")
    camodc, permute = fused.CAMODC_LAUNCHES, fused.PERMUTE_LAUNCHES
    fused.apply_fused(planar, ops, axes, M)
    torch.cuda.synchronize()
    _check(torch.equal(planar, want), f"camodc segment {ops} {_name(planar.dtype)} differs")
    return fused.CAMODC_LAUNCHES - camodc, fused.PERMUTE_LAUNCHES - permute


def camodc_router_shapes(device) -> List[str]:
    """Camodc-only segments that the router (fused.kernel_body) must send to
    the fused kernel's camodc op, not the camodc permutation: planes that
    are not 16-byte aligned (a state one element into its buffer), at
    float32, float64 and bf16, and bf16 work blocks of 8 bytes (M = 2)."""
    out = []
    for dtype in DTYPES + (torch.bfloat16,):
        n, M, gates = 16, 8, (cir.CAMODC(251, 13, 9), cir.CAMODC(251, 15, 15))
        psi = random_planar(np.random.default_rng(12), n, dtype, device).reshape(-1)
        buf = torch.empty(psi.numel() + 1, dtype=dtype, device=device)
        planar = buf[1:].view(2, -1)
        planar.copy_(psi.view(2, -1))
        _check(planar.data_ptr() % 16 != 0, "the offset planes are aligned")
        launched = _camodc_segment(planar, gates, M)
        _check(launched == (1, 0), f"unaligned {_name(dtype)}: (camodc, permute) launches {launched} != (1, 0)")
        out.append(f"camodc unaligned planes n={n} M={M} {_name(dtype)}: fused kernel, exact")
    n, M, gates = 10, 2, (cir.CAMODC(3, 2, 5), cir.CAMODC(3, 2, 9))
    launched = _camodc_segment(random_planar(np.random.default_rng(13), n, torch.bfloat16, device), gates, M)
    _check(launched == (1, 0), f"tiny bf16 work blocks: (camodc, permute) launches {launched} != (1, 0)")
    out.append(f"camodc 8-byte bf16 work blocks n={n} M={M}: fused kernel, exact")
    return out


GATHER_FLAGSHIP = (8191, 3, 15, 13)  # C, a, L, M: the benchmark's n = 28 cells


def gather_oracle_flagship(device) -> List[str]:
    """The gather oracle on the n = 28 flagship at complex64 and complex32:
    the engine's run, every lone oracle gate its one-op camodc segment and
    so one launch of the camodc permutation, equal bit for bit to its plan
    run entry by entry with the torch gather (gates.apply_c_amodc_planes_)
    for each oracle; a run and one attempt (shor.find_period) launch the
    permutation L times (PERMUTE_LAUNCHES) beside the plan's fused segments
    (LAUNCHES - PERMUTE_LAUNCHES); the run's peak holds the state and no
    half-plane temporary.  Then every camodc-only segment of the benes
    n = 28 plan: its case tables built on the card equal
    permute_descriptor's."""
    from quantumcomputer_tpu_torch.algorithms import shor
    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    def counts():  # segment launches (LAUNCHES - PERMUTE_LAUNCHES), permutation launches
        return fused.LAUNCHES - fused.PERMUTE_LAUNCHES, fused.PERMUTE_LAUNCHES

    C, a, L, M = GATHER_FLAGSHIP
    circuit = shor_circuit(C, a, L, M)
    lines = []
    for dtype in (torch.complex64, "complex32"):
        eng = StateVectorEngine(Register(L, M), dtype=dtype, backend="cuda", device=device)
        plan = eng._plan(circuit)
        segments = sum(entry[0] == "fused" for entry in plan)
        eng.run(circuit)  # the kernels and tables once
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = counts()
        got = eng.run(circuit)
        torch.cuda.synchronize(device)
        extra = torch.cuda.max_memory_allocated(device) - base - got.numel() * got.element_size()
        run = tuple(x - y for x, y in zip(counts(), before))
        want = eng.initial_state()
        for entry in plan:
            if entry[0] == "fused":
                fused.apply_fused(want, entry[1], entry[2], M)
            else:
                g = entry[1]
                _check(g.name == "camodc", f"unexpected single gate {g} in the gather plan")
                tops.apply_c_amodc_planes_(want, g.meta[0], g.meta[1], g.qubits[0], M)
        torch.cuda.synchronize(device)
        what = f"gather oracle n={L + M} {dtype}"
        _check(torch.equal(got, want), f"{what}: the run differs from the torch gather's")
        del got, want
        before = counts()
        shor.find_period(eng, C, a, 0.5)
        attempt = tuple(x - y for x, y in zip(counts(), before))
        _check(run == attempt == (segments, L),
               f"{what}: (segment, permute) launches {run} a run, {attempt} an attempt != ({segments}, {L})")
        half_plane = (1 << (L + M - 1)) * torch.empty((), dtype=eng.real_dtype).element_size()
        _check(extra < half_plane // 4, f"{what}: the run's peak is {extra} bytes over its state")
        lines.append(f"{what}: {L} permute launches an attempt beside {segments} segments, equal to the torch "
                     f"gather bit for bit; peak {extra} bytes over the state (the gather's temporary: {half_plane})")
        del eng
        torch.cuda.empty_cache()
    plan = fused.plan_circuit(circuit, L + M, M, fused.TILE_BITS[torch.float32], fuse_oracle=True)
    pure = [entry[1] for entry in plan if entry[0] == "fused" and all(op[0] == "camodc" for op in entry[1])]
    for ops in pure:
        positions, tables = fused._permute_tables(ops, L + M, M, device)
        want_positions, _, _, rows = fused.permute_descriptor(ops, L + M, M)
        _check(tables.device.type == "cuda" and positions == want_positions
               and torch.equal(tables.cpu(), torch.from_numpy(rows.view(np.int16))),
               f"benes n={L + M} segment {ops}: the case tables built on the card differ from permute_descriptor's")
    lines.append(f"benes n={L + M}: the case tables of its {len(pure)} camodc-only segments built on the card, "
                 f"equal to permute_descriptor's")
    return lines


def camodc_few_changed_blocks(device) -> List[str]:
    """The camodc permutation with fewer items (planes of changed work
    blocks) than the card has streaming multiprocessors, so the grid is cut
    to the items: n = 16, M = 13 (8 work blocks), one op, a pair and a pair
    on one control, at float32, float64 and bf16."""
    C, M, n = 8191, 13, 16
    out = []
    for dtype in DTYPES + (torch.bfloat16,):
        for gates in ((cir.CAMODC(C, 3, 13),), (cir.CAMODC(C, 3, 13), cir.CAMODC(C, 9, 15)),
                      (cir.CAMODC(C, 3, 14), cir.CAMODC(C, 9, 14))):
            launched = _camodc_segment(random_planar(np.random.default_rng(14), n, dtype, device), gates, M)
            _check(launched == (1, 1), f"few blocks {_name(dtype)}: (camodc, permute) launches {launched} != (1, 1)")
        out.append(f"camodc permutation n={n} M={M}, 4-6 changed blocks, {_name(dtype)}: exact")
    return out


def boundary_draws(planar: torch.Tensor, per_block: int = 8) -> List[float]:
    """Draws of a hierarchical sample whose scaled value lands on, or one
    float32 step beside, a cumulative boundary: every block boundary and
    `per_block` element boundaries in three blocks (the knife edges where a
    different scan would pick another index)."""
    sums = measure.block_sums_plain(planar)
    cum = torch.cumsum(sums, 0)
    _, block = measure.block_geom(planar.shape[1])
    targets = list(cum[:-1].cpu())
    for b in (0, 3, sums.shape[0] // 2):
        local = torch.cumsum(sv.probabilities(planar[:, b * block : (b + 1) * block]), 0)
        targets += list((cum[b] - sums[b] + local[:: max(1, block // per_block)]).cpu())
    draws = []
    for t in targets:
        r = np.float32(float(t / cum[-1].cpu()))
        draws += [float(np.nextafter(r, np.float32(-1))), float(r), float(np.nextafter(r, np.float32(2)))]
    return [r for r in draws if 0.0 <= r < 1.0]


def batched_sampler(device) -> List[str]:
    """The batched sampler (measure.sample_indices) on the card: one
    block-sum launch for all draws, and for every draw, knife edges
    included, the index of the per-draw sampler, at float32 and bf16."""
    lines = []
    rng = np.random.default_rng(13)
    for dtype in (torch.float32, torch.bfloat16):
        planar = random_planar(rng, 20, torch.float64, device)
        planar *= torch.exp(-torch.arange(1 << 20, device=device, dtype=torch.float64) / float(1 << 17))
        planar = (planar / planar.square().sum().sqrt()).to(dtype)
        draws = boundary_draws(planar) + [float(r) for r in rng.random(100)]
        before = measure.LAUNCHES
        batched = measure.sample_indices(planar, draws)
        _check(measure.LAUNCHES == before + 1, f"sample_indices {_name(dtype)}: {measure.LAUNCHES - before} launches")
        single = [measure.sample_index(planar, r) for r in draws]
        differ = [(r, x, y) for r, x, y in zip(draws, batched.tolist(), single) if x != y]
        _check(not differ, f"sample_indices {_name(dtype)} differs from the per-draw sampler at {differ[:5]}")
        lines.append(f"sample_indices {_name(dtype)} n=20: {len(draws)} draws (knife edges included) equal per draw")
    return lines


def mcphase_planes(device) -> List[str]:
    """The planar mcphase on the card against the same op on CPU planes,
    exactly, at float32, float64 and bf16, with controls of one bit, of
    runs and of every bit (a 0-d view)."""
    rng = np.random.default_rng(14)
    lines = []
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        for controls in ((0,), (19,), (3, 4, 5, 11), tuple(range(20))):
            host = random_planar(rng, 20, torch.float64, "cpu", normalize=False).to(dtype)
            card = host.to(device)
            tops.apply_mcphase_planes_(card, controls, 2.1)
            tops.apply_mcphase_planes_(host, controls, 2.1)
            err = exact_err(card.cpu(), host)
            _check(err == 0, f"mcphase {_name(dtype)} controls {controls}: {err}")
        lines.append(f"mcphase {_name(dtype)} n=20: 4 control sets exact")
    return lines


def _sc_inputs(M: int, dtype, device, seed: int) -> tuple:
    """A normalized work state on the card, a rotation of its amplitudes as
    the permuted planes (gr, gi), and cos / sin of pi * 0.3."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((2, 1 << M), generator=gen, device=device, dtype=dtype)
    w /= torch.linalg.vector_norm(w)
    g = torch.roll(w, 1 + (1 << (M - 3)), dims=1)
    theta = torch.tensor(0.3, dtype=dtype, device=device) * torch.tensor(math.pi, dtype=dtype, device=device)
    return w, g[0], g[1], torch.cos(theta), torch.sin(theta)


def _sc_attempts(device) -> List[str]:
    """Whole M = 24 attempts through the two kernels against the same
    attempts on the CPU (the step's PyTorch composition) under the same
    draws: equal bits, and one launch of each kernel a structured step."""
    C, a, L, M = (1 << 24) - 3, 7, 8, 24
    rs = np.random.default_rng(24).random(L)
    lines = []
    for dtype in (torch.complex64, torch.complex128):
        before = dict(sc_step.LAUNCHES)
        rec = semiclassical.run_semiclassical(C, a, L, M, rs, dtype=dtype, structured=True, device=device)
        planned = rec.oracles.count("structured")
        launched = {k: sc_step.LAUNCHES[k] - before[k] for k in before}
        _check(planned > 0, f"no step of the M={M} attempt planned")
        _check(launched == {"branch_sums": planned, "collapse": planned},
               f"sc_step launches {launched}, {planned} structured steps")
        ref = semiclassical.run_semiclassical(C, a, L, M, rs, dtype=dtype, structured=True, device="cpu")
        _check(rec.bits == ref.bits, f"sc attempt {dtype} bits {rec.bits} != the CPU's {ref.bits}")
        dev = max(abs(p - q) for p, q in zip(rec.branch_probs, ref.branch_probs))
        lines.append(f"sc attempt {dtype} M={M} L={L}: bits equal to the CPU's, {planned} structured steps, "
                     f"launches {launched}, largest p_cond deviation {dev:.3e}")
    return lines


def sc_step_kernels(device) -> List[str]:
    """The semiclassical step's two kernels (ops/sc_step.py) against their
    plain versions at M = 24 (float32, float64) and M = 30 (float32): the
    sums within SC_SUM_RTOL and the same on a second launch; given the same
    sums, the state, the bit and p_cond equal for a drawn and both forced
    bits; each kernel timed beside its bound (2S and 3S over 3.35 TB/s) and
    its plain version.  Then whole M = 24 attempts (``_sc_attempts``)."""
    lines = []
    for dtype, M in ((torch.float32, 24), (torch.float64, 24), (torch.float32, 30)):
        w, gr, gi, ct, st = _sc_inputs(M, dtype, device, seed=M)
        r = torch.tensor(0.45, dtype=dtype, device=device)
        parts = sc_step.branch_sums(w, gr, gi, ct, st)
        what = f"{_name(dtype)} M={M}"
        _check(torch.equal(parts, sc_step.branch_sums(w, gr, gi, ct, st)), f"sc_branch_sums {what} varies")
        got = sc_step.reduce_partials(parts)
        want = sc_step.reduce_partials(sc_step.branch_sums_plain(w, gr, gi, ct, st))
        rel = float(((got - want).abs() / want.abs()).max())
        _check(rel <= SC_SUM_RTOL[dtype], f"sc_branch_sums {what}: rel {rel} > {SC_SUM_RTOL[dtype]}")
        for force in (-1, 0, 1):
            wk, wp = w.clone(), w.clone()
            bk, pk = sc_step.collapse(wk, gr, gi, ct, st, parts, r, force)
            bp, pp = sc_step.collapse_plain(wp, gr, gi, ct, st, parts, r, force)
            _check(int(bk) == int(bp) and torch.equal(pk, pp), f"sc_collapse {what} force {force}: bit or p_cond differs")
            _check(torch.equal(wk, wp), f"sc_collapse {what} force {force}: state differs by {exact_err(wk, wp)}")
            del wk, wp
        nbytes = 2 * (1 << M) * w.element_size()
        wk = w.clone()
        a_ms = profiling.cuda_ms(lambda: sc_step.branch_sums(w, gr, gi, ct, st), reps=10)
        b_ms = profiling.cuda_ms(lambda: sc_step.collapse(wk, gr, gi, ct, st, parts, r, -1), reps=10)
        pa_ms = profiling.cuda_ms(lambda: sc_step.branch_sums_plain(w, gr, gi, ct, st), reps=2)
        pb_ms = profiling.cuda_ms(lambda: sc_step.collapse_plain(wk, gr, gi, ct, st, parts, r, -1), reps=2)
        a_bound, b_bound = 2e3 * nbytes / HBM_BYTES_PER_S, 3e3 * nbytes / HBM_BYTES_PER_S
        lines.append(
            f"sc_step {what}: sums rel {rel:.2e}, repeatable; state, bit and p_cond equal (force -1, 0, 1); "
            f"branch_sums {a_ms:.4f} ms (bound {a_bound:.4f}, {a_bound / a_ms:.1%}; plain {pa_ms:.3f}), "
            f"collapse {b_ms:.4f} ms (bound {b_bound:.4f}, {b_bound / b_ms:.1%}; plain {pb_ms:.3f})"
        )
        del w, gr, gi, wk, parts
        torch.cuda.empty_cache()
    return lines + _sc_attempts(device)


# QAOA's passes (ops/qaoa.py) against their plain versions: the elementwise
# sums are float64 of the same float64 products in another order
# (QAOA_SUM_TOL); the mixer's reduction sums each tile's products in the
# compute dtype first, whose rounding (unit roundoff 6e-8 at float32) acts on
# terms whose magnitudes add up to at most 2 a qubit on unit states
# (QAOA_MIXER_TOL; a qubit's own term on a random state at n = 30 is about
# 2^-15).  The written planes may differ by the compute dtype's rounding (a
# contracted multiply-add), so they are held within QAOA_PLANE_TOL of the
# largest amplitude (bf16: one ulp there, for a straddled rounding).  The
# adjoint step at complex64 against the float64 tape (n = QAOA_TAPE_N) and
# against the complex128 step (n = 30): QAOA_STEP_TOL of the cut and of the
# largest gradient component (float32 rounding over about 8 n passes is some
# 1e-6).
QAOA_PLANE_TOL = {torch.float32: 1e-6, torch.float64: 1e-14, torch.bfloat16: 2.0 ** -7}
QAOA_SUM_TOL = 1e-12
QAOA_MIXER_TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-6, torch.float64: 1e-12}
QAOA_STEP_TOL = 1e-4
QAOA_TAPE_N = 20
QAOA_P = 4
QAOA_SEED = 2021
QAOA_ANGLES = np.array([[0.21, 0.43, 0.57, 0.66], [0.58, 0.45, 0.33, 0.17]])


def _qaoa_random(n: int, dtype, device, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    psi = torch.randn((2, 1 << n), generator=gen, device=device, dtype=torch.float32)
    return (psi / torch.linalg.vector_norm(psi)).to(dtype)


def _planes_close(got: torch.Tensor, want: torch.Tensor, what: str) -> str:
    err = scale = 0.0
    for lo in range(0, got.shape[1], 1 << 24):
        g, w = got[:, lo : lo + (1 << 24)].double(), want[:, lo : lo + (1 << 24)].double()
        err, scale = max(err, float((g - w).abs().max())), max(scale, float(w.abs().max()))
    rel = err / scale
    _check(rel <= QAOA_PLANE_TOL[got.dtype], f"{what}: rel {rel} > {QAOA_PLANE_TOL[got.dtype]}")
    return f"rel {rel:.1e}"


def _sums_close(got: torch.Tensor, want: torch.Tensor, what: str, tol: float = QAOA_SUM_TOL) -> float:
    err = abs(float(got) - float(want))
    _check(err <= tol, f"{what}: {float(got)!r} against {float(want)!r}")
    return err


def qaoa_kernels(device) -> List[str]:
    """The four QAOA kernels (csrc/qaoa.cu) against their plain versions on
    seeded unit states and the cost table of a seeded 3-regular graph, at
    n = 30 (float32, bf16), n = 28 (float64) and n = 6 (a tile under a
    block): the cost phase, the expectation and lambda, the gradient of
    gamma with the layer undone (and not written: the last layer), the
    mixer's reduction over each tile group; each timed beside its bound over
    3.35 TB/s.  Besides, the mixer as its segments planned once with the
    angle's values at launch (qaoa.apply_mixer), bit for bit against the
    same segments with the angle in their own descriptors."""
    from quantumcomputer_tpu_torch.algorithms import variational

    lines = []
    for dtype, n in ((torch.float32, 30), (torch.bfloat16, 30), (torch.float64, 28), (torch.float32, 6)):
        what = f"qaoa {_name(dtype)} n={n}"
        table = qaoa.CostTable(n, variational.random_regular_graph(n, 3, QAOA_SEED), device)
        psi, lam = _qaoa_random(n, dtype, device, 1), _qaoa_random(n, dtype, device, 2)
        fwd, back = (qaoa.phase_tables(table.K, [0.37], s, dtype, device)[0] for s in (-1.0, 1.0))
        sb = qaoa.state_bytes(psi)
        parts = []
        a, b = psi.clone(), psi.clone()
        qaoa.apply_phase(a, table, fwd)
        qaoa.apply_phase_plain(b, table, fwd)
        parts.append(f"phase {_planes_close(a, b, what + ' phase')}")
        del a, b
        la, lb = torch.empty_like(psi), torch.empty_like(psi)
        err = _sums_close(qaoa.expect(psi, table, la), qaoa.expect_plain(psi, table, lb), what + " expect")
        parts.append(f"expect {err:.1e}, lambda {_planes_close(la, lb, what + ' lambda')}")
        del la, lb
        for write in (True, False):
            pa, pb, ya, yb = psi.clone(), psi.clone(), lam.clone(), lam.clone()
            err = _sums_close(qaoa.cost_grad(pa, ya, table, back, write), qaoa.cost_grad_plain(pb, yb, table, back, write),
                              f"{what} cost_grad write={write}")
            _check(write or (torch.equal(pa, psi) and torch.equal(ya, lam)), f"{what} cost_grad wrote with write=False")
            parts.append(f"cost_grad(write={int(write)}) {err:.1e}, psi {_planes_close(pa, pb, what)}, "
                         f"lambda {_planes_close(ya, yb, what)}")
            del pa, pb, ya, yb
        a, b = qaoa.apply_mixer(psi.clone(), qaoa.mixer_values(n, [0.29], dtype, device)[0]), psi.clone()
        for ops, axes in qaoa.mixer_segments(n, dtype):
            fused.apply_segment(b, tuple(fused.gate_to_op(cir.RX(op[1], 0.58)) for op in ops), axes, 0)
        _check(torch.equal(a, b), f"{what} mixer: the values at launch differ from the descriptor's own")
        parts.append("mixer bit for bit")
        del a, b
        groups = qaoa.mixer_groups(n, dtype)
        err = max(_sums_close(qaoa.mixer_grad(psi, lam, g), qaoa.mixer_grad_plain(psi, lam, g[2]), f"{what} mixer {g}",
                              QAOA_MIXER_TOL[dtype]) for g in groups)
        parts.append(f"mixer_grad {len(groups)} groups, largest error {err:.1e}")
        a, b = psi.clone(), lam.clone()
        t_phase = profiling.cuda_ms(lambda: qaoa.apply_phase(a, table, fwd), reps=5)
        t_expect = profiling.cuda_ms(lambda: qaoa.expect(psi, table, a), reps=5)
        t_grad = profiling.cuda_ms(lambda: qaoa.cost_grad(a, b, table, fwd, True), reps=5)
        t_mix = [profiling.cuda_ms(lambda: qaoa.mixer_grad(psi, lam, g), reps=5) for g in groups]
        bound = lambda nbytes: 1e3 * nbytes / HBM_BYTES_PER_S  # noqa: E731
        tb = table.levels.numel()
        lines.append(
            f"{what}: " + "; ".join(parts) + f"; phase {t_phase:.3f} ms (bound {bound(2 * sb + tb):.3f}), "
            f"expect {t_expect:.3f} (bound {bound(2 * sb + tb):.3f}), cost_grad {t_grad:.3f} (bound {bound(4 * sb + tb):.3f}), "
            f"mixer_grad " + "/".join(f"{t:.3f}" for t in t_mix) + f" (bound a pass {bound(2 * sb):.3f})"
        )
        del psi, lam, a, b, table
        torch.cuda.empty_cache()
    return lines


def qaoa_adjoint(device) -> List[str]:
    """The adjoint QAOA step (variational.qaoa_step, p = 4, complex64)
    against the float64 tape (qaoa_plain) at n = QAOA_TAPE_N, and against
    the complex128 step at n = 30; the peak of the n = 30 complex64 step at
    p = 2 and p = 4 (each from a reset of the peak) within one state."""
    from quantumcomputer_tpu_torch.algorithms import qaoa_plain, variational

    lines = []

    def setup(n, dtype):
        eng = variational.qaoa_engine(n, dtype=dtype, device=device)
        return eng, qaoa.CostTable(n, variational.random_regular_graph(n, 3, QAOA_SEED), device)

    def step(eng, table, angles):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        out = variational.qaoa_step(eng, table, angles)
        return out, torch.cuda.max_memory_allocated(device) - base

    def gaps(got, want):
        return abs(got[0] - want[0]) / abs(want[0]), float(np.abs(got[1] - want[1]).max() / np.abs(want[1]).max())

    n = QAOA_TAPE_N
    got, _ = step(*setup(n, torch.complex64), QAOA_ANGLES)
    cost = torch.from_numpy(variational.maxcut_cost_vector(n, variational.random_regular_graph(n, 3, QAOA_SEED)))
    want = qaoa_plain.cut_and_gradient(cost.to(device=device, dtype=torch.float64), n, QAOA_ANGLES)
    cg, gg = gaps(got, want)
    _check(cg <= QAOA_STEP_TOL and gg <= QAOA_STEP_TOL, f"qaoa step n={n}: cut {cg}, grad {gg} against the float64 tape")
    lines.append(f"qaoa step n={n} p={QAOA_P} complex64 against the float64 tape: cut {cg:.2e}, grad {gg:.2e}")
    torch.cuda.empty_cache()
    want, _ = step(*setup(30, torch.complex128), QAOA_ANGLES)
    torch.cuda.empty_cache()
    eng, table = setup(30, torch.complex64)
    got, peak4 = step(eng, table, QAOA_ANGLES)
    cg, gg = gaps(got, want)
    _check(cg <= QAOA_STEP_TOL and gg <= QAOA_STEP_TOL, f"qaoa step n=30: cut {cg}, grad {gg} against complex128")
    _, peak2 = step(eng, table, QAOA_ANGLES[:, :2])
    state = 2 * 4 << 30
    _check(abs(peak4 - peak2) <= state, f"qaoa step n=30: peak {peak4} at p=4, {peak2} at p=2")
    ms = profiling.cuda_ms(lambda: variational.qaoa_step(eng, table, QAOA_ANGLES), reps=3)
    lines.append(f"qaoa step n=30 p={QAOA_P} complex64 against complex128: cut {cg:.2e}, grad {gg:.2e}; "
                 f"peak above the table {peak4 / 2**30:.3f} GiB (p=2: {peak2 / 2**30:.3f}); {ms:.1f} ms a step")
    torch.cuda.empty_cache()
    return lines


# The reference's largest register on one card: C, a, L, M of the flagship
# family at L + M = 32 (a 32 GiB complex64 state), its draw, and the limits
# of the benchmark's full-register cells.
SHOR32 = (8191, 3, 19, 13)
SHOR32_DRAW = 0.6180339887
SHOR32_LIMITS = {"state_gap": 1e-4, "index_gap": 2.5e-6}


def shor_orbit(C: int, a: int, L: int, M: int) -> tuple:
    """(r, x0, K) of the Shor state: the order r of a mod C, and for each of
    the 2^M work values w the exponent x0[w] with a^x0 = w mod C (-1 off the
    orbit of 1) and the count K[w] of counting values x < 2^L with
    a^x = w (numpy int64)."""
    x0 = np.full(1 << M, -1, np.int64)
    w, r = 1, 0
    while x0[w] < 0:
        x0[w], w, r = r, w * a % C, r + 1
    return r, x0, np.where(x0 >= 0, ((1 << L) - 1 - x0) // r + 1, 0)


def shor_mhigh_gaps(planar: torch.Tensor, C: int, a: int, L: int, M: int, index: int, r: float) -> dict:
    """The m_high state (physical order: work value w in the top M bits,
    counting value z in the low L) and its measured logical index against
    the closed form: after the circuit, psi(z, w) = 2^-L e^(2 pi i x0 y / N)
    sum_{k<K} e^(i phi k), y = rev_L(z), phi = 2 pi r y / N.  `state_gap`
    is ||psi - psi_ref||_2, worked out in blocks of 1024 counting values on
    the state's device in float64; `index_gap` how far draw r lies outside
    the physical-order CDF interval of the index."""
    order, x0, K = shor_orbit(C, a, L, M)
    N, W = 1 << L, 1 << M
    z = np.arange(N, dtype=np.int64)
    y = np.zeros_like(z)
    for b in range(L):
        y |= ((z >> b) & 1) << (L - 1 - b)

    def power(k):  # |sum_{j<k} e^(i phi j)|^2 / N^2 over every y
        half = np.pi * ((order * y) % N) / N
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(half == 0, float(k * k), (np.sin(k * half) / np.where(half == 0, 1.0, np.sin(half))) ** 2)
        return ratio / float(N) ** 2

    k_hi = int(K.max())
    cum = {k: np.cumsum(power(k)) for k in (k_hi, k_hi - 1) if k > 0}
    column = np.array([cum[k][-1] if k > 0 else 0.0 for k in K])
    zi, wi = index >> M, index & (W - 1)
    hi = float(column[:wi].sum() + (cum[K[wi]][zi] if K[wi] > 0 else 0.0))
    lo = hi - float(power(K[wi])[zi] if K[wi] > 0 else 0.0)

    dev = planar.device
    x0_t, K_t = torch.from_numpy(x0).to(dev)[None, :], torch.from_numpy(K).to(dev)[None, :]
    acc = torch.zeros((), dtype=torch.float64, device=dev)
    for z0 in range(0, N, 1024):
        yb = torch.from_numpy(y[z0 : z0 + 1024]).to(dev)[:, None]
        half = math.pi * ((order * yb) % N).to(torch.float64) / N
        s = torch.sin(half)
        mag = torch.where(half == 0, K_t.to(torch.float64), torch.sin(K_t * half) / torch.where(half == 0, torch.ones_like(s), s))
        mag = torch.where(x0_t >= 0, mag, torch.zeros_like(mag)) / N
        ang = 2 * math.pi * ((x0_t.clamp(min=0) * yb) % N).to(torch.float64) / N + (K_t - 1).to(torch.float64) * half
        re, im = (planar[p].view(W, N)[:, z0 : z0 + 1024].T.to(torch.float64) for p in (0, 1))
        acc += ((re - mag * torch.cos(ang)) ** 2 + (im - mag * torch.sin(ang)) ** 2).sum()
    return {"state_gap": math.sqrt(float(acc)), "index_gap": max(0.0, lo - r, r - hi)}


def shor_n32_mhigh(device) -> List[str]:
    """The n = 32 m_high attempt (C = 8191, a = 3, L = 19, M = 13) through
    StateVectorEngine on one card, unsharded: at complex64 its state and
    index within the benchmark's limits of the closed form
    (shor_mhigh_gaps); at complex32, the control, outside one of them.
    Each attempt is timed with the peak memory beside it."""
    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit_mhigh
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    C, a, L, M = SHOR32
    circuit = shor_circuit_mhigh(C, a, L, M)
    lines = []
    for dtype in (torch.complex64, "complex32"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        eng = StateVectorEngine(Register(L, M), dtype=dtype, device=device, layout="m_high")
        eng.run(circuit)  # plans; the kernels have run once
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        state = eng.run(circuit)
        t1.record()
        index = eng.logical_index(int(eng.sample(state, [SHOR32_DRAW])[0]))
        torch.cuda.synchronize(device)
        gaps = shor_mhigh_gaps(state, C, a, L, M, index, SHOR32_DRAW)
        within = all(gaps[k] <= SHOR32_LIMITS[k] for k in gaps)
        what = f"n=32 m_high {dtype}: state_gap {gaps['state_gap']:.3e}, index {index} gap {gaps['index_gap']:.3e}"
        if dtype == torch.complex64:
            _check(within, f"{what} outside {SHOR32_LIMITS}")
        else:
            _check(not within, f"{what}: the control reads inside {SHOR32_LIMITS}")
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        lines.append(f"{what} ({'within' if within else 'outside'} the limits); run {t0.elapsed_time(t1):.2f} ms, "
                     f"peak {peak:.3f} GiB")
        del state, eng
    torch.cuda.empty_cache()
    return lines


CHECKS: List[Callable[[torch.device], List[str]]] = [
    fused_random_circuit,
    fused_split_angle,
    block_sums_f64,
    walk_flagship_multipliers,
    strip_runs,
    strip_merged_stage,
    ladder_unsorted_controls,
    gather_oracle_controls,
    chunk_gather_narrow,
    stride_permute_m22,
    offset_transpose_legs,
    probe_kernels,
    camodc_router_shapes,
    camodc_few_changed_blocks,
    gather_oracle_flagship,
    batched_sampler,
    mcphase_planes,
    sc_step_kernels,
    shor_n32_mhigh,
    qaoa_kernels,
    qaoa_adjoint,
]


def run_all(device="cuda", log: Callable[[str], None] = print) -> int:
    """Every check on `device` (a CUDA device: the kernels have no CPU
    mode); logs each case and returns their count.  Raises on the first
    failure."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the kernel checks run on a CUDA device, not {device}")
    count = 0
    for check in CHECKS:
        for line in check(device):
            log(f"  {line}")
            count += 1
    return count
