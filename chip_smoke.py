#!/usr/bin/env python3
"""Smoke run of quantumcomputer_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py      # from the root of a checkout; needs one CUDA card and nvcc

Phases, each of which must pass:
  1. print the card's name and power limit; build the CUDA kernels from
     quantumcomputer_tpu_torch/ops/csrc (one nvcc per source, sm_90a) and
     print the build time, every kernel's ptxas registers and spills, and
     a line for the two matrix instances (fused_matmul.cu), one for the
     three camodc permutation instances (camodc_permute.cu), one for the
     fused kernel's bf16 direct instance and one for the mxuroll probe;
  2. hold each kernel against its plain PyTorch version on the card: every
     fused-segment op kind on seeded n = 20 states of unit-variance
     components in float32 (max abs <= 3e-5) and float64 (<= 1e-12), and
     seeded random circuits at n = 1-13 (the kernel's edge form below 4 / 3
     tile bits included) in both; the block sums in float32 (<= 1e-6); the
     m_high oracle kernels (ladder, cycle, cycle_masked, the row gather) in
     float32 and float64 at the shapes their call sites take, and the walk
     with its segment count forced to 1, 2, 3, 7 and 16, exactly (max abs
     == 0: they only move data); the camodc op (--oracle benes) at n = 20,
     M = 4, 6, 8, 13, one op and two, the control a tile-base bit, an
     exposed axis or a low bit, exactly against its plain Benes version and
     (camodc ops alone, which must launch the camodc permutation,
     camodc_permute.cu) its plain case-table gather, and mixed with H gates
     (the fused kernel's camodc op) within the tolerance above; the
     matrix groups of float32 and bf16 segments (lanemat and rowmat with
     real and complex tables, rowmat + xtable, all three in one segment,
     row stages at M = 8, a lanemat beside exposed axes) at n = 20 and
     seeded random circuits at n = 14 and 16, each launching the matrix
     instance (fused_matmul.cu), float32 within 3e-5 and bf16 within one ulp
     a pass (kernel_checks.bf16_within for grouped passes); then the
     card-only cases of the port's tests
     (quantumcomputer_tpu_torch/utils/kernel_checks.py), the strip pass
     (oracle_strip.cu) among them: bf16 and float32 exactly against its
     plain version at n = 20 (M = 6, 9, 13), n = 10 (rows of one sector)
     and with strips left alone, and its refusals; the n = 28 m_high
     oracle stage merged into one strip pass at float32 and bf16, equal bit
     for bit to the plan run entry by entry; and the semiclassical
     step's two passes (sc_step.cu) against their plain versions at M = 24
     and 30, timed, and whole M = 24 attempts against the CPU's; last, the
     n = 32 m_high attempt (C = 8191, a = 3, L = 19, M = 13, a 32 GiB
     complex64 state) through StateVectorEngine, its state within 1e-4 and
     its index within 2.5e-6 of the closed form, the complex32 run outside
     one of them;
  3. factor 15 through the CLI (-C 15 -L 3 -M 4 -a 7), through the fused
     kernel, then again with --layout m_high, through the strip pass, then
     8187 = 3 x 2729 at L + M = 32 (-L 19 -M 13 --layout m_high, unsharded),
     and -L 20 refused (exit 2); then 15 with
     --oracle benes (a segment with a camodc op must launch), with
     --strict-reference (the torch backend's plain ops: its engine must sit
     on the card and the run allocate there) and with --dtype dd64 (the
     fused kernel must launch);
  4. the flagship circuit shor_circuit(8191, 3, 15, 13) at n = 28 (a 2 GiB
     complex64 state) with backend="cuda": norm within 1e-4 of 1, final state
     within ||d||_2 <= 1e-4 of the backend="torch" run on the same card, both
     wall times; the block sums held against their plain version and timed
     beside it.  Then the same circuit in the m_high layout
     (shor_circuit_mhigh): norm, the torch backend's m_high state and the
     standard-layout state mapped physical -> logical, each within
     ||d||_2 <= 1e-4; its oracle stage (11 walks and the ladder) one strip
     pass, with no walk or ladder launched, equal bit for bit to the plan
     applied entry by entry; its segments grouped and in the butterfly form in
     turns (grouped, butterfly, butterfly, grouped), the two states within
     ||d||_2 <= 1e-4; once more with the memory budget forced below two
     states, where it must pair oracles in place (cycle_masked) and launch
     no ladder.  Every fused segment of both plans (6 standard, 4 m_high)
     held against its plain version within 3e-5 on unit-variance components
     and timed beside it and its bound, then the segments of the grouping
     planner's m_high plan that group (the float32 matrix instance), each
     also in its butterfly form and beside one torch.matmul per matrix
     product; the ladder, the cycle walk at every
     control the m_high plan walks (0-10) and the pair (13, 14) held exactly
     against their plain versions and timed beside them, their bounds and
     their library calls, and the strip pass on the whole oracle stage; the flagship with oracle="benes": no single
     oracle gate in its plan, every oracle segment launched as the camodc
     permutation, norm, within ||d||_2 <= 1e-4 of the gather engine's
     state, both runs timed in turns, and every oracle segment held exactly
     against its plain version and timed beside it, its bound (the bytes of
     the work blocks it changes) and its library call; the first one also
     on float64 planes;
  5. the main paths: factor 8187 = 2729 x 3 end to end at n = 30 with
     shors_algorithm(backend="cuda"), in the standard layout (each lone
     oracle gate one launch of the camodc permutation, L an attempt), in
     the m_high layout and with oracle="benes" (no gather oracle may run, and every
     camodc segment launches the camodc permutation); every
     kernel's launch counter is reset just before each and read just after,
     and each kernel of that path must have launched (at complex32 the
     m_high path's adjacent walks run as one strip pass, which must launch,
     in place of the cycle walk);
  6. the semiclassical engine's kernels: the offset transpose (one launch a
     leg of the structured permutation, both legs, both signs, one and two
     planes, an identity tail), and the old legs' transpose and
     chunk_gather (its four forms), off the main path, held against their
     plain versions in float32, float64 and bf16, exactly, on aligned,
     ragged and extra-row transposes and on in-range, out-of-range and
     past-the-rows offsets; apply_stride_permute held against the element
     map for planned multipliers at M = 20 and M = 28; at M = 28 (C = 2^28 -
     3, a = 7) each offset-transpose launch of one plan timed beside its
     plain version and its bound, the whole permutation of a 1 GiB plane
     beside one index_select by it, and one semiclassical step on the
     structured and on the gather path; then the
     CLI at M = 28 (-C 268435453 -L 8 -M 28 -a 7 --semiclassical --seed 3);
  7. the semiclassical main path: factor 1,060,314,373 = 32749 x 32377 at
     M = 30 (complex64, an 8 GiB work state) with
     shors_algorithm(semiclassical=True, backend="cuda"), its bits equal to
     scripts/predict_semiclassical.py's exact prediction on the same draws,
     the launch counters reset just before and read just after (one
     offset-transpose launch a leg of each plane of a structured step, none
     of the old legs' kernels; at complex64 one launch of each sc_step
     kernel a structured step);
  8. the m_high row-gather oracle (apply_camodc_high_planar) at n = 28 in the
     flagship geometry (C = 8191, A = 3, M = 13): controls 14 (the JAX
     kernel's pure blocks), 3 (mixed) and 0 (below the vector width), in
     float32, float64 and bf16, each exactly equal to its plain version and timed
     beside it and beside the in-place cycle walk on the same gate;
  9. the probe scripts at M = 28 (a 1 GiB plane, W = 16384):
     scripts.prof_chunkgather (copy at identity and 1024-aligned starts,
     roll2 and mxuroll at arbitrary starts, the transpose at the JAX
     script's shapes) and scripts.prof_rowperm (its plain torch rows, then
     dynroll and rowroll on (2, 2^28)); every row exactly equal to its
     reference, with ms and GB/s;
 10. the validation layer on the card: TABLE I (table1_experiment, 400
     shots) and the experiments CLI with --fig3; the FIG. 2 norm trace of
     factoring 39 at complex128 with fuse=False (max deviation < 1e-13, one
     fused launch per gate with an op form); run_with_norms on the n = 28
     flagship in both layouts (every norm within 1e-4 of 1, one per entry of
     the plan); the m_high flagship's spans (span_summary); and a fuse=False run at
     n = 20 whose fused-kernel launches equal its gates with an op form,
     within ||d||_2 <= 1e-5 of the fused run;
 11. complex32 (bf16 planes, f32 compute), through the bf16 instance of every
     kernel of its paths (phase 2 holds each at n = 20 against its plain
     version: the fused segment within one bf16 ulp per pass, the block sums
     within 1e-6, the camodc op, oracles, transpose and chunk gathers
     exactly): the n = 28 flagship in the standard layout, m_high and
     oracle="benes", each in turns with complex64 (the complex32 engine
     built with no device, which must sit on the card and launch the fused
     kernel), norm within 5e-3 of 1,
     ||psi_c32 - psi_c64||_2 <= 6e-3, benes equal to the gather exactly;
     the m_high flagship's matrix groups launched, and its segments timed
     grouped and in the butterfly form in turns;
     m_high below two states (cycle_masked) equal to the two-state plan
     exactly; the m_high flagship and its run below two states each
     launching the strip pass and equal bit for bit to the same plan applied
     entry by entry through the walks (run_with_norms); the strip pass on
     the plan's oracle stage (walks 0-11 and the ladder 12-14) timed beside
     the sum of its entries, its plain version, its bound and one
     advanced-indexing call, and the walks at M = 12 in 32-byte strips; every bf16 segment and oracle
     kernel of those plans timed beside its bound, each bf16 segment
     without matrix groups also beside the float32 instance's time for the
     same ops and axes, and the benes plan's six H and iQFT segments held
     and summed at both; 8187 at n = 30 in both
     layouts and with benes; the CLI on 15 and the n = 31 demo
     (-C 8189 -L 18 -M 13 -a 2 --dtype complex32 --layout m_high, seeds in
     turn until it factors, about 75% an attempt); the M = 28 semiclassical
     kernels and steps at bf16; 1,060,314,373 at M = 30 (4 GiB work state),
     bits equal to the prediction, branch deviation from the complex64
     attempt under the draws' margin; TABLE I through the experiments CLI
     and run_with_norms (float32 norms) at complex32, whose m_high run walks
     its single oracles one by one (the bf16 cycle walk's launches);
 12. checkpoint/resume: the complex32 n = 28 flagship in both layouts
     through run_with_checkpoints (6 segments of 8 gates, 1 GiB snapshots
     under a temporary directory removed afterwards), killed after segment
     3 and resumed: equal bit for bit to the uninterrupted segmented run and
     within C32_DIST_TOL of engine.run, with the snapshot seconds per GiB;
     the CLI with --checkpoint-dir (-C 21 -L 4 -M 5 -a 2 --seed 1) against
     the same line without it; the M = 28 structured semiclassical attempt
     (complex64, checkpoint_every 4, a 2 GiB snapshot) killed after its
     step-4 snapshot and resumed, its bits and branch probabilities equal
     to the uninterrupted run's and to the run's without checkpoint_dir;
     the card-only checks batched_sampler and mcphase_planes run in phase 2;
 13. the generic algorithms at n = 28, complex64 and complex32, secrets from
     a seeded numpy rng: Grover (3 iterations; the marked amplitude against
     sin 7 theta, every other against cos 7 theta / sqrt(2^28 - 1), within
     ALGO_TOL; one measure; 6 mcphase calls), Bernstein-Vazirani (three
     draws read s), Deutsch-Jozsa, Simon at 14 + 14 qubits, QPE on t = 20,
     M = 8 and semiclassical at M = 28, t = 12 (exact readouts), amplitude
     estimation (n = 18, t = 10, 2 marked: the counting register's
     distribution within AE_TV_TOL of the ideal one, the readout one the
     ideal distribution gives the draw within that distance, never the
     readout of an iterate without its oracle, and within the BHMT bound);
     one QV model circuit at m = 28 (392 U2Q) at complex64 within 1e-4 of
     complex128 and complex32 within kernel_checks.bf16_circuit_within
     (root sum of squares of the per-pass bounds) of complex64, its
     100-shot sample in one block-sum launch, equal to and
     timed beside 100 single draws; the experiments CLI with --qv 16;
 14. the variational layer: the engine's gradient (its backward runs the
     dagger circuit through the same plan and kernels) on the n = 28
     flagship at complex64 with the gather oracle, with oracle="benes" and
     in the m_high layout, and at complex32 in the m_high layout, the loss
     sum(out * w) for a seeded unit state w: p.grad equal to engine.run of
     the dagger circuit on w (torch.equal), U^dagger U |reset> within
     ||d||_2 <= 1e-4 of |reset> (complex32: kernel_checks.
     bf16_circuit_within over the passes of both plans), the complex64
     gather gradient within 1e-4 of the torch backend's, the run without a
     gradient, the forward with one and the backward timed in turns and the
     backward's launches counted; expectation_on_engine at n = 28 (TFIM,
     55 terms, and Heisenberg, 81, on tests/test_variational_engines.py's
     state), complex64 within 1e-5 sum |c_k| of the plain expectation,
     complex32 within the bound its bf16 passes give; VQE at n = 24 (TFIM,
     depth 3, 20 Adam steps) with its float64 gradient against central
     differences, a falling energy, expectation against
     expectation_on_engine at the final parameters, ms a step, peak memory
     and one step's breakdown; QAOA at n = 24, p = 2, on a seeded random
     3-regular graph (36 edges), its expected cut rising, its ratio in
     (0, 1] and its best cut counted from the edges.
 15. the sharded engine (parallel/sharded.py) on a mesh of 4 shards of the
     one card (build_mesh(devices=[cuda:0] * 4), d = 2): the n = 28
     flagship in both layouts at complex64 and complex32, each within
     ||d||_2 <= 1e-4 (complex32: C32_DIST_TOL) of the single-card state,
     its fused-segment launches exactly 4 x the local plan's segments and
     shard-local oracle gates, each a one-op camodc segment (the matrix
     groups launched at complex32), timed (CUDA events, after a
     warm-up) beside the single-card run and entry by entry (fused,
     exchanging and other entries, the transport's bytes); complex128 at
     n = 24 in both layouts within 1e-12 (max abs); 8187 factored at n = 30
     through shors_algorithm(mesh=...) in both layouts and dtypes (the
     block sums launched per shard); n = 32 at complex32 in the m_high
     layout, a 16 GiB state no single card of the port holds: its norm
     within 5e-3, its peak memory under N32_PEAK_GIB, 8 shots whose
     composed (shard, local) indices lie below 2^32 on nonzero amplitudes;
     and 1,060,314,373 at M = 30 with the work register sharded: complex32
     factored at the full depth, its bits equal to phase 11's single-card
     attempt on the same draws; complex64 at a depth of SHARDED_SC_L = 12
     of its 45 steps, its bits equal to the single card's attempt at that
     depth; 0 overflow, each step's exchange bytes printed; the shards'
     sha256, counters, plan segments, norm and the index measured at
     PROCESS_DRAW of the n = 28 runs of PROCESS_FORMS kept;
 16. the mesh across processes (parallel/comm.ProcessTransport over gloo,
     CUDA operands staged through pinned host buffers) on the one card, the
     kernel library built before and loaded by the workers
     (python3 chip_smoke.py --mesh-worker JOB, parallel/launch.run): 2
     processes x 2 shards of cuda:0 run the n = 28 flagship m_high at
     complex64 and complex32 and standard at complex64, and 4 x 1 the
     complex32 m_high one, each shard's sha256 equal to phase 15's
     one-process 4-shard run, the same measured index and norm in every
     process, the counters' calls equal on every process and their bytes
     summed over the processes equal to phase 15's, fused launches = the
     process's shards x the local plan's segments and local oracles, block sums launched by
     the measure (and matrix groups at complex32); each run's host-clock
     seconds, the bytes that crossed processes and each process's peak
     memory printed, beside a probe of one 256 MiB pinned copy each way
     and one gloo message each way; and the semiclassical attempt at M = 24
     (C = 2^24 - 3, a = 7, L = 12) across the 2 processes, its bits and
     branch probabilities equal to the one-process 4-shard attempt's and
     its exchange bytes summed equal to it.  A worker that fails or
     outlasts its limit fails the phase.

Prints a JSON kernel report and, last, {"ok": true, "device": {...}}.  Each
kernel's entry holds its launches on a main path, its max abs error, its ms
and its plain version's, bound_ms and bound_by (the larger of its bytes over
3.35 TB/s and its floating-point operations over 67 TFLOP/s) and library_ms,
the time of one PyTorch call computing the same function (named in
"library"), or null with the reason there.  fused_segment's ms, plain_ms and
bound are those of segment 0 of the standard plan (a 5-H segment); its
"segments" list holds every n = 28 segment of both plans that runs without
matrix groups, and
"segments_mean_ms" / "segments_mean_plain_ms" their means.  camodc (the
camodc permutation, camodc_permute.cu) takes its numbers from the first
oracle segment of the benes flagship (a pair), its launches from the benes
n = 30 run; its "segments" list holds every oracle segment,
"f64_segments" the first one on float64 planes, "flagship_ms" /
"flagship_gather_ms" the two runs of each flagship.  The bf16 instances have entries of their own ("<name>_bf16",
launches from the complex32 main paths, max_ulps beside max_abs_err for the
fused segment).  fused_matmul / fused_matmul_bf16 (the matrix groups)
take their numbers from the m_high iQFT segment (rowmat + xtable +
lanemat), their bound the larger of the bytes and the tensor-core products
(3xTF32 at 495 TFLOP/s, two bf16 products at 989 TFLOP/s), "segments" every
grouped segment with its butterfly form's time, "flagship_ms" /
"flagship_butterfly_ms" the m_high flagship in both forms.  oracle_strip /
oracle_strip_bf16 take their numbers from the m_high plan's oracle stage
merged (complex64: walks 0-10 and the ladder 11-14; complex32: walks 0-11
and the ladder 12-14), "entries_sum_ms" / "entry_ms" the same plan entries
one by one (each walk through the cycle walk, the ladder out of place),
oracle_strip_bf16's "m12" the walks at M = 12 in 32-byte strips.  Each kernel the
gradient's backward launched on the n = 28 flagship has "backward_launches"
(by form), and fused_segment / fused_segment_bf16 "gradient_ms" (the run,
forward and backward times of each form); fused_segment, fused_matmul and block_sums
(and their bf16 entries) "sharded_launches", their launches in phase 15's
runs by run, and "process_launches", phase 16's by run and process (block
sums: the measure's).  Any failure
exits non-zero without that line.  Imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time

DEVICE = "cuda"
KERNEL_BACKEND = "cuda"
KERNEL_N = 20
SMALL_NS = (1, 2, 3, 4, 5, 7, 10, 13)  # random circuits; n <= 3 (f32) / 2 (f64) take the edge form
FLAGSHIP = (8191, 3, 15, 13)  # C, a, L, M: n = 28
FACTOR = (8187, 13, 17, 13)  # C, a, L, M: n = 30
# Fused segments are held on states of unit-variance components, so the
# tolerance stands against values of order 1; bf16 in bf16 ulps of the plain
# result (utils/kernel_checks.bf16_ulps: the ulp taken at 2^-8 and above).
TOL = {"float32": 3e-5, "float64": 1e-12, "bfloat16": 1.0}
WALK_SEGMENT_COUNTS = (1, 2, 3, 7, 16)  # forced S of the segmented walk, at n = 20, M = 13
WALK_PAIRS = ((0, 1), (1, 2), (2, 5), (6, 3))
# (kernel, call site, controls, n, M): each case sized so that its call
# site's eligibility predicate holds, as in the JAX package's dispatch.
ORACLE_CASES = [
    ("cycle", "cycle", (0,), 20, 6),
    ("cycle", "cycle", (3,), 20, 6),
    ("cycle", "cycle", (9,), 20, 6),
    ("cycle", "cycle", (13,), 20, 6),
    ("cycle", "cycle", (3,), 20, 13),
    ("cycle_masked", "perm", (13,), 20, 6),
    ("cycle_masked", "pair", (13, 14), 21, 6),
    ("ladder", "ladder", (11, 12), 21, 6),
    ("ladder", "ladder", tuple(range(11, 15)), 21, 6),
    ("ladder", "ladder", tuple(range(11, 19)), 25, 6),
    ("oracle_gather", "gather", (0,), 17, 6),
    ("oracle_gather", "gather", (1,), 17, 6),
    ("oracle_gather", "gather", (3,), 21, 6),
    ("oracle_gather", "gather", (14,), 21, 6),
]
BLOCK_SUMS_TOL = 1e-6
FLAGSHIP_TOL = 1e-4
UNFUSED_TOL = 1e-5  # fuse=False against fuse=True at n = 20
# complex32 (bf16 planes): the norm within the JAX package's bound
# (tests/test_complex32.py:37), and ||psi_c32 - psi_c64||_2 at n = 28 within
# a bound set from the H100 readings (2.1e-3 to 2.7e-3 over the three forms)
# with about twice their largest as margin.
C32_NORM_TOL = 5e-3
C32_DIST_TOL = 6e-3
# The reference's largest register on one card (L + M = 32, complex64, m_high).
N32_CLI = ["-C", "8187", "-L", "19", "-M", "13", "--layout", "m_high", "-v", "--seed", "0"]

# The n = 31 single-card demo (README): -C 8189 -L 18 -M 13 -a 2 at complex32 in
# the m_high layout, an 8 GiB state.  By the exact outcome distribution about
# 75% of single attempts factor, so seeds are tried in turn.
C32_CLI = ["-C", "8189", "-L", "18", "-M", "13", "-a", "2", "--dtype", "complex32", "--layout", "m_high", "-v"]
C32_CLI_SEEDS = range(8)
# The camodc op's cases: M -> (C, A1, A2), the JAX suite's moduli.
CAMODC_MODULI = {4: (15, 7, 13), 6: (33, 29, 7), 8: (251, 13, 15), 13: (8191, 3, 9)}
SC_M28 = ((1 << 28) - 3, 7, 8, 28)  # C, a, L, M: the JAX bench's semiclassical configuration
SC_CLI = ["-C", "268435453", "-L", "8", "-M", "28", "-a", "7", "--semiclassical", "--seed", "3", "-v"]
SC_FACTOR = (1060314373, 2, 45, 30)  # C, a, L, M; the order of 2 mod C is 622212
SC_FACTORS = (32749, 32377)
PERMUTE_MS = (20, 28)  # apply_stride_permute against the element map at C = 2^M - 3
# Seed of the M = 30 run: of seeds 0..199 whose first attempt factors (by
# scripts/predict_semiclassical.py over this package's draws), the one with
# the widest min draw margin, 0.0994.
SC_SEED = 189
GATHER_CONTROLS = (14, 3, 0)  # pure, mixed and sub-vector controls at n = 28, M = 13
PROBE_M, PROBE_W = 28, 16384
UNFUSED = (8191, 3, 7, 13)  # C, a, L, M: n = 20
WALK_CONTROLS = tuple(range(11))  # the controls the m_high flagship plan walks (its 11 single gates)
# Checkpoint/resume of the complex32 flagship: segments of 8 gates (the
# default), a preemption after segment 3; the semiclassical attempt's draws
# from this seed.
CKPT_SEGMENT_GATES = 8
CKPT_KILL_AFTER = 3
SC_CKPT_SEED = 5
# The generic algorithms at n = 28: secrets and draws from ALGO_SEED; Grover
# with 3 iterations; QPE on t = 20 counting and M = 8 work qubits, its
# semiclassical form at M = 28 and t = 12; amplitude estimation with n = 18
# and t = 10, 2 marked items (the least work at 28 qubits whose counting
# register resolves a: its eigenphases lie 0.90 of a bin from 1/2, where an
# iterate without its oracle reads), its counting register's distribution
# within AE_TV_TOL of the ideal one in total variation; QV's full-width
# circuit held against complex128 within QV_C64_TOL, its sample of QV_SHOTS
# shots; the QV protocol at m = 16.
ALGO_SEED = 2026
ALGO_N = 28
GROVER_ITERS = 3
QPE_T, QPE_M, QPE_SC_T = 20, 8, 12
AE_N, AE_T, AE_MARKED = 18, 10, 2
# complex64 holds the ideal distribution to rounding.  complex32 cannot: the
# iterate turns an unmarked amplitude by a relative 1 - cos(theta_a) ~ 4e-6,
# far below bf16's 2^-9, so 16,374 bf16 passes drift the counting register,
# the more the larger n, as the kernels' plain versions do where the CPU can
# run them (scripts/prof_ae_drift.py, PERF.md section 6).  Its limit is read
# from those runs; an iterate without its oracle reads 0.99.
AE_TV_TOL = {"complex64": 1e-4, "complex32": 0.25}
# What the sampler's float32 cumulative sums may move a draw's place in the
# distribution by, beside the state's own distance from the ideal one.
AE_SAMPLER_SLACK = 1e-5
QV_C64_TOL = 1e-4
QV_SHOTS = 100
QV_PROTOCOL_M = 16
# Grover's amplitudes against the closed form, relative to each: complex64
# at a float32 circuit's error, complex32 at bf16 rounding over its passes.
ALGO_TOL = {"complex64": 1e-3, "complex32": 5e-2}
# The variational layer: the engine's gradient on the n = 28 flagship in
# the four forms of scripts/prof_grad.py (FORMS: name, dtype, layout,
# oracle), its cotangent prof_grad's seeded unit state; U^dagger U |reset>
# held within FLAGSHIP_TOL at complex64 and
# kernel_checks.bf16_circuit_within over both plans' passes at complex32.
# expectation_on_engine at n = 28 on tests/test_variational_engines.py's
# state (TFIM J = 1.1, h = 0.6; Heisenberg), complex64 within EXPECT_TOL of
# sum |c_k| of the plain expectation.  VQE at n = 24 (TFIM J = h = 1, open
# chain, depth 3, RY + brick, float32, Adam at 0.05, seed 0), its gradient
# at float64 against central differences (step FD_EPS, within FD_TOL) at
# FD_PARAMS; QAOA at n = 24, p = 2, on a random 3-regular graph from
# QAOA_SEED (Farhi, Goldstone and Gutmann's MaxCut family).
EXPECT_TOL = 1e-5
VAR_N, VQE_DEPTH, VAR_STEPS, VAR_LR = 24, 3, 20, 0.05
FD_EPS, FD_TOL = 1e-4, 1e-6
FD_PARAMS = ((0, 0), (1, 11), (3, 23))
QAOA_P, QAOA_DEGREE, QAOA_SEED = 2, 3, 2026
# The VQE's autograd residuals at complex64 (the reckoning of PERF.md
# section 6): (depth + 1) n rotation inputs and the 2n - 1 Pauli images of
# the energy, 128 MiB each at n = 24.
VQE_RESIDUAL_GIB = ((VQE_DEPTH + 1) * VAR_N + 2 * VAR_N - 1) * (8 << VAR_N) / 2 ** 30
# The H100 SXM's published peaks (NVIDIA's H100 datasheet): HBM bytes/s
# and float32 FLOP/s outside the tensor cores.  A kernel's bound is the
# larger of its bytes (each input read once, each output written once) and
# its operations over these.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# Dense tensor-core rates (the same datasheet): TF32 and bf16.  A matrix
# group's product has depth LANE_K (lanemat) or ROW_K (rowmat).
TF32_TC_FLOPS = 495e12
BF16_TC_FLOPS = 989e12
LANE_K, ROW_K = 128, 64
# Floating-point operations per amplitude of each fused op kind: a 2x2
# complex matrix on a pair is 4 complex multiplies and 2 adds (28 / 2); an
# iQFT butterfly 8 / 2, and its phase one complex multiply on half.
SEGMENT_FLOPS = {"u1q": 14, "diag1": 6, "diag2": 6, "iqft": 4, "u2q": 30}


class SmokeFailure(RuntimeError):
    pass


def bound(nbytes: float, flops: float = 0.0) -> tuple:
    """(bound_ms, bound_by) of work that moves nbytes and does flops."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def set_bound(entry: dict, nbytes: float, flops: float = 0.0) -> None:
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, flops)


def segment_flops(ops, M: int, n: int) -> float:
    per_amp = sum(SEGMENT_FLOPS[op[0]] + (3 if op[0] == "iqft" and op[1] > M else 0) for op in ops)
    return float(per_amp) * (1 << n)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds per call of fn on the card: CUDA events around
    `reps` calls after one warm-up call (profiling.cuda_ms)."""
    from quantumcomputer_tpu_torch.utils.profiling import cuda_ms

    return cuda_ms(fn, reps)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def op_kind_cases(rng, n: int):
    """(name, gates, M) per fused op kind, qubits spread over the low,
    middle and exposed-axis bit classes of an n-qubit state."""
    from quantumcomputer_tpu_torch.models import circuit as cir
    from quantumcomputer_tpu_torch.utils.kernel_checks import random_unitary

    h = n - 1
    return [
        ("u1q_low", (cir.U1Q(2, random_unitary(rng, 2)),), 0),
        ("u1q_mid", (cir.U1Q(9, random_unitary(rng, 2)),), 0),
        ("u1q_high", (cir.U1Q(h - 2, random_unitary(rng, 2)),), 0),
        ("diag1", (cir.RZ(h - 3, 0.7), cir.PHASE(3, 1.1)), 0),
        ("diag2", (cir.CPHASE(h, 4, 0.9), cir.CZ(12, h - 1)), 0),
        ("iqft_M0", (cir.IQFT_STAGE(h), cir.IQFT_STAGE(5)), 0),
        ("iqft_M7", (cir.IQFT_STAGE(h), cir.IQFT_STAGE(10)), 7),
        ("u2q_low", (cir.U2Q(5, 1, random_unitary(rng, 4)),), 0),
        ("u2q_mixed", (cir.U2Q(h - 4, 3, random_unitary(rng, 4)),), 0),
        ("u2q_high", (cir.U2Q(h, h - 7, random_unitary(rng, 4)), cir.CNOT(2, h - 1)), 0),
        (
            "segment_mix",
            tuple(cir.H(q) for q in range(n - 7, n)) + (cir.CPHASE(h, 0, 0.3), cir.IQFT_STAGE(h - 1)),
            4,
        ),
    ]


def matrix_cases(rng, n: int) -> list:
    """(name, gates, M) of the fused kernel's matrix groups at n qubits
    (float32 and bf16 segments group them): each kind real and complex, the
    iQFT row stages' rowmat + xtable, all three kinds in one segment (the
    m_high iQFT), row stages at M >= 7 (no xtable) and a lanemat beside
    exposed axes."""
    from quantumcomputer_tpu_torch.models import circuit as cir
    from quantumcomputer_tpu_torch.utils.kernel_checks import random_unitary

    return [
        ("lanemat real", tuple(cir.H(q) for q in range(7)), 0),
        ("lanemat complex", (cir.U1Q(1, random_unitary(rng, 2)), cir.CPHASE(5, 2, 0.7), cir.U2Q(6, 3, random_unitary(rng, 4))), 0),
        ("rowmat real", tuple(cir.H(q) for q in range(7, 13)), 0),
        ("rowmat complex", (cir.U1Q(8, random_unitary(rng, 2)), cir.CPHASE(12, 9, 0.4), cir.U2Q(11, 7, random_unitary(rng, 4))), 0),
        ("rowmat + xtable", tuple(cir.IQFT_STAGE(l) for l in range(12, 6, -1)), 0),
        ("all three", tuple(cir.IQFT_STAGE(l) for l in range(12, -1, -1)), 0),
        ("row stages M=8", tuple(cir.IQFT_STAGE(l) for l in range(12, 7, -1)) + (cir.H(3), cir.H(4)), 8),
        ("lanemat beside axes", (cir.H(0), cir.H(1), cir.H(n - 1), cir.CPHASE(n - 2, 3, 0.5), cir.H(n - 3)), 0),
    ]


@contextlib.contextmanager
def grouping(dtypes):
    """fused.GROUP_DTYPES set to `dtypes` for the block: the matrix groups
    of both instances are checked and timed whichever plane dtypes the
    planner groups on the main path."""
    from quantumcomputer_tpu_torch.ops import fused

    saved = fused.GROUP_DTYPES
    fused.GROUP_DTYPES = tuple(dtypes)
    try:
        yield
    finally:
        fused.GROUP_DTYPES = saved


def phase_matrix_kernels(report: dict, n: int = KERNEL_N) -> None:
    """The fused kernel's matrix groups against their plain versions: each
    of matrix_cases at n = 20 on unit-variance states, then seeded random
    circuits at n = 14 and 16 (M 0, 3, 8), float32 (3e-5) and bf16 (one
    ulp a pass, kernel_checks.bf16_within for grouped passes); each case
    must launch the matrix instance."""
    import numpy as np
    import torch

    from quantumcomputer_tpu_torch.ops import fused
    from quantumcomputer_tpu_torch.utils.kernel_checks import plan_states, random_circuit, random_planar

    main_path = fused.GROUP_DTYPES
    with grouping((torch.float32, torch.bfloat16)):
        for dtype in (torch.float32, torch.bfloat16):
            phase_launches = fused.MATMUL_LAUNCHES
            rng = np.random.default_rng(25)
            cases = [(name, gates, M, n) for name, gates, M in matrix_cases(rng, n)]
            cases += [(f"random M={M}", random_circuit(rng, k, 30), M, k) for k in (14, 16) for M in (0, 3, 8)]
            for name, gates, M, k in cases:
                before = fused.MATMUL_LAUNCHES
                pairs = plan_states(random_planar(rng, k, dtype, DEVICE, normalize=False), gates, M)[0]
                launched = fused.MATMUL_LAUNCHES - before
                err, text = fused_err(report, key("fused_matmul", dtype), pairs)
                log(f"kernel fused_matmul {name:19s} {dname(dtype)} n={k} M={M}: {text} (tol {TOL[dname(dtype)]:.0e}), "
                    f"{launched} matrix launch(es)")
                check(launched > 0, f"fused_matmul {name} {dname(dtype)}: no segment with a matrix group launched")
                check(err <= TOL[dname(dtype)], f"fused_matmul {name} {dname(dtype)} n={k}: {err} > {TOL[dname(dtype)]}")
            if dtype not in main_path:  # off the main path (fused.GROUP_DTYPES): its launches are this phase's
                entry = report[key("fused_matmul", dtype)]
                entry["launches"], entry["launches_from"] = fused.MATMUL_LAUNCHES - phase_launches, "the kernel phase"


def camodc_cases(n: int) -> list:
    """(name, gates, M, exact) of the camodc op (--oracle benes) at n qubits:
    at each M of CAMODC_MODULI one op and two ops on tile-base controls;
    below M = 13 (where the tile has room besides the work block) the
    control on an exposed axis (an X gate on it exposes it and moves data
    exactly) and on a low tile bit; at M = 6 and 13 a segment mixed with H
    gates, held to TOL."""
    from quantumcomputer_tpu_torch.models import circuit as cir

    cases = []
    for M, (C, A1, A2) in CAMODC_MODULI.items():
        cases.append((f"M={M} one op", (cir.CAMODC(C, A1, n - 1),), M, True))
        cases.append((f"M={M} two ops", (cir.CAMODC(C, A1, n - 1), cir.CAMODC(C, A2, n - 3)), M, True))
        if M < 13:
            cases.append((f"M={M} axis control", (cir.X(n - 2), cir.CAMODC(C, A1, n - 2), cir.CAMODC(C, A2, n - 1)), M, True))
            cases.append((f"M={M} low control", (cir.CAMODC(C, A1, M + 2), cir.CAMODC(C, A2, n - 1)), M, True))
    for M, high in ((6, (n - 1, n - 2)), (13, (10, 8))):
        C, A1, A2 = CAMODC_MODULI[M]
        gates = tuple(cir.H(q) for q in high) + (cir.CAMODC(C, A1, n - 3), cir.H(2), cir.CAMODC(C, A2, n - 1))
        cases.append((f"M={M} mixed with H", gates, M, False))
    return cases


def oracle_modulus(M: int) -> tuple:
    """(C, a) for a work register of M bits: the flagship's 8191 at M = 13,
    else the JAX suite's 33."""
    return (8191, 3) if M == 13 else (33, 7)


def run_oracle(site: str, planar, C: int, A_list, controls, M: int, plain: bool):
    """One oracle call site on `planar`: its kernel, or its plain version
    when `plain`.  Returns the tensor that holds the result."""
    import torch

    from quantumcomputer_tpu_torch.ops import gates as tops
    from quantumcomputer_tpu_torch.ops import oracle

    if site == "ladder":
        if plain:
            return tops.apply_camodc_ladder_high_planes_(planar.clone(), C, A_list, controls, M)
        return oracle.apply_camodc_ladder_high_planar(planar, torch.empty_like(planar), C, A_list, controls, M)
    if site == "gather":
        if plain:
            return tops.apply_camodc_high_planes_(planar.clone(), C, A_list[0], controls[0], M)
        return oracle.apply_camodc_high_planar(planar, torch.empty_like(planar), C, A_list[0], controls[0], M)
    if plain:
        if site == "pair":
            return tops.apply_camodc_ladder_high_planes_(planar, C, A_list, controls, M)
        return tops.apply_camodc_high_planes_(planar, C, A_list[0], controls[0], M)
    if site == "pair":
        return oracle.apply_camodc_pair_inplace_planar(planar, C, A_list, controls, M)
    if site == "perm":
        return oracle.apply_camodc_high_perm_planar(planar, C, A_list[0], controls[0], M)
    return oracle.apply_camodc_high_cycle_planar(planar, C, A_list[0], controls[0], M)


def oracle_err(site: str, planar, C: int, A_list, controls, M: int) -> float:
    """Max abs difference of the kernel and the plain version on copies of
    `planar` (synchronised, so a fault shows here)."""
    import torch

    want = run_oracle(site, planar.clone(), C, A_list, controls, M, plain=True)
    got = run_oracle(site, planar.clone(), C, A_list, controls, M, plain=False)
    torch.cuda.synchronize()
    return float((got - want).abs().max())


def time_library_row_gather(planar, C: int, A_list, controls, M: int) -> tuple:
    """(library_ms, library) of the m_high oracle at `controls`, contiguous
    column bits in order, as one advanced-indexing call out of place
    (scripts/prof_strip.library_row_gather), held exactly against the plain
    version, then timed.  The port never calls it."""
    import torch

    from quantumcomputer_tpu_torch.ops import gates as tops
    from quantumcomputer_tpu_torch.scripts.prof_strip import library_row_gather

    call, library = library_row_gather(planar, C, A_list, controls, M)
    want = tops.apply_camodc_ladder_high_planes_(planar.clone(), C, A_list, controls, M)
    err = exact_err(call(), want)
    del want
    torch.cuda.synchronize()
    check(err == 0.0, f"the library call of the oracle at controls {controls} differs: {err}")
    return time_ms(call, reps=5), library


def phase_build() -> float:
    from quantumcomputer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    seconds = time.perf_counter() - t0
    log(f"build: kernels ready in {seconds:.3f} s ({_build.library_path()})")
    entry, matrix, permute, direct, mxuroll = "", {}, {}, [], []
    with open(_build.build_log_path()) as f:
        for line in f:
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line:
                log(f"  ptxas: {entry}: {line.strip()}")
                # The matrix instances (fused_segment_kernel<S, float, 2, 4, PERM false, MAT true>).
                if "fused_segment_kernel" in entry and "Lb0ELb1E" in entry:
                    matrix.setdefault("bf16" if "bfloat16" in entry else "f32", []).append(line.strip())
                # The camodc permutation's instances (camodc_permute_kernel<element bytes>).
                for nbytes, dtype in (("2", "bf16"), ("4", "f32"), ("8", "f64")):
                    if f"camodc_permute_kernelILi{nbytes}E" in entry:
                        permute.setdefault(dtype, []).append(line.strip())
                # fused_segment_kernel<bf16, float, VB 2, NE 5, PERM false, MAT false>.
                if "fused_segment_kernelI13__nv_bfloat16fLi2ELi5ELb0ELb0E" in entry:
                    direct.append(line.strip())
                if "mxuroll_kernel" in entry:
                    mxuroll.append(line.strip())
            elif "wgmma" in line:
                log(f"  ptxas: {entry}: {line.strip()}")
    check(set(matrix) == {"f32", "bf16"}, f"no ptxas report of both matrix instances: {sorted(matrix)}")
    for dtype, lines in sorted(matrix.items()):
        log(f"ptxas matrix instance {dtype} (fused_matmul.cu): {'; '.join(lines)}")
    check(set(permute) == {"f32", "f64", "bf16"}, f"no ptxas report of the three permutation instances: {sorted(permute)}")
    for dtype, lines in sorted(permute.items()):
        log(f"ptxas camodc permutation {dtype} (camodc_permute.cu): {'; '.join(lines)}")
    for name, lines in (("fused bf16 direct instance (fused_segment.cu, 2^5 amplitudes a thread)", direct),
                        ("probe mxuroll (probes.cu)", mxuroll)):
        check(bool(lines), f"no ptxas report of the {name}")
        log(f"ptxas {name}: {'; '.join(lines)}")
    return seconds


def dname(dtype) -> str:
    return str(dtype).replace("torch.", "")


def engine_dtype(planes):
    """The engine's dtype for states of plane dtype `planes`: complex64 for
    float32 planes, the "complex32" token for bfloat16."""
    import torch

    return "complex32" if planes == torch.bfloat16 else torch.complex64


def key(kernel: str, dtype) -> str:
    """The report entry of a kernel's instance for planes of `dtype`: its
    bf16 instance has an entry of its own."""
    import torch

    return f"{kernel}_bf16" if dtype == torch.bfloat16 else kernel


def fused_err(report: dict, entry: str, pairs) -> tuple:
    """(err, text) of fused-segment results against their plain versions
    (kernel_checks.plan_states' triples: kernel, plain, the segment's matrix
    products): max abs for float32 / float64; for bf16 the max in
    bf16 ulps over the passes (with the largest share of elements that
    differ; the max abs goes to the report too), a grouped pass that
    kernel_checks.bf16_within accepts (activation straddles) counted as one
    ulp."""
    import torch

    from quantumcomputer_tpu_torch.utils.kernel_checks import bf16_ulps, bf16_within

    abs_err = max(float((g.double() - w.double()).abs().max()) for g, w, _ in pairs)
    report[entry]["max_abs_err"] = max(report[entry]["max_abs_err"], abs_err)
    if pairs[0][0].dtype != torch.bfloat16:
        return abs_err, f"max abs {abs_err:.3e}"
    stats = [bf16_ulps(g, w) for g, w, _ in pairs]
    ulps, share = max(u for u, _ in stats), max(f for _, f in stats)
    held = max(min(u, 1.0) if grouped and bf16_within(g, w, grouped) else u for (u, _), (g, w, grouped) in zip(stats, pairs))
    report[entry]["max_ulps"] = max(report[entry].get("max_ulps", 0.0), ulps)
    # The grouped passes' distance in units of the straddle rule's norm bound, 2 (R + 1) 2^-8 ||w||.
    norm_share = max((float(torch.linalg.vector_norm(g.double() - w.double()))
                      / (2 * (grouped + 1) * 2.0 ** -8 * float(torch.linalg.vector_norm(w.double())))
                      for g, w, grouped in pairs if grouped), default=0.0)
    straddle = (f" (grouped passes held by the straddle rule: {held:.3f}; norm {norm_share:.3f} of its bound)"
                if held != ulps else "")
    return held, (f"max {ulps:.3f} bf16 ulps over {len(pairs)} pass(es){straddle}, up to {share:.3e} of elements "
                  f"differ, max abs {abs_err:.3e}")


def phase_kernels(report: dict, n: int = KERNEL_N) -> None:
    import numpy as np
    import torch

    from quantumcomputer_tpu_torch.ops import measure
    from quantumcomputer_tpu_torch.utils.kernel_checks import plan_states, random_circuit, random_planar

    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        rng = np.random.default_rng(20)
        cases = [(name, gates, M, n) for name, gates, M in op_kind_cases(rng, n)]
        cases += [(f"random M={M}", random_circuit(rng, k, 30), M, k) for k in SMALL_NS for M in (0, 3, 13)]
        for name, gates, M, k in cases:
            pairs = plan_states(random_planar(rng, k, dtype, DEVICE, normalize=False), gates, M)[0]
            err, text = fused_err(report, key("fused_segment", dtype), pairs)
            log(f"kernel fused_segment {name:11s} {dname(dtype)} n={k}: {text} (tol {TOL[dname(dtype)]:.0e})")
            check(err <= TOL[dname(dtype)], f"fused_segment {name} {dname(dtype)} n={k}: {err} > {TOL[dname(dtype)]}")
    for dtype in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(21)
        planar = random_planar(rng, n, dtype, DEVICE)
        sums = measure.block_sums(planar)
        err = float((sums - measure.block_sums_plain(planar)).abs().max())
        log(f"kernel block_sums {dname(dtype)} n={n}: {dname(sums.dtype)} sums, max abs {err:.3e} (tol {BLOCK_SUMS_TOL:.0e})")
        check(sums.dtype == torch.float32, f"block_sums {dname(dtype)} returned {sums.dtype}")
        check(err <= BLOCK_SUMS_TOL, f"block_sums {dname(dtype)}: {err} > {BLOCK_SUMS_TOL}")
        entry = report[key("block_sums", dtype)]
        entry["max_abs_err"] = max(entry["max_abs_err"], err)

    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        rng = np.random.default_rng(22)
        for kernel, site, controls, n_case, M in ORACLE_CASES:
            C, a = oracle_modulus(M)
            A_list = tuple(pow(a, 1 << k, C) for k in range(len(controls)))
            err = oracle_err(site, random_planar(rng, n_case, dtype, DEVICE), C, A_list, controls, M)
            log(f"kernel {kernel} ({site}) controls {controls} {dname(dtype)} n={n_case} M={M}: max abs {err:.3e} (tol 0)")
            check(err == 0.0, f"{kernel} {site} {controls} {dname(dtype)}: {err} != 0")
            entry = report[key(kernel, dtype)]
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        check_forced_segments(report, dtype)


def phase_camodc_kernels(report: dict, n: int = KERNEL_N) -> None:
    """The camodc op (--oracle benes) at n = 20 on states of unit-variance
    components, float32, float64 and bf16: each segment against its plain
    Benes version (kernel_checks.plan_states; a segment of camodc ops alone
    also against the plain case-table gather, plain_permute), exactly where
    the segment only moves data, within TOL mixed with H gates.  A case of
    camodc ops alone must launch the camodc permutation
    (fused.PERMUTE_LAUNCHES), a mixed one the fused kernel's camodc op
    (fused.CAMODC_LAUNCHES counts both)."""
    import numpy as np
    import torch

    from quantumcomputer_tpu_torch.ops import fused
    from quantumcomputer_tpu_torch.utils.kernel_checks import plan_states, random_planar

    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        rng = np.random.default_rng(24)
        for name, gates, M, exact in camodc_cases(n):
            before, permute = fused.CAMODC_LAUNCHES, fused.PERMUTE_LAUNCHES
            pairs = plan_states(random_planar(rng, n, dtype, DEVICE, normalize=False), gates, M, fuse_oracle=True)[0]
            err, text = fused_err(report, key("camodc" if exact else "fused_segment", dtype), pairs)
            tol = 0.0 if exact else TOL[dname(dtype)]
            permuted = fused.PERMUTE_LAUNCHES - permute
            log(f"kernel camodc {name:20s} {dname(dtype)} n={n}: {text} (tol {tol:.0e}), "
                f"{fused.CAMODC_LAUNCHES - before} camodc segment(s), {permuted} through the permutation")
            check(fused.CAMODC_LAUNCHES > before, f"camodc {name} {dname(dtype)}: no segment with a camodc op launched")
            alone = all(g.name == "camodc" for g in gates)
            check(permuted > 0 if alone else permuted == 0,
                  f"camodc {name} {dname(dtype)}: {permuted} launches of the permutation (camodc ops alone: {alone})")
            check(err <= tol, f"camodc {name} {dname(dtype)}: {err} > {tol}")


def phase_kernel_checks() -> None:
    """The card-only kernel cases of the port's test suite
    (quantumcomputer_tpu_torch/utils/kernel_checks.py)."""
    from quantumcomputer_tpu_torch.utils import kernel_checks

    t0 = time.perf_counter()
    count = kernel_checks.run_all(DEVICE, log)
    log(f"kernel_checks: {count} cases ok in {time.perf_counter() - t0:.3f} s")


def check_forced_segments(report: dict, dtype) -> None:
    """The segmented walk with its segment count forced (uneven cuts
    included) and its vector width forced to one column and to 16 bytes, at
    n = 20, M = 13: the cycle walk at controls 0-6 and the pair at
    WALK_PAIRS (where the width fits the runs of moved columns), each
    exactly equal to its plain version."""
    import numpy as np

    from quantumcomputer_tpu_torch.ops import oracle
    from quantumcomputer_tpu_torch.utils.kernel_checks import random_planar

    C, a, n, M = 8191, 3, KERNEL_N, 13
    planar = random_planar(np.random.default_rng(23), n, dtype, DEVICE)
    chosen = oracle.walk_segment_count, oracle.walk_vector
    try:
        for S in WALK_SEGMENT_COUNTS:
            for vec in (1, oracle.WALK_VEC_BYTES // planar.element_size()):
                oracle.walk_segment_count = lambda *args, S=S: S
                oracle.walk_vector = lambda *args, vec=vec: vec
                errs = {}
                for controls in tuple((c,) for c in range(7)) + WALK_PAIRS:
                    if (1 << min(controls)) < vec:
                        continue
                    kernel, site = ("cycle", "cycle") if len(controls) == 1 else ("cycle_masked", "pair")
                    A_list = tuple(pow(a, 1 << c, C) for c in controls)
                    errs[controls] = oracle_err(site, planar, C, A_list, controls, M)
                    entry = report[key(kernel, dtype)]
                    entry["max_abs_err"] = max(entry["max_abs_err"], errs[controls])
                log(f"kernel cycle / cycle_masked S={S} vector {vec} {dname(dtype)} n={n} M={M}: controls {sorted(errs)}, "
                    f"max abs {max(errs.values()):.3e} (tol 0)")
                check(all(e == 0.0 for e in errs.values()), f"walk with S={S}, vector {vec} {dname(dtype)}: {errs}")
    finally:
        oracle.walk_segment_count, oracle.walk_vector = chosen


def phase_cli() -> None:
    import torch

    from quantumcomputer_tpu_torch import cli
    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit_mhigh
    from quantumcomputer_tpu_torch.ops import fused

    fused.LAUNCHES = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-C", "15", "-L", "3", "-M", "4", "-a", "7", "-v", "--seed", "0"])
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    check(rc == 0, f"cli.main returned {rc}")
    check(" --- Factors of 15 found: (5, 3)." in buf.getvalue(), "CLI did not factor 15 into (5, 3)")
    check(fused.LAUNCHES > 0, "the CLI run launched no fused-segment kernel")
    log(f"cli: factored 15 = 5 x 3, fused_segment launches {fused.LAUNCHES}")

    from quantumcomputer_tpu_torch.ops import oracle

    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-C", "15", "-L", "3", "-M", "4", "-a", "7", "--layout", "m_high", "-v", "--seed", "0"])
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    check(rc == 0, f"cli.main --layout m_high returned {rc}")
    check(" --- Factors of 15 found: (5, 3)." in buf.getvalue(), "the m_high CLI did not factor 15 into (5, 3)")
    if stage_merges(shor_circuit_mhigh(15, 7, 3, 4), 7, torch.float32):
        check(oracle.LAUNCHES["strip"] > 0 and oracle.LAUNCHES["cycle"] == 0,
              f"the m_high CLI run did not merge its walks into a strip pass: {launches()}")
    else:
        check(oracle.LAUNCHES["cycle"] > 0, "the m_high CLI run launched no cycle kernel")
    log(f"cli --layout m_high: factored 15 = 5 x 3, launches {launches()}")

    # The reference's largest register (L + M = 32) unsharded on the card,
    # and L + M = 33 refused with the reference's message.
    reset_launches()
    buf, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(N32_CLI)
    seconds = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    check(rc == 0, f"cli.main {' '.join(N32_CLI)} returned {rc}")
    check(any(f in buf.getvalue() for f in (" --- Factors of 8187 found: (3, 2729).", " --- Factors of 8187 found: (2729, 3).")),
          "the n = 32 m_high CLI did not factor 8187 into 3 x 2729")
    with contextlib.redirect_stderr(err):
        rc33 = cli.main([("20" if x == "19" else x) for x in N32_CLI])
    check(rc33 == 2 and "L + M > 32 qubits" in err.getvalue(), f"L + M = 33 gave {rc33}: {err.getvalue()!r}")
    log(f"cli n=32 m_high: factored 8187 = 3 x 2729 in {seconds:.2f} s, launches {launches()}; n=33 exits 2")

    import torch

    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    # --strict-reference runs the torch backend's plain ops, which launch no
    # kernel: its engine must still sit on the card, and the run allocate there.
    strict_device = StateVectorEngine(Register(L=3, M=4), strict_reference=True).device
    check(strict_device.type == "cuda", f"a strict_reference engine defaults to {strict_device}, not the card")
    for extra in (["--oracle", "benes"], ["--strict-reference"], ["--dtype", "dd64"]):
        reset_launches()
        allocations = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-C", "15", "-L", "3", "-M", "4", "-a", "7", "-v", "--seed", "0", *extra])
        allocations = torch.cuda.memory_stats()["allocation.all.allocated"] - allocations
        for line in buf.getvalue().splitlines():
            log(f"  | {line}")
        check(rc == 0, f"cli.main {extra} returned {rc}")
        check(" --- Factors of 15 found: (5, 3)." in buf.getvalue(), f"the CLI with {extra} did not factor 15 into (5, 3)")
        counts = launches()
        if extra[0] == "--oracle":
            check(counts["camodc"] > 0, "the --oracle benes CLI run launched no segment with a camodc op")
        elif extra[0] == "--dtype":
            check(counts["fused_segment"] > 0, "the --dtype dd64 CLI run launched no fused-segment kernel")
        check(allocations > 0, f"the CLI with {extra} allocated nothing on the card")
        log(f"cli {' '.join(extra)}: factored 15 = 5 x 3, launches {counts}, {allocations} allocations on the card"
            + (f" (strict_reference engine on {strict_device})" if extra[0] == "--strict-reference" else ""))


def reset_launches() -> None:
    from quantumcomputer_tpu_torch.ops import chunkgather, fused, measure, oracle, probes, sc_step, transpose

    fused.LAUNCHES = 0
    fused.CAMODC_LAUNCHES = 0
    fused.PERMUTE_LAUNCHES = 0
    fused.MATMUL_LAUNCHES = 0
    measure.LAUNCHES = 0
    transpose.LAUNCHES = 0
    transpose.OFFSET_LAUNCHES = 0
    for counts in (oracle.LAUNCHES, chunkgather.LAUNCHES, probes.LAUNCHES, sc_step.LAUNCHES):
        for k in counts:
            counts[k] = 0


def launches() -> dict:
    from quantumcomputer_tpu_torch.ops import chunkgather, fused, measure, oracle, probes, sc_step, transpose

    return {
        "fused_segment": fused.LAUNCHES, "camodc": fused.CAMODC_LAUNCHES, "permute": fused.PERMUTE_LAUNCHES,
        "matmul": fused.MATMUL_LAUNCHES,
        "block_sums": measure.LAUNCHES,
        **oracle.LAUNCHES,
        "offset_transpose": transpose.OFFSET_LAUNCHES,
        "transpose": transpose.LAUNCHES, "chunk_gather": sum(chunkgather.LAUNCHES.values()),
        **{f"probe_{k}": v for k, v in probes.LAUNCHES.items()},
        **{f"sc_{k}": v for k, v in sc_step.LAUNCHES.items()},
    }


def phase_flagship(report: dict) -> None:
    import torch

    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit
    from quantumcomputer_tpu_torch.ops import fused, measure
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    C, a, L, M = FLAGSHIP
    n = L + M
    circuit = shor_circuit(C, a, L, M)
    reg = Register(L=L, M=M)

    eng = StateVectorEngine(reg, torch.complex64, backend=KERNEL_BACKEND, device=DEVICE)
    cuda_ms = time_ms(lambda: eng.run(circuit), reps=1)
    state = eng.run(circuit)
    norm = eng.norm(state)
    log(f"flagship n={n} C={C} a={a} backend={KERNEL_BACKEND}: {cuda_ms:.3f} ms, norm {norm:.9f}")
    check(abs(norm - 1.0) <= FLAGSHIP_TOL, f"flagship norm {norm}")

    plain_eng = StateVectorEngine(reg, torch.complex64, backend="torch", device=DEVICE)
    plain_ms = time_ms(lambda: plain_eng.run(circuit), reps=1)
    plain_state = plain_eng.run(circuit)
    dist = float(torch.linalg.vector_norm(state - plain_state))
    log(f"flagship n={n} backend=torch: {plain_ms:.3f} ms; ||cuda - torch||_2 = {dist:.3e} (tol {FLAGSHIP_TOL:.0e})")
    check(dist <= FLAGSHIP_TOL, f"flagship cuda vs torch distance {dist}")

    entry = report["block_sums"]
    err = float((measure.block_sums(state) - measure.block_sums_plain(state)).abs().max())
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    check(err <= BLOCK_SUMS_TOL, f"block_sums on the flagship state: {err}")
    entry["ms"] = time_ms(lambda: measure.block_sums(state), reps=10)
    entry["plain_ms"] = time_ms(lambda: measure.block_sums_plain(state), reps=10)
    nblocks = measure.block_sums(state).numel()
    blocks = state.view(2, nblocks, -1)
    entry["library_ms"] = time_ms(lambda: torch.linalg.vector_norm(blocks, dim=(0, 2)), reps=10)
    entry["library"] = "torch.linalg.vector_norm over the (2, nblocks, block) view"
    set_bound(entry, state.numel() * state.element_size(), 3.0 * state.numel())
    log(
        f"kernel block_sums n={n}: max abs {err:.3e}; kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, "
        f"library {entry['library_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms"
    )
    del plain_state, blocks
    timed = phase_flagship_mhigh(report, state)
    phase_flagship_benes(report, state)
    del state

    gen = torch.Generator(device=DEVICE).manual_seed(28)
    planar = torch.randn((2, 1 << n), generator=gen, device=DEVICE, dtype=torch.float32)  # unit variance
    plan = fused.plan_circuit(circuit, n, M, fused.TILE_BITS[torch.float32])
    standard = time_segments(report, planar, [s for s in plan if s[0] == "fused"], M, "standard")
    del planar
    torch.cuda.empty_cache()
    entry = report["fused_segment"]
    first = standard[0]
    entry.update(ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"], bound_by=first["bound_by"])
    entry["segments"] = [s for s in standard + timed if "groups" not in s]  # the grouped ones: fused_matmul
    entry["segments_mean_ms"] = sum(s["ms"] for s in entry["segments"]) / len(entry["segments"])
    entry["segments_mean_plain_ms"] = sum(s["plain_ms"] for s in entry["segments"]) / len(entry["segments"])
    log(
        f"kernel fused_segment n={n}: standard segment 0 {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, "
        f"bound {entry['bound_ms']:.4f} ms; the {len(entry['segments'])} segments of both plans: mean kernel "
        f"{entry['segments_mean_ms']:.4f} ms ({entry['bound_ms'] / entry['segments_mean_ms']:.1%} of bound), "
        f"plain {entry['segments_mean_plain_ms']:.4f} ms"
    )


def changed_share(ops) -> float:
    """The share of the work blocks a segment of camodc ops alone changes
    (those whose controls are not all 0; the camodc permutation reads and
    writes no other): 1 - 2^-k for k distinct controls."""
    return 1.0 - 0.5 ** len({op[1] for op in ops})


def phase_flagship_benes(report: dict, gather_state) -> None:
    """The flagship with oracle="benes" (standard layout, complex64): its
    plan holds no single oracle gate and its run launches every camodc
    segment as the camodc permutation; norm, and the state against the
    gather engine's; both whole runs timed in turns; then every oracle
    segment timed (time_camodc_segments), and the first one again on
    float64 planes."""
    import torch

    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    C, a, L, M = FLAGSHIP
    n = L + M
    circuit = shor_circuit(C, a, L, M)
    reg = Register(L=L, M=M)
    gather = StateVectorEngine(reg, torch.complex64, backend=KERNEL_BACKEND, device=DEVICE)
    benes = StateVectorEngine(reg, torch.complex64, backend=KERNEL_BACKEND, device=DEVICE, oracle="benes")
    plan = benes._plan(circuit)
    check(not any(s[0] == "single" and s[1].name == "camodc" for s in plan), "the benes plan holds a single oracle gate")
    runs = {"gather": [], "benes": []}
    for name in ("gather", "benes", "benes", "gather"):
        eng = gather if name == "gather" else benes
        runs[name].append(time_ms(lambda: eng.run(circuit), reps=3))
    reset_launches()
    state = benes.run(circuit)
    counts = launches()
    check(counts["permute"] == counts["camodc"] > 0,
          f"the benes flagship's camodc segments did not all launch the camodc permutation: {counts}")
    norm = float(torch.sum(state * state))
    dist = float(torch.linalg.vector_norm(state - gather_state))
    del state
    entry = report["camodc"]
    entry["flagship_ms"], entry["flagship_gather_ms"] = runs["benes"], runs["gather"]
    log(
        f"flagship n={n} oracle=benes: {runs['benes']} ms against the gather's {runs['gather']} ms (turns gather, "
        f"benes, benes, gather); {len(plan)} plan entries; norm {norm:.9f}; ||benes - gather||_2 = {dist:.3e} "
        f"(tol {FLAGSHIP_TOL:.0e})"
    )
    check(abs(norm - 1.0) <= FLAGSHIP_TOL, f"benes flagship norm {norm}")
    check(dist <= FLAGSHIP_TOL, f"benes vs gather flagship distance {dist}")

    fill_camodc_entry(entry, time_camodc_segments(entry, unit_planar(n, torch.float32, 30), plan, M))
    first = next(s for s in plan if s[0] == "fused" and any(op[0] == "camodc" for op in s[1]))
    entry["f64_segments"] = time_camodc_segments(entry, unit_planar(n, torch.float64, 31), [first], M)


def unit_planar(n: int, dtype, seed: int):
    """A (2, 2^n) state of unit-variance components on the card, seeded."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randn((2, 1 << n), generator=gen, device=DEVICE, dtype=torch.float32).to(dtype)


def time_camodc_segments(entry: dict, planar, plan, M: int) -> list:
    """Every segment of a benes plan that holds a camodc op (each launches
    the camodc permutation), on `planar`: held exactly against its plain
    version (plain_permute) and timed beside it, its bound (the bytes of
    the work blocks it changes, read and written once) and its library call
    (torch.index_select of each op's control-1 half, summed); returns one
    row a segment, the largest error into `entry`."""
    import torch

    from quantumcomputer_tpu_torch.ops import fused
    from quantumcomputer_tpu_torch.ops import gates as tops

    state_bytes = planar.numel() * planar.element_size()
    rows = []
    for i, (kind, ops, axes) in enumerate(plan):
        if kind != "fused" or not any(op[0] == "camodc" for op in ops):
            continue
        want = fused.plain_permute(planar, ops, M)
        before = fused.PERMUTE_LAUNCHES
        err = exact_err(fused.apply_fused(planar.clone(), ops, axes, M), want)
        del want
        torch.cuda.synchronize()
        check(fused.PERMUTE_LAUNCHES == before + 1, f"benes flagship segment {i} did not launch the camodc permutation")
        check(err == 0.0, f"benes flagship segment {i} {dname(planar.dtype)}: {err} != 0")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        k_ms = time_ms(lambda: fused.apply_fused(planar, ops, axes, M), reps=10)
        p_ms = time_ms(lambda: fused.plain_permute(planar, ops, M), reps=2)
        share = changed_share(ops)
        b_ms, by = bound(2 * share * state_bytes)
        lib_ms = 0.0
        for op in (op for op in ops if op[0] == "camodc"):
            half = planar.view(2, -1, 2, 1 << (op[1] - M), 1 << M)[:, :, 1]
            ginv = torch.from_numpy(tops.modmul_inverse_permutation(op[2], op[3], M)).to(DEVICE)
            lib_ms += time_ms(lambda: torch.index_select(half, -1, ginv), reps=5)
            del half, ginv
        rows.append({
            "index": i, "controls": [op[1] for op in ops], "dtype": dname(planar.dtype), "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms, "changed_share": share,
        })
        log(
            f"kernel {entry['name']} flagship segment {i} {dname(planar.dtype)} (controls {[op[1] for op in ops]}, "
            f"changed share {share}): max abs {err:.3e}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), {b_ms / k_ms:.1%} of bound"
        )
    del planar
    torch.cuda.empty_cache()
    return rows


def fill_camodc_entry(entry: dict, rows: list) -> None:
    """A camodc entry's numbers: the first oracle segment's, and every one."""
    entry.update({k: rows[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    entry["segments"] = rows
    entry["segments_mean_ms"] = sum(r["ms"] for r in rows) / len(rows)
    entry["segments_sum_ms"] = sum(r["ms"] for r in rows)
    log(f"kernel {entry['name']}: {len(rows)} oracle segments, {entry['segments_sum_ms']:.4f} ms in all; pairs "
        f"{sum(r['bound_ms'] for r in rows if len(r['controls']) == 2) / sum(r['ms'] for r in rows if len(r['controls']) == 2):.1%} "
        f"of their bound, each below its index_select sum: {all(r['ms'] < r['library_ms'] for r in rows)}")


def matrix_bound(nbytes: float, gops, planes) -> tuple:
    """(bound_ms, bound_by) of a grouped segment: its bytes over the HBM
    rate, or its tensor-core operations: each real product (2 for a real
    table, 4 for a complex one, 2 K flops an output amplitude, K = 128 for a
    lanemat, 64 for a rowmat) as three TF32 products at 495 TFLOP/s for
    float32 planes, two bf16 products at 989 TFLOP/s for bf16."""
    import torch

    amps = nbytes / 4 / (2 if planes == torch.bfloat16 else 4)  # read + write of 2 planes
    flops = sum((2 if op[2] else 4) * 2 * (LANE_K if op[0] == "lanemat" else ROW_K) for op in gops if op[0] != "xtable")
    if planes == torch.bfloat16:
        by_ops = 2 * flops * amps / BF16_TC_FLOPS * 1e3
    else:
        by_ops = 3 * flops * amps / TF32_TC_FLOPS * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def library_matmul_ms(planar, gops, tables) -> float:
    """The library yardstick of a grouped segment: torch.matmul of the
    complex64 state's (2^(n-7), 128) view by each lanemat's table and of each
    rowmat's V by the (2^(n-13), 64, 128) view, out of place, summed over
    the segment's products (xtables not counted); the port never calls it."""
    import numpy as np
    import torch

    z = torch.complex(planar[0].float(), planar[1].float())
    total = 0.0
    for op in gops:
        if op[0] == "xtable":
            continue
        tab = torch.from_numpy(np.array(tables[op[1]])).to(DEVICE)
        w = torch.complex(tab[0], tab[1])
        if op[0] == "lanemat":
            total += time_ms(lambda: torch.matmul(z.view(-1, 128), w), reps=3)
        else:
            v = w.T.contiguous()
            total += time_ms(lambda: torch.matmul(v, z.view(-1, 64, 128)), reps=3)
    del z
    torch.cuda.empty_cache()
    return total


def time_segments(report: dict, planar, segments, M: int, layout: str, beside=None) -> list:
    """Each fused segment of a plan at the flagship size: held against its
    plain version, then kernel and plain version timed beside its bound;
    with `beside` (float32 planes of the same size), a segment that runs
    without matrix groups also timed through the float32 instance, the
    same ops and axes, as f32_ms.
    A segment that apply_fused runs with matrix groups is also run in its
    butterfly form (fused.apply_segment of its ops as planned), held against
    the ungrouped plain version and timed beside its own bound, and its
    library call timed (library_matmul_ms).  Returns one record per segment
    (layout, index, ops, ms, plain_ms, bound_ms, bound_by; a grouped one
    also groups, butterfly_ms, butterfly_bound_ms, library_ms)."""
    from collections import Counter

    from quantumcomputer_tpu_torch.ops import fused
    from quantumcomputer_tpu_torch.sim import statevec as sv

    tol = TOL[dname(planar.dtype)]
    n = sv.num_qubits(planar)
    nbytes = 2 * planar.numel() * planar.element_size()
    timed = []
    for i, (_, ops, axes) in enumerate(segments):
        gops, tables = fused.segment_ops(ops, M, planar.dtype, n)
        grouped = any(op[0] in fused.MATRIX_KINDS for op in gops)
        products = sum(op[0] in ("lanemat", "rowmat") for op in gops)
        entry = key("fused_matmul" if grouped else "fused_segment", planar.dtype)
        want = fused.plain_segment(planar, ops, M)
        err, text = fused_err(report, entry, [(fused.apply_fused(planar.clone(), ops, axes, M), want, products)])
        del want
        check(err <= tol, f"{layout} flagship segment {i} {dname(planar.dtype)}: {err} > {tol}")
        k_ms = time_ms(lambda: fused.apply_fused(planar, ops, axes, M), reps=10)
        p_ms = time_ms(lambda: fused.plain_segment(planar, ops, M), reps=3)
        b_ms, by = matrix_bound(nbytes, gops, planar.dtype) if grouped else bound(nbytes, segment_flops(ops, M, n))
        kinds = dict(Counter(op[0] for op in ops))
        rec = {"layout": layout, "index": i, "ops": kinds, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by}
        t, high = fused.tile_geometry(n, axes, fused.segment_tile_bits(gops, M, fused.TILE_BITS[planar.dtype], axes))
        f32 = ""
        if beside is not None and not grouped:
            rec["f32_ms"] = time_ms(lambda: fused.apply_fused(beside, ops, axes, M), reps=10)
            f32 = f"; float32 instance {rec['f32_ms']:.4f} ms ({dname(planar.dtype)} / float32 {k_ms / rec['f32_ms']:.3f})"
        log(
            f"kernel {entry} {layout} n={n} segment {i} ({kinds} as {[op[0] for op in gops] if grouped else 'butterflies'}, "
            f"targets {[op[1] for op in ops]}, t={t}, axes {high}): {text}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({by}), {b_ms / k_ms:.1%} of bound{f32}"
        )
        if grouped:
            want = fused.plain_ops(planar, ops, M)
            err, text = fused_err(report, key("fused_segment", planar.dtype),
                                  [(fused.apply_segment(planar.clone(), ops, axes, M), want, 0)])
            del want
            check(err <= tol, f"{layout} flagship segment {i} butterfly form {dname(planar.dtype)}: {err} > {tol}")
            bf_ms = time_ms(lambda: fused.apply_segment(planar, ops, axes, M), reps=10)
            bf_bound, bf_by = bound(nbytes, segment_flops(ops, M, n))
            lib_ms = library_matmul_ms(planar, gops, tables)
            rec.update(groups=[op[0] for op in gops], butterfly_ms=bf_ms, butterfly_bound_ms=bf_bound, library_ms=lib_ms)
            log(
                f"  segment {i} butterfly form: {text}; kernel {bf_ms:.4f} ms, bound {bf_bound:.4f} ms ({bf_by}), "
                f"{bf_bound / bf_ms:.1%} of bound; grouped / butterfly {k_ms / bf_ms:.3f}; library (torch.matmul) "
                f"{lib_ms:.4f} ms"
            )
        timed.append(rec)
    return timed


def fill_matmul_entry(report: dict, planes, records) -> None:
    """The fused_matmul entry of `planes` from time_segments' grouped
    records: the numbers of the one with the most matrix groups (the m_high
    iQFT segment), and the list of all of them."""
    grouped = [r for r in records if "groups" in r]
    check(bool(grouped), f"no segment of the flagship plans ran matrix groups at {dname(planes)}")
    first = max(grouped, key=lambda r: len(r["groups"]))
    entry = report[key("fused_matmul", planes)]
    entry.update({k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    entry["segments"] = grouped


def time_flagship_forms(reg, circuit, dtype) -> dict:
    """The m_high flagship through the cuda engine with its float32 / bf16
    segments grouped and in the butterfly form (fused.GROUP_DTYPES set for
    the run), in turns grouped, butterfly, butterfly, grouped; each form's
    final state, with MATMUL_LAUNCHES > 0 grouped and 0 in the butterfly
    form.  Returns {"grouped": [ms], "butterfly": [ms], "states": {...}}."""
    import torch

    from quantumcomputer_tpu_torch.ops import fused
    from quantumcomputer_tpu_torch.sim.engine import StateVectorEngine

    out = {"grouped": [], "butterfly": [], "states": {}}
    for form in ("grouped", "butterfly", "butterfly", "grouped"):
        with grouping((torch.float32, torch.bfloat16) if form == "grouped" else ()):
            eng = StateVectorEngine(reg, dtype, backend=KERNEL_BACKEND, device=DEVICE, layout="m_high")
            out[form].append(time_ms(lambda: eng.run(circuit), reps=3))
            if form not in out["states"]:
                reset_launches()
                out["states"][form] = eng.run(circuit)
                launched = fused.MATMUL_LAUNCHES
                check((launched > 0) == (form == "grouped"), f"the {form} m_high flagship made {launched} matrix launches")
    return out


def phase_flagship_mhigh(report: dict, standard_state) -> list:
    """The m_high flagship and its kernels; returns time_segments' rows of
    the m_high plan."""
    import torch

    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit_mhigh
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine, plan_circuit
    from quantumcomputer_tpu_torch.utils.kernel_checks import segment_products

    C, a, L, M = FLAGSHIP
    n = L + M
    circuit = shor_circuit_mhigh(C, a, L, M)
    reg = Register(L=L, M=M)

    eng = StateVectorEngine(reg, torch.complex64, backend=KERNEL_BACKEND, device=DEVICE, layout="m_high")
    cuda_ms = time_ms(lambda: eng.run(circuit), reps=1)
    reset_launches()
    state = eng.run(circuit)
    norm = eng.norm(state)
    counts = launches()
    log(f"flagship m_high n={n} backend={KERNEL_BACKEND}: {cuda_ms:.3f} ms, norm {norm:.9f}, launches {counts}")
    check(abs(norm - 1.0) <= FLAGSHIP_TOL, f"m_high flagship norm {norm}")
    check(stage_merges(circuit, n, torch.float32), "the m_high flagship plan's oracle stage does not merge")
    check(counts["strip"] == 1 and counts["ladder"] == counts["cycle"] == 0,
          f"the m_high flagship's oracle stage did not run as one strip pass: {counts}")
    walked, _ = eng.run_with_norms(circuit)  # with norms every plan entry runs alone: walks and the ladder
    same = torch.equal(walked, state)
    del walked
    log(f"flagship m_high complex64: equal bit for bit to its plan applied entry by entry: {same}")
    check(same, "the m_high flagship state differs from its plan applied entry by entry")
    forms = time_flagship_forms(reg, circuit, torch.complex64)
    dist = float(torch.linalg.vector_norm(forms["states"]["grouped"] - forms["states"]["butterfly"]))
    del forms["states"]
    report["fused_matmul"].update(flagship_ms=forms["grouped"], flagship_butterfly_ms=forms["butterfly"])
    log(f"flagship m_high n={n} complex64: segments grouped {forms['grouped']} ms, butterfly form {forms['butterfly']} ms "
        f"(turns grouped, butterfly, butterfly, grouped); ||grouped - butterfly||_2 = {dist:.3e} (tol {FLAGSHIP_TOL:.0e})")
    check(dist <= FLAGSHIP_TOL, f"m_high flagship grouped vs butterfly distance {dist}")

    plain_eng = StateVectorEngine(reg, torch.complex64, backend="torch", device=DEVICE, layout="m_high")
    plain_ms = time_ms(lambda: plain_eng.run(circuit), reps=1)
    dist = float(torch.linalg.vector_norm(state - plain_eng.run(circuit)))
    log(f"flagship m_high n={n} backend=torch: {plain_ms:.3f} ms; ||cuda - torch||_2 = {dist:.3e} (tol {FLAGSHIP_TOL:.0e})")
    check(dist <= FLAGSHIP_TOL, f"m_high flagship cuda vs torch distance {dist}")

    # Physical (2, 2^M, 2^L) transposed on its last two axes is logical (2, 2^L, 2^M).
    logical = state.view(2, 1 << M, 1 << L).transpose(1, 2).reshape(2, -1)
    dist = float(torch.linalg.vector_norm(logical - standard_state))
    del logical
    log(f"flagship m_high vs standard layout (physical -> logical): ||d||_2 = {dist:.3e} (tol {FLAGSHIP_TOL:.0e})")
    check(dist <= FLAGSHIP_TOL, f"m_high vs standard flagship distance {dist}")

    # The memory ceiling: a budget that holds one state and not two.
    state_bytes = state.numel() * state.element_size()
    os.environ["QC_TPU_HBM_BYTES"] = str(state_bytes * 3 // 2)
    try:
        ceiling = StateVectorEngine(reg, torch.complex64, backend=KERNEL_BACKEND, device=DEVICE, layout="m_high")
        ceiling_ms = time_ms(lambda: ceiling.run(circuit), reps=1)
        reset_launches()
        low = ceiling.run(circuit)
        counts = launches()
    finally:
        del os.environ["QC_TPU_HBM_BYTES"]
    dist = float(torch.linalg.vector_norm(low - state))
    del low
    log(
        f"flagship m_high below two states: {ceiling_ms:.3f} ms, launches {counts}; "
        f"||d||_2 = {dist:.3e} (tol {FLAGSHIP_TOL:.0e})"
    )
    check(counts["cycle_masked"] > 0, "the memory-ceiling run launched no cycle_masked kernel")
    check(counts["ladder"] == 0, "the memory-ceiling run launched the out-of-place ladder")
    check(dist <= FLAGSHIP_TOL, f"memory-ceiling flagship distance {dist}")
    report["cycle_masked"]["launches"] = counts["cycle_masked"]
    del state
    torch.cuda.empty_cache()

    # Each fused segment of the m_high plan (low physical bits, M = 0), then
    # each oracle kernel at n = 28 on the call sites of the flagship's plans.
    # The float32 main path keeps the butterfly form (fused.GROUP_DTYPES); the
    # matrix instance is timed on the segments of the grouping planner's plan
    # that group.
    planar = unit_planar(n, torch.float32, 29)
    plan = plan_circuit(circuit, 0, n, torch.float32, DEVICE)
    timed = time_segments(report, planar, [s for s in plan if s[0] == "fused"], 0, "m_high")
    with grouping((torch.float32, torch.bfloat16)):
        plan = plan_circuit(circuit, 0, n, torch.float32, DEVICE)
        grouped = [s for s in plan if s[0] == "fused" and segment_products(s[1], 0, torch.float32, n)]
        fill_matmul_entry(report, torch.float32, time_segments(report, planar, grouped, 0, "m_high grouped"))
    time_mhigh_oracles(report, planar, C, a, M, tuple(range(11, 15)), WALK_CONTROLS)
    # The strip pass's float32 instance on the complex64 plan's oracle stage.
    r = time_strip_run(planar, C, a, M, (*WALK_CONTROLS, tuple(range(11, 15))))
    report["oracle_strip"].update(
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by="bytes", library_ms=r["library_ms"],
        library=r["library"], strip_bytes=r["strip_bytes"], entries_sum_ms=r["entries_sum_ms"], entry_ms=r["entry_ms"],
    )
    return timed


def time_mhigh_oracles(report: dict, planar, C: int, a: int, M: int, ladder, walks) -> None:
    """The m_high oracle kernels at the flagship size on `planar`: the
    ladder at controls `ladder`, the cycle walk at each of `walks` and the
    pair (13, 14), each held exactly against its plain version and timed
    beside it, its bound and its library call; the report entry of the
    planes' dtype takes the ladder, the walk at control 3 and the pair."""
    import torch

    from quantumcomputer_tpu_torch.ops import gates as tops

    state_bytes = planar.numel() * planar.element_size()
    n = planar.shape[1].bit_length() - 1
    for kernel, site, controls in (
        ("ladder", "ladder", tuple(ladder)),
        *(("cycle", "cycle", (c,)) for c in walks),
        ("cycle_masked", "pair", (13, 14)),
    ):
        A_list = tuple(pow(a, 1 << c, C) for c in controls)
        err = oracle_err(site, planar, C, A_list, controls, M)
        check(err == 0.0, f"{kernel} controls {controls} at n={n}: {err} != 0")
        work = planar.clone()
        k_ms = time_ms(lambda: run_oracle(site, work, C, A_list, controls, M, plain=False), reps=10)
        p_ms = time_ms(lambda: run_oracle(site, work, C, A_list, controls, M, plain=True), reps=3)
        del work
        moved = {"ladder": 1.0, "cycle": 0.5, "cycle_masked": 0.75}[kernel]  # share of the state read and written
        b_ms, by = bound(2 * moved * state_bytes)
        if kernel == "cycle":
            # The control-1 half, gathered along the rows (out of place).
            half = planar.view(2, 1 << M, -1, 2, 1 << controls[0])[:, :, :, 1, :]
            ginv = torch.from_numpy(tops.modmul_inverse_permutation(C, A_list[0], M)).to(DEVICE)
            lib_ms = time_ms(lambda: torch.index_select(half, 1, ginv), reps=5)
            library = "torch.index_select of the control-1 half along the rows"
            del half, ginv
        else:
            lib_ms, library = time_library_row_gather(planar, C, A_list, controls, M)
        entry = report[key(kernel, planar.dtype)]
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if kernel != "cycle" or controls == (3,):
            entry.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by, library_ms=lib_ms, library=library)
        log(
            f"kernel {entry['name']} ({site}) controls {controls} n={n}: max abs {err:.3e}; kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), {b_ms / k_ms:.1%} of bound"
        )
    torch.cuda.empty_cache()


def time_strip_run(planar, C: int, a: int, M: int, entries) -> dict:
    """The strip pass (oracle_strip.cu) on a run of an m_high plan's
    adjacent entries (a control is a walk, a tuple a ladder), on `planar`
    (scripts/prof_strip.strip_case: held exactly against the plain version
    and timed beside the same entries one by one, the plain version, the
    library call where the run's controls are contiguous, and the bound).  Returns
    strip_case's numbers."""
    from quantumcomputer_tpu_torch.scripts import prof_strip

    r = prof_strip.strip_case(planar, C, a, M, entries)
    library = f"; library {r['library_ms']:.4f} ms" if "library_ms" in r else ""
    log(
        f"kernel oracle_strip {dname(planar.dtype)} run of entries {r['entries']} n={r['n']} C={C} M={M}: exact; "
        f"{r['strip_bytes']}-byte strips {r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms (bytes), {r['share']:.1%} of "
        f"bound; plain {r['plain_ms']:.4f} ms{library}; the {len(r['entries'])} entries one by one "
        f"{r['entries_sum_ms']:.4f} ms ({', '.join(f'{w:.4f}' for w in r['entry_ms'])})"
    )
    return r


def stage_merges(circuit, n: int, real_dtype) -> bool:
    """True when the engine's m_high plan of `circuit` on this card runs
    its first oracle run as one strip pass (engine.strip_run and
    oracle.strip_pays on a probe of the state's shape)."""
    import torch

    from quantumcomputer_tpu_torch.ops import oracle
    from quantumcomputer_tpu_torch.sim.engine import plan_circuit, strip_run

    plan = plan_circuit(circuit, 0, n, real_dtype, DEVICE)
    probe = torch.empty((2, 1 << n), dtype=real_dtype, device="meta")
    run = strip_run(probe, plan, next(i for i, e in enumerate(plan) if e[0] == "single"))
    return bool(run) and oracle.strip_pays([g.qubits for g in run], run[0].meta[0], probe.element_size(),
                                           oracle.strip_room(torch.device(DEVICE)), n)


def phase_factor(report: dict, planes) -> None:
    """Factor 8187 at n = 30 end to end in the standard layout, m_high and
    with oracle="benes", on planes of `planes` (float32: complex64; bfloat16:
    complex32); the launch
    counters reset just before each run and read just after, into the
    report entries of that dtype's kernel instances."""
    import torch

    from quantumcomputer_tpu_torch.algorithms.shor import shors_algorithm
    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit_mhigh
    from quantumcomputer_tpu_torch.ops import fused, measure

    C, a, L, M = FACTOR
    dtype = engine_dtype(planes)
    fused.LAUNCHES = 0
    fused.PERMUTE_LAUNCHES = 0
    measure.LAUNCHES = 0
    t0 = time.perf_counter()
    result = shors_algorithm(
        C, L, M, forced_trial_int=a, seed=0, dtype=dtype,
        backend=KERNEL_BACKEND, max_attempts_per_a=4,
    )
    wall = time.perf_counter() - t0
    report[key("fused_segment", planes)]["launches"] = fused.LAUNCHES
    report[key("block_sums", planes)]["launches"] = measure.LAUNCHES
    log(
        f"factor n={L + M} C={C} a={a} {dname(planes)} planes: {result.outcome.value}, factors {result.factors}, "
        f"period {result.period}, {len(result.attempts)} attempt(s), {wall:.3f} s; "
        f"launches fused_segment {fused.LAUNCHES} (of them the oracles' camodc permutation "
        f"{fused.PERMUTE_LAUNCHES}), block_sums {measure.LAUNCHES}"
    )
    check(result.factors == (2729, 3), f"factors {result.factors} != (2729, 3)")
    check(fused.LAUNCHES > 0, "the main path launched no fused-segment kernel")
    check(measure.LAUNCHES > 0, "the main path launched no block-sums kernel")
    check(fused.PERMUTE_LAUNCHES == L * len(result.attempts),
          f"the main path's oracles: {fused.PERMUTE_LAUNCHES} camodc permutation launches for "
          f"{len(result.attempts)} attempt(s) of {L} oracles")

    reset_launches()
    t0 = time.perf_counter()
    result = shors_algorithm(
        C, L, M, forced_trial_int=a, seed=0, dtype=dtype,
        backend=KERNEL_BACKEND, max_attempts_per_a=4, layout="m_high",
    )
    wall = time.perf_counter() - t0
    counts = launches()
    # Where the plan's oracle stage merges into one strip pass, the walks' and
    # the ladder's launches come from the per-entry runs (run_with_norms).
    merged = stage_merges(shor_circuit_mhigh(C, a, L, M), L + M, planes)
    oracles = ("strip",) if merged else ("ladder", "cycle")
    for k in oracles:
        report[key("oracle_strip" if k == "strip" else k, planes)]["launches"] = counts[k]
    if planes in fused.GROUP_DTYPES:
        report[key("fused_matmul", planes)]["launches"] = counts["matmul"]
        check(counts["matmul"] > 0, f"the m_high main path at {dname(planes)} launched no matrix group")
    log(
        f"factor m_high n={L + M} C={C} a={a} {dname(planes)} planes: {result.outcome.value}, factors {result.factors}, "
        f"period {result.period}, {len(result.attempts)} attempt(s), {wall:.3f} s; launches {counts}"
    )
    check(result.factors == (2729, 3), f"m_high factors {result.factors} != (2729, 3)")
    for k in ("fused_segment", "block_sums", *oracles):
        check(counts[k] > 0, f"the m_high main path launched no {k} kernel")
    if merged:
        check(counts["ladder"] == counts["cycle"] == 0, f"the m_high main path's merged stage walked: {counts}")

    # The standard layout with oracle="benes": every oracle inside a fused
    # segment; the torch gather oracle is counted and must not run.
    from quantumcomputer_tpu_torch.ops import gates as tops

    gather_oracle = tops.apply_c_amodc_planes_
    gathers = []

    def counted(*args, **kwargs):
        gathers.append(args[2:])
        return gather_oracle(*args, **kwargs)

    tops.apply_c_amodc_planes_ = counted
    try:
        reset_launches()
        t0 = time.perf_counter()
        result = shors_algorithm(
            C, L, M, forced_trial_int=a, seed=0, dtype=dtype,
            backend=KERNEL_BACKEND, max_attempts_per_a=4, oracle="benes",
        )
        wall = time.perf_counter() - t0
        counts = launches()
    finally:
        tops.apply_c_amodc_planes_ = gather_oracle
    report[key("camodc", planes)]["launches"] = counts["permute"]
    log(
        f"factor oracle=benes n={L + M} C={C} a={a} {dname(planes)} planes: {result.outcome.value}, factors {result.factors}, "
        f"period {result.period}, {len(result.attempts)} attempt(s), {wall:.3f} s; launches {counts}, "
        f"gather oracle calls {len(gathers)}"
    )
    check(result.factors == (2729, 3), f"benes factors {result.factors} != (2729, 3)")
    for k in ("fused_segment", "permute", "block_sums"):
        check(counts[k] > 0, f"the benes main path launched no {k} kernel")
    check(counts["permute"] == counts["camodc"], f"a camodc segment of the benes main path missed the permutation: {counts}")
    check(not gathers, f"the benes main path ran {len(gathers)} gather oracles")


def exact_err(got, want) -> float:
    """Max abs difference of two tensors that must be equal (inf on a
    shape mismatch)."""
    from quantumcomputer_tpu_torch.scripts import exact_err as err

    return err(got, want)


def planned_multipliers(C: int, M: int, count: int, seed: int) -> list:
    """The first `count` random multipliers of C that plan."""
    import numpy as np

    from quantumcomputer_tpu_torch.ops import modperm

    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        a = int(rng.integers(2, C - 1))
        if modperm.plan_stride_permute(C, a, M) is not None:
            out.append(a)
    return out


def element_map_err(x, C: int, a_inv: int, M: int) -> float:
    """apply_stride_permute against the element map x[:, (a_inv*j) mod C]."""
    import torch

    from quantumcomputer_tpu_torch.ops import modperm

    j = torch.arange(1 << M, device=x.device)
    want = x[:, torch.where(j < C, (j * a_inv) % C, j)]
    del j
    err = exact_err(modperm.modmul_stride_permute(x, C, a_inv, M), want)
    torch.cuda.synchronize()
    return err


# (M, C, R, B) of the offset transpose's shape cases: R = 1 (the reversal),
# R = C - 1, an identity tail past C, a column run's wrap inside a tile, and
# two planes.
OFFSET_SHAPES = ((12, 4093, 1, 2), (12, 4093, 4092, 1), (14, 9001, 97, 2), (20, 700001, 1009, 1), (22, (1 << 22) - 3, 2039, 2))


def phase_modperm_kernels(report: dict) -> None:
    import torch

    from quantumcomputer_tpu_torch.ops import chunkgather as cg
    from quantumcomputer_tpu_torch.ops import transpose as tr

    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        g = torch.Generator().manual_seed(30)

        def rand(*shape):
            wide = torch.float32 if dtype == torch.bfloat16 else dtype
            return torch.randn(shape, generator=g, dtype=wide).to(device=DEVICE, dtype=dtype)

        for M, C, R, B in OFFSET_SHAPES:
            x = rand(B, 1 << M)
            for leg in (tr.COLLECT, tr.DEAL):
                for sign in (1, -1):
                    got = tr.offset_transpose(x, C, R, pow(R, -1, C), sign, leg)
                    err = exact_err(got, tr.offset_transpose_plain(x, C, R, pow(R, -1, C), sign, leg))
                    torch.cuda.synchronize()
                    check(err == 0.0, f"offset transpose {dname(dtype)} M={M} C={C} R={R} leg {leg} sign {sign}: {err} != 0")
            log(f"kernel offset_transpose {dname(dtype)} M={M} C={C} R={R} B={B}, both legs and signs: exact")

        for shape, extra in (((2, 512, 384), 0), ((1, 300, 523), 0), ((2, 256, 1000), 1), ((1, 4133, 2176), 1)):
            x = rand(*shape)
            got, want = tr.tiled_transpose_padded(x, extra), tr.transpose_plain(x, extra)
            rows = want.shape[1] - extra  # the extra rows are unwritten in both
            err = exact_err(got[:, :rows], want[:, :rows])
            torch.cuda.synchronize()
            log(f"kernel transpose {dname(dtype)} {shape} extra_rows={extra} -> {tuple(got.shape)}: max abs {err:.3e} (tol 0)")
            check(err == 0.0, f"transpose {dname(dtype)} {shape}: {err} != 0")

        P, W, NC = 1 << 20, 4096, 600
        x, x2 = rand(2, P), rand(2, 2 * W)
        ri = torch.randint
        s_in = ri(0, P - W + 1, (NC,), generator=g).to(DEVICE)
        s_out = torch.cat([ri(-2 * W, 0, (NC // 2,), generator=g), ri(P - W + 1, P + 2 * W, (NC - NC // 2,), generator=g)]).to(DEVICE)
        s1 = ri(0, P - W + 1, (NC,), generator=g).to(DEVICE)
        istar = ri(0, W + 1, (NC,), generator=g).to(DEVICE)
        flags = ri(0, 2, (NC,), generator=g).to(DEVICE)
        s_src2 = torch.where(flags != 0, ri(0, W + 1, (NC,), generator=g).to(DEVICE), s_in)
        v, vpad, rows = 1543, 1664, 300
        xr = rand(2, (rows + 1) * vpad)
        cases = [
            ("gather, in range", cg.chunk_gather(x, s_in, W), cg.chunk_gather_plain(x, s_in, W)),
            ("gather, out of range (deal-leg rows)", cg.chunk_gather(x, s_out, W), cg.chunk_gather_plain(x, s_out, W)),
            ("src2", cg.chunk_gather_src2(x, x2, s_src2, flags, W), cg.chunk_gather_src2_plain(x, x2, s_src2, flags, W)),
            ("blend", cg.chunk_gather_blend(x, s_in, s1, istar, W), cg.chunk_gather_blend_plain(x, s_in, s1, istar, W)),
            ("blend, out of range", cg.chunk_gather_blend(x, s_out, s1, istar, W), cg.chunk_gather_blend_plain(x, s_out, s1, istar, W)),
            # 1536-wide chunks over 300 live rows of v = 1543, and 40 chunks past them.
            ("rowlaw past the rows", cg.chunk_gather_blend_rowlaw(xr, 341, v, vpad, 1536),
             cg.chunk_gather_blend_rowlaw_plain(xr, 341, v, vpad, 1536)),
        ]
        for name, got, want in cases:
            err = exact_err(got, want)
            torch.cuda.synchronize()
            log(f"kernel chunk_gather {name} {dname(dtype)}: max abs {err:.3e} (tol 0)")
            check(err == 0.0, f"chunk_gather {name} {dname(dtype)}: {err} != 0")
        del x, x2, xr, cases

    # Random planned multipliers, and at the M of the timing phase the steps
    # of its ladder whose collect rows split (v = 1543 at M = 28).
    from quantumcomputer_tpu_torch.ops import modperm

    C_sc, a, L, M_sc = SC_M28
    ladder = [pow(pow(a, 1 << (L - 1 - s), C_sc), -1, C_sc) for s in range(L)]
    plans = [modperm.plan_stride_permute(C_sc, ai, M_sc) for ai in ladder]
    split = [ai for ai, p in zip(ladder, plans) if p and p.v > 1 and modperm.collect_chunking(C_sc, p.v)[2] > 1]
    for M in PERMUTE_MS:
        C = (1 << M) - 3
        mults = planned_multipliers(C, M, 3, M) + (split if M == M_sc else [])
        x = torch.randn((1, 1 << M), generator=torch.Generator().manual_seed(M)).to(DEVICE)
        for a_inv in mults:
            err = element_map_err(x, C, a_inv, M)
            log(f"apply_stride_permute M={M} C={C} a_inv={a_inv}: max abs vs element map {err:.3e} (tol 0)")
            check(err == 0.0, f"apply_stride_permute M={M} a_inv={a_inv}: {err} != 0")
        del x
    torch.cuda.empty_cache()


def phase_semiclassical_timing(report: dict, planes) -> None:
    """At M = 28 (C = 2^28 - 3, a = 7), on planes of `planes` (float32 or
    bfloat16): each offset-transpose launch of the first planned step's
    permutation timed beside its plain version and its bound; the whole
    permutation of a plane beside one index_select by the same permutation
    (the library yardstick); and one step per oracle path."""
    import torch

    from quantumcomputer_tpu_torch.algorithms import semiclassical as sc
    from quantumcomputer_tpu_torch.ops import modperm
    from quantumcomputer_tpu_torch.ops import transpose as tr

    C, a, L, M = SC_M28
    a_invs = [pow(pow(a, 1 << (L - 1 - s), C), -1, C) for s in range(L)]
    plans = sc._structured_plans(C, a_invs, M)
    step = next(s for s, p in enumerate(plans) if p is not None)
    plan = plans[step]
    x = torch.randn((1, 1 << M), generator=torch.Generator().manual_seed(31)).to(device=DEVICE, dtype=planes)

    # Each leg of one plane's permutation, as apply_stride_permute launches it.
    entry = report[key("offset_transpose", planes)]
    entry.update(ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by="bytes")
    y = x
    for R, m, leg, sign in modperm.legs(plan):
        args = (y, C, R, m, sign, leg)
        got, want = tr.offset_transpose(*args), tr.offset_transpose_plain(*args)
        err = exact_err(got, want)
        del want
        check(err == 0.0, f"offset transpose leg {leg} at M={M}: {err} != 0")
        k_ms = time_ms(lambda: tr.offset_transpose(*args), reps=10)
        p_ms = time_ms(lambda: tr.offset_transpose_plain(*args), reps=3)
        b_ms = bound(2 * y.numel() * y.element_size())[0]  # the plane read once and written once
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        for field, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b_ms)):
            entry[field] += v
        log(
            f"kernel offset_transpose {dname(planes)} M={M} step {step} {'collect' if leg == tr.COLLECT else 'deal'} "
            f"R={R} sign {sign}: exact; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms, "
            f"{b_ms / k_ms:.1%} of bound"
        )
        y = got
    del y, got, args
    torch.cuda.empty_cache()

    # The whole permutation beside the library yardstick: one index_select
    # of the plane by the same permutation.
    j = torch.arange(1 << M, device=DEVICE)
    src = torch.where(j < C, (j * a_invs[step]) % C, j)
    del j
    err = exact_err(modperm.apply_stride_permute(x, plan), x.index_select(1, src))
    check(err == 0.0, f"apply_stride_permute at M={M} differs from index_select: {err}")
    perm_ms = time_ms(lambda: modperm.apply_stride_permute(x, plan), reps=5)
    entry["library_ms"] = time_ms(lambda: x.index_select(1, src), reps=5)
    log(f"apply_stride_permute {dname(planes)} M={M} plan {plan}: {perm_ms:.4f} ms per plane "
        f"({len(modperm.legs(plan))} launches); index_select by the whole permutation {entry['library_ms']:.4f} ms")
    del src, x
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(32)
    w = torch.randn((2, 1 << M), generator=gen).to(DEVICE)
    w = (w / torch.linalg.vector_norm(w)).to(planes)
    phi, r = torch.tensor(0.375, device=DEVICE), torch.tensor(0.4, device=DEVICE)
    outs = {}
    scratch = w.clone()  # a float32 structured step writes its state over its input
    for path, p in (("structured", plan), ("gather", None)):
        ms = time_ms(lambda: sc._step(scratch, phi, M, planes, C, a_invs[step], p, r, -1), reps=3)
        bit, p_cond, out, _ = sc._step(w.clone(), phi, M, planes, C, a_invs[step], p, r, -1)
        outs[path] = (int(bit), float(p_cond), out)
        log(f"semiclassical step {dname(planes)} M={M} ({path}): {ms:.4f} ms, bit {int(bit)}, p_cond {float(p_cond):.9f}")
    dist = float(torch.linalg.vector_norm(outs["structured"][2].float() - outs["gather"][2].float()))
    log(f"semiclassical step {dname(planes)} M={M}: structured vs gather ||d||_2 = {dist:.3e} (tol {FLAGSHIP_TOL:.0e})")
    check(outs["structured"][0] == outs["gather"][0], "structured and gather steps measured different bits")
    check(dist <= FLAGSHIP_TOL, f"structured vs gather step distance {dist}")
    del w, scratch, outs
    torch.cuda.empty_cache()


def phase_semiclassical_cli() -> None:
    from quantumcomputer_tpu_torch import cli

    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(SC_CLI)
    wall = time.perf_counter() - t0
    counts = launches()
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    out = buf.getvalue()
    check(rc in (0, 3), f"semiclassical CLI returned {rc}")
    check(" --- Factors of 268435453 found: " in out or "could not be factorised" in out,
          "the semiclassical CLI printed neither a factor line nor the could-not line")
    check(counts["offset_transpose"] > 0 and counts["transpose"] == counts["chunk_gather"] == 0,
          f"the M=28 CLI run launched {counts}")
    log(f"cli --semiclassical M=28: exit {rc}, {wall:.3f} s, launches {counts}")


def phase_semiclassical_factor(report: dict, planes, reference=None):
    """Factor 1,060,314,373 at M = 30 on planes of `planes` (float32: an
    8 GiB complex64 work state; bfloat16: 4 GiB complex32) with the bits equal to the exact prediction on
    the same draws; the launch counters reset just before and read just
    after.  With `reference` (an earlier attempt's record on the same
    draws) the branch probabilities' largest deviation from it is printed
    beside the draws' margin.  Returns the attempt's record."""
    import importlib.util

    import torch

    from quantumcomputer_tpu_torch.algorithms import semiclassical as sc
    from quantumcomputer_tpu_torch.algorithms.shor import shors_algorithm
    from quantumcomputer_tpu_torch.ops import modperm

    C, a, L, M = SC_FACTOR
    spec = importlib.util.spec_from_file_location(
        "predict_semiclassical", os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "predict_semiclassical.py")
    )
    predictor = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(predictor)
    # The draws shors_algorithm hands the first attempt: L uniforms in float32
    # from a CPU generator seeded with the seed.
    rs = torch.rand((L,), generator=torch.Generator().manual_seed(SC_SEED), dtype=torch.float32)
    want_bits, margin = predictor.predict_bits(C, a, L, rs.double().numpy())
    log(f"semiclassical M={M}: predicted bits for seed {SC_SEED}, min draw margin {margin:.6f}")

    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    result = shors_algorithm(
        C, L, M, forced_trial_int=a, seed=SC_SEED, dtype=engine_dtype(planes),
        backend=KERNEL_BACKEND, semiclassical=True,
    )
    wall = time.perf_counter() - t0
    counts = launches()
    for kernel in ("offset_transpose", "transpose", "chunk_gather"):
        report[key(kernel, planes)]["launches"] = counts[kernel]
    attempt = result.attempts[0]
    rec = attempt.semiclassical
    n_struct, n_gather = rec.oracles.count("structured"), rec.oracles.count("gather")
    log(
        f"semiclassical factor {dname(planes)} M={M} C={C} a={a} L={L}: {result.outcome.value}, factors {result.factors}, "
        f"period {result.period}; attempt {attempt.elapsed_s:.3f} s ({attempt.elapsed_s / L * 1e3:.3f} ms per step), "
        f"total {wall:.3f} s; steps structured {n_struct}, gather {n_gather}; launches {counts}"
    )
    check(rec.bits == want_bits, f"bits {rec.bits} != predicted {want_bits}")
    check(result.factors == SC_FACTORS, f"factors {result.factors} != {SC_FACTORS}")
    check(n_struct > 0, "no step took the structured oracle")
    # One offset-transpose launch a leg of each plane of a structured step; the old legs never.
    a_invs = [pow(pow(a, 1 << (L - 1 - s), C), -1, C) for s in range(L)]
    legs = sum(2 * len(modperm.legs(p)) for p in sc._structured_plans(C, a_invs, M) if p is not None)
    check(counts["offset_transpose"] == legs, f"{counts['offset_transpose']} offset-transpose launches, {legs} legs")
    check(counts["transpose"] == counts["chunk_gather"] == 0, f"the old legs launched on the main path: {counts}")
    # float32 planes: the step's two kernels once a structured step; bf16 keeps the PyTorch composition.
    fused_steps = n_struct if planes == torch.float32 else 0
    check(counts["sc_branch_sums"] == counts["sc_collapse"] == fused_steps,
          f"sc_step launches {counts['sc_branch_sums']} / {counts['sc_collapse']}, expected {fused_steps} each")
    if reference is not None:
        dev = max(abs(p - q) for p, q in zip(rec.branch_probs, reference.branch_probs))
        log(f"semiclassical {dname(planes)} M={M}: largest branch-probability deviation from the complex64 attempt {dev:.3e}, "
            f"against the draws' min margin {margin:.6f}")
        check(dev < margin, f"branch deviation {dev} reaches the draw margin {margin}")
    return rec


def phase_gather_oracle(report: dict) -> None:
    """The row-gather oracle at n = 28, M = 13: each control and dtype
    through apply_camodc_high_planar (the launches counted are those calls),
    then held against the plain version and timed beside it and beside the
    cycle walk on the same gate."""
    import torch

    from quantumcomputer_tpu_torch.ops import gates as tops
    from quantumcomputer_tpu_torch.ops import oracle

    C, a, L, M = FLAGSHIP
    n = L + M
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        entry = report[key("oracle_gather", dtype)]
        gen = torch.Generator(device=DEVICE).manual_seed(40)
        x = torch.randn((2, 1 << n), generator=gen, device=DEVICE, dtype=torch.float32).to(dtype)
        out = torch.empty_like(x)
        for c in GATHER_CONTROLS:
            before = oracle.LAUNCHES["gather"]
            got = oracle.apply_camodc_high_planar(x, out, C, a, c, M)
            entry["launches"] += oracle.LAUNCHES["gather"] - before
            want = tops.apply_camodc_high_planes_(x.clone(), C, a, c, M)
            err = exact_err(got, want)
            del want
            torch.cuda.synchronize()
            check(err == 0.0, f"oracle_gather {dname(dtype)} control {c} at n={n}: {err} != 0")
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            k_ms = time_ms(lambda: oracle.apply_camodc_high_planar(x, out, C, a, c, M), reps=5)
            p_ms = time_ms(lambda: tops.apply_camodc_high_planes_(out, C, a, c, M), reps=2)
            walk = x.clone()
            w_ms = time_ms(lambda: oracle.apply_camodc_high_cycle_planar(walk, C, a, c, M), reps=5)
            del walk
            if dtype != torch.float64 and c == GATHER_CONTROLS[0]:
                entry["ms"], entry["plain_ms"] = k_ms, p_ms
                entry["library_ms"], entry["library"] = time_library_row_gather(x, C, (a,), (c,), M)
                set_bound(entry, 2 * x.numel() * x.element_size())  # every element read, every element written
            gbs = 2 * x.numel() * x.element_size() / (k_ms * 1e6)
            log(
                f"kernel {entry['name']} {dname(dtype)} n={n} M={M} control {c}: max abs {err:.3e} (tol 0); kernel "
                f"{k_ms:.4f} ms ({gbs:.1f} GB/s 1R+1W), plain {p_ms:.4f} ms, cycle walk {w_ms:.4f} ms"
            )
        del x, out
        torch.cuda.empty_cache()
    check(report["oracle_gather"]["launches"] == 2 * len(GATHER_CONTROLS), f"oracle_gather launches {report['oracle_gather']}")
    check(report["oracle_gather_bf16"]["launches"] == len(GATHER_CONTROLS), f"oracle_gather_bf16 {report['oracle_gather_bf16']}")


def phase_probes(report: dict) -> None:
    """The probe scripts at M = 28 through their entry points, the launch
    counters reset just before and read just after."""
    from quantumcomputer_tpu_torch.scripts import prof_chunkgather, prof_rowperm

    reset_launches()
    t0 = time.perf_counter()
    rows = prof_chunkgather.run(PROBE_M, PROBE_W, reps=3, device=DEVICE)
    rows += prof_rowperm.run(PROBE_M, reps=3, device=DEVICE)
    wall = time.perf_counter() - t0
    counts = launches()
    log(f"probes M={PROBE_M} W={PROBE_W}: {len(rows)} rows in {wall:.3f} s, launches {counts}")
    for row in rows:
        check(row["ok"], f"probe row {row['name'].strip()}: max abs {row['max_abs_err']} != 0")
    import torch

    by_name = {row["name"].strip(): row for row in rows}
    for probe, row_name in (
        ("probe_copy", "aligned"), ("probe_roll2", "roll2"), ("probe_mxuroll", "mxuroll"),
        ("probe_dynroll", "pallas dyn-roll blk8"), ("probe_rowroll", "pallas per-row roll"),
    ):
        row = by_name[row_name]
        nbytes = row["gbps"] * row["ms"] * 1e6  # the row's 1R + 1W traffic, from its shapes
        # The same bytes through one call: copy_ for the copy probe, torch.roll
        # by one shift for the rolls (their per-chunk or per-row shifts have no
        # single call).
        src = torch.randn(int(round(nbytes / 8)), device=DEVICE)
        if probe == "probe_copy":
            dst = torch.empty_like(src)
            lib_ms, library = time_ms(lambda: dst.copy_(src), reps=5), "torch.Tensor.copy_ of the same bytes"
            del dst
        else:
            lib_ms, library = time_ms(lambda: torch.roll(src, 12345), reps=5), "torch.roll of the same bytes by one shift"
        del src
        report[probe].update(
            launches=counts[probe], max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            library_ms=lib_ms, library=library,
        )
        set_bound(report[probe], nbytes)
        log(f"kernel {probe}: {row['ms']:.4f} ms, library {lib_ms:.4f} ms, bound {report[probe]['bound_ms']:.4f} ms")
        check(counts[probe] > 0, f"the probe scripts launched no {probe} kernel")
    torch.cuda.empty_cache()


def phase_validation(report: dict) -> None:
    """TABLE I, FIG. 2 and FIG. 3, the n = 28 norm traces, the m_high
    flagship's spans and the fuse=False route, on the cuda backend.  The
    m_high norm trace runs every plan entry alone, so the walks' and the
    ladder's complex64 launches come from it (the main path merges them
    into one strip pass); its spans show that strip pass."""
    import torch

    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh, shor_circuit_reference
    from quantumcomputer_tpu_torch.ops import fused
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
    from quantumcomputer_tpu_torch.utils import experiments, profiling

    reset_launches()
    t0 = time.perf_counter()
    res = experiments.table1_experiment(
        runs=400, engine=StateVectorEngine(Register(L=3, M=4), torch.complex64, backend=KERNEL_BACKEND, device=DEVICE)
    )
    log(f"TABLE I on {KERNEL_BACKEND}: {res}; {time.perf_counter() - t0:.3f} s, launches {launches()}")
    check(res.passed, f"TABLE I failed: {res}")
    check(fused.LAUNCHES > 0, "TABLE I launched no fused-segment kernel")

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = experiments.main(["--runs", "400", "--fig3"])
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    log(f"experiments CLI --runs 400 --fig3: exit {rc}, {time.perf_counter() - t0:.3f} s")
    check(rc == 0, f"the experiments CLI returned {rc}")

    circuit = shor_circuit_reference(39, 7, 6, 6)
    ops = sum(fused.gate_to_op(g, 6, fuse_oracle=True) is not None for g in circuit)
    eng = StateVectorEngine(Register(L=6, M=6), torch.complex128, backend=KERNEL_BACKEND, device=DEVICE, fuse=False)
    reset_launches()
    tr = experiments.norm_deviation_trace(39, 7, 6, 6, engine=eng)
    counts = launches()
    log(
        f"FIG. 2 (39, a=7, L=M=6, complex128, fuse=False): {len(tr.deviations)} gates, max deviation "
        f"{tr.max_deviation:.3e} (tol 1e-13), launches {counts}"
    )
    check(tr.max_deviation < 1e-13, f"FIG. 2 max deviation {tr.max_deviation}")
    check(counts["fused_segment"] == ops, f"FIG. 2: {counts['fused_segment']} fused launches for {ops} gates with an op form")

    C, a, L, M = FLAGSHIP
    for layout, make_circuit in (("standard", shor_circuit), ("m_high", shor_circuit_mhigh)):
        circuit = make_circuit(C, a, L, M)
        eng = StateVectorEngine(Register(L=L, M=M), torch.complex64, backend=KERNEL_BACKEND, device=DEVICE, layout=layout)
        reset_launches()
        t0 = time.perf_counter()
        state, norms = eng.run_with_norms(circuit)
        wall = time.perf_counter() - t0
        dev = float((norms - 1.0).abs().max())
        log(
            f"run_with_norms flagship n={L + M} {layout}: {len(norms)} norms ({wall:.3f} s, launches {launches()}), "
            f"max |norm - 1| {dev:.3e} (tol {FLAGSHIP_TOL:.0e}): {[round(float(v), 9) for v in norms]}"
        )
        check(len(norms) == len(eng._plan(circuit)), f"{layout}: {len(norms)} norms for {len(eng._plan(circuit))} plan entries")
        check(dev <= FLAGSHIP_TOL, f"{layout} flagship norm trace deviates by {dev}")
        del state
        if layout == "m_high":
            counts = launches()
            check(counts["cycle"] > 0 and counts["ladder"] > 0 and counts["strip"] == 0,
                  f"the m_high run with norms did not run its walks and ladder one by one: {counts}")
            report["cycle"]["launches"], report["ladder"]["launches"] = counts["cycle"], counts["ladder"]
            eng.run(circuit)  # warm
            profiling.span_records(clear=True)
            profiling.record_spans(True)
            try:
                eng.run(circuit)
            finally:
                profiling.record_spans(False)
            recs = profiling.span_records(clear=True)
            for name, tot in profiling.span_summary(recs).items():
                log(f"spans m_high n={L + M}: {name:13s} {tot['count']:2d} x, host {tot['host_ms']:.3f} ms, "
                    f"device {tot['device_ms']:.3f} ms")
            gates = [r.counts for r in recs if r.name == "oracle.gate"]
            entries = sum(e[0] == "single" and e[1].name.startswith("camodc") for e in eng._plan(circuit))
            log(f"spans m_high n={L + M}: oracle.gate counts {gates}")
            check(len(gates) == 1 and gates[0]["gates"] == L and gates[0]["entries"] == entries,
                  f"the m_high flagship's oracle stage is not one strip span of {L} gates and {entries} entries: {gates}")
        torch.cuda.empty_cache()

    C, a, L, M = UNFUSED
    for layout, make_circuit in (("standard", shor_circuit), ("m_high", shor_circuit_mhigh)):
        circuit = make_circuit(C, a, L, M)
        ops = sum(fused.gate_to_op(g, M, fuse_oracle=True) is not None for g in circuit)
        reg = Register(L=L, M=M)
        reset_launches()
        got = StateVectorEngine(reg, backend=KERNEL_BACKEND, device=DEVICE, layout=layout, fuse=False).run(circuit)
        counts = launches()
        want = StateVectorEngine(reg, backend=KERNEL_BACKEND, device=DEVICE, layout=layout).run(circuit)
        dist = float(torch.linalg.vector_norm(got - want))
        log(f"fuse=False n={L + M} {layout}: {len(circuit)} gates, {ops} with an op form; launches {counts}; "
            f"||fuse=False - fuse=True||_2 = {dist:.3e} (tol {UNFUSED_TOL:.0e})")
        check(counts["fused_segment"] == ops, f"fuse=False {layout}: {counts['fused_segment']} fused launches for {ops} gates")
        check(dist <= UNFUSED_TOL, f"fuse=False vs fuse=True {layout}: {dist}")


def phase_flagship_c32(report: dict) -> None:
    """The n = 28 flagship at complex32 (a 1 GiB bf16 state), in the standard
    layout, m_high and with oracle="benes": each timed in turns with its
    complex64 run (c64, c32, c32, c64), its norm within C32_NORM_TOL of 1,
    ||psi_c32 - psi_c64||_2 within C32_DIST_TOL, and the benes state equal
    to the gather's; the bf16 block sums on the standard state held and
    timed; the m_high circuit below a two-state budget (in-place oracles,
    cycle_masked); then every fused segment of the standard and m_high
    plans, every benes oracle segment and the m_high oracle kernels at bf16
    held against their plain versions and timed beside their bounds."""
    import torch

    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh
    from quantumcomputer_tpu_torch.ops import measure
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    C, a, L, M = FLAGSHIP
    n = L + M
    reg = Register(L=L, M=M)
    states, engines, runs = {}, {}, {}
    for name, layout, oracle_kind in (("standard", "standard", "gather"), ("m_high", "m_high", "gather"),
                                      ("benes", "standard", "benes")):
        circuit = (shor_circuit_mhigh if layout == "m_high" else shor_circuit)(C, a, L, M)
        kw = dict(layout=layout, oracle=oracle_kind)
        e64 = StateVectorEngine(reg, torch.complex64, backend=KERNEL_BACKEND, device=DEVICE, **kw)
        e32 = StateVectorEngine(reg, "complex32", **kw)  # no device: complex32 must place itself on the card
        check((e32.backend, e32.device.type) == ("cuda", "cuda"),
              f"a complex32 engine built with no device sits on {e32.device} (backend {e32.backend}), not the card")
        runs[name] = {"c64": [], "c32": []}
        for which in ("c64", "c32", "c32", "c64"):
            eng = e32 if which == "c32" else e64
            runs[name][which].append(time_ms(lambda: eng.run(circuit), reps=3))
        reset_launches()
        s32 = e32.run(circuit)
        counts = launches()
        norm = e32.norm(s32)
        dist = float(torch.linalg.vector_norm(s32.float() - e64.run(circuit)))
        torch.cuda.empty_cache()
        log(
            f"flagship complex32 n={n} {name}: {runs[name]['c32']} ms against complex64 {runs[name]['c64']} ms "
            f"(turns c64, c32, c32, c64); {len(e32._plan(circuit))} plan entries; norm {norm:.9f} (tol "
            f"{C32_NORM_TOL:.0e}); ||c32 - c64||_2 = {dist:.4e} (tol {C32_DIST_TOL:.0e}); launches {counts}"
        )
        check(s32.dtype == torch.bfloat16 and s32.device.type == "cuda", f"the complex32 {name} state is {s32.dtype} "
              f"on {s32.device}")
        check(counts["fused_segment"] > 0, f"the complex32 {name} flagship launched no fused-segment kernel")
        if name == "benes":
            check(counts["permute"] == counts["camodc"] > 0,
                  f"the complex32 benes flagship's camodc segments did not all launch the camodc permutation: {counts}")
        if name == "m_high":
            check(counts["matmul"] > 0, "the complex32 m_high flagship launched no matrix group")
            check(counts["strip"] > 0, f"the complex32 m_high flagship merged no walks into a strip pass: {counts}")
            walked, _ = e32.run_with_norms(circuit)  # with norms every plan entry runs alone: the walks
            same = torch.equal(walked, s32)
            del walked
            log(f"flagship complex32 m_high: equal bit for bit to its plan applied entry by entry through the walks: {same}")
            check(same, "the complex32 m_high flagship state differs from its plan applied entry by entry")
        check(abs(norm - 1.0) <= C32_NORM_TOL, f"complex32 {name} flagship norm {norm}")
        check(dist <= C32_DIST_TOL, f"complex32 {name} flagship distance to complex64 {dist}")
        report["fused_segment_bf16"].setdefault("flagship", {})[name] = dict(
            c32_ms=runs[name]["c32"], c64_ms=runs[name]["c64"], norm=norm, dist_c64=dist
        )
        states[name], engines[name] = s32, (e32, circuit)
    check(torch.equal(states["benes"], states["standard"]), "the complex32 benes state differs from the gather's")
    log("flagship complex32: the benes state equals the gather state exactly")
    forms = time_flagship_forms(reg, engines["m_high"][1], "complex32")
    dist = float(torch.linalg.vector_norm(forms["states"]["grouped"].float() - forms["states"]["butterfly"].float()))
    del forms["states"]
    report["fused_matmul_bf16"].update(flagship_ms=forms["grouped"], flagship_butterfly_ms=forms["butterfly"])
    log(f"flagship m_high n={n} complex32: segments grouped {forms['grouped']} ms, butterfly form {forms['butterfly']} "
        f"ms (turns grouped, butterfly, butterfly, grouped); ||grouped - butterfly||_2 = {dist:.3e} (tol "
        f"{C32_DIST_TOL:.0e})")
    check(dist <= C32_DIST_TOL, f"complex32 m_high flagship grouped vs butterfly distance {dist}")

    entry = report["block_sums_bf16"]
    state = states["standard"]
    err = float((measure.block_sums(state) - measure.block_sums_plain(state)).abs().max())
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    check(err <= BLOCK_SUMS_TOL, f"block_sums on the complex32 flagship state: {err}")
    entry["ms"] = time_ms(lambda: measure.block_sums(state), reps=10)
    entry["plain_ms"] = time_ms(lambda: measure.block_sums_plain(state), reps=10)
    blocks = state.view(2, measure.block_sums(state).numel(), -1)
    entry["library_ms"] = time_ms(lambda: torch.linalg.vector_norm(blocks, dim=(0, 2), dtype=torch.float32), reps=10)
    entry["library"] = "torch.linalg.vector_norm(dtype=float32) over the (2, nblocks, block) view"
    set_bound(entry, state.numel() * state.element_size() + 4 * blocks.shape[1], 3.0 * state.numel())
    log(
        f"kernel block_sums_bf16 n={n}: max abs {err:.3e}; kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, "
        f"library {entry['library_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms"
    )
    del blocks, state

    # The memory ceiling at bf16: a budget that holds one state and not two.
    e32, circuit = engines["m_high"]
    os.environ["QC_TPU_HBM_BYTES"] = str(states["m_high"].numel() * 2 * 3 // 2)
    try:
        ceiling = StateVectorEngine(reg, "complex32", device=DEVICE, layout="m_high")
        ceiling_ms = time_ms(lambda: ceiling.run(circuit), reps=1)
        reset_launches()
        low = ceiling.run(circuit)
        counts = launches()
        walked, _ = ceiling.run_with_norms(circuit)
    finally:
        del os.environ["QC_TPU_HBM_BYTES"]
    same = torch.equal(low, states["m_high"])
    same_walked = torch.equal(low, walked)
    del low, walked
    log(f"flagship complex32 m_high below two states: {ceiling_ms:.3f} ms, launches {counts}; equal to the two-state "
        f"plan bit for bit: {same}; to its own plan applied entry by entry through the walks: {same_walked}")
    check(counts["strip"] > 0, "the complex32 memory-ceiling run merged no walks into a strip pass")
    check(same_walked, "the complex32 memory-ceiling state differs from its plan applied entry by entry")
    check(counts["cycle_masked"] > 0, "the complex32 memory-ceiling run launched no cycle_masked kernel")
    check(counts["ladder"] == 0, "the complex32 memory-ceiling run launched the out-of-place ladder")
    check(same, "the complex32 memory-ceiling flagship state differs from the two-state plan's")
    report["cycle_masked_bf16"]["launches"] = counts["cycle_masked"]
    mhigh_plan = e32._plan(circuit)
    benes_plan = engines["benes"][0]._plan(engines["benes"][1])
    standard_plan = engines["standard"][0]._plan(engines["standard"][1])
    del states, engines
    torch.cuda.empty_cache()

    planar = unit_planar(n, torch.bfloat16, 28)
    planar32 = unit_planar(n, torch.float32, 29)
    timed = time_segments(report, planar, [s for s in standard_plan if s[0] == "fused"], M, "standard", planar32)
    timed += time_segments(report, planar, [s for s in mhigh_plan if s[0] == "fused"], 0, "m_high", planar32)
    fill_matmul_entry(report, torch.bfloat16, timed)
    entry = report["fused_segment_bf16"]
    first = timed[0]
    entry.update(ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"], bound_by=first["bound_by"],
                 f32_ms=first["f32_ms"])
    entry["segments"] = [t for t in timed if "groups" not in t]  # the grouped ones: fused_matmul_bf16
    entry["segments_mean_ms"] = sum(t["ms"] for t in entry["segments"]) / len(entry["segments"])
    entry["segments_mean_plain_ms"] = sum(t["plain_ms"] for t in entry["segments"]) / len(entry["segments"])
    log(f"kernel fused_segment_bf16 n={n}: standard segment 0 {entry['ms']:.4f} ms (bound {entry['bound_ms']:.4f}, "
        f"{entry['bound_ms'] / entry['ms']:.1%}; the float32 instance {entry['f32_ms']:.4f} ms); the "
        f"{len(entry['segments'])} segments of both plans without matrix groups: mean {entry['segments_mean_ms']:.4f} ms")
    # The benes plan's H and iQFT segments (every segment without a camodc op), at both dtypes.
    rows = time_segments(report, planar, [s for s in benes_plan if s[0] == "fused"
                                          and not any(op[0] == "camodc" for op in s[1])], M, "benes", planar32)
    check(len(rows) == 6 and all("f32_ms" in r for r in rows),
          f"the complex32 benes plan's H and iQFT segments are not six segments without matrix groups: {rows}")
    entry["benes_butterfly_segments"] = rows
    entry["benes_butterfly_sum_ms"] = sum(r["ms"] for r in rows)
    entry["benes_butterfly_sum_f32_ms"] = sum(r["f32_ms"] for r in rows)
    log(f"kernel fused_segment_bf16 benes flagship n={n}: its {len(rows)} H and iQFT segments {entry['benes_butterfly_sum_ms']:.4f} "
        f"ms at bf16, {entry['benes_butterfly_sum_f32_ms']:.4f} ms through the float32 instance")
    del planar32
    entry = report["camodc_bf16"]
    fill_camodc_entry(entry, time_camodc_segments(entry, planar.clone(), benes_plan, M))
    singles = [entry[1] for entry in mhigh_plan if entry[0] == "single"]
    ladder = next(g.qubits for g in singles if g.name == "camodc_ladder_high")
    walks = tuple(g.qubits[0] for g in singles if g.name == "camodc_high")
    log(f"m_high complex32 plan at n={n}: ladder at controls {ladder}, walks at controls {walks}")
    time_mhigh_oracles(report, planar, C, a, M, ladder, walks)
    r = time_strip_run(planar, C, a, M, (*walks, ladder))
    report["oracle_strip_bf16"].update(
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by="bytes", library_ms=r["library_ms"],
        library=r["library"], strip_bytes=r["strip_bytes"], entries_sum_ms=r["entries_sum_ms"], entry_ms=r["entry_ms"],
    )
    # The 32-byte strips, which a run takes where C of their rows fit shared
    # memory: the same run at M = 12 (C = 4093, a prime below 2^12).
    wide = time_strip_run(planar, 4093, 2, 12, walks)
    check(wide["strip_bytes"] == 32, f"the run at M = 12 took {wide['strip_bytes']}-byte strips")
    report["oracle_strip_bf16"]["m12"] = {k: wide[k] for k in ("strip_bytes", "ms", "bound_ms", "entries_sum_ms")}
    del planar
    torch.cuda.empty_cache()


def phase_cli_c32() -> None:
    """The CLI at complex32: 15 (-C 15 -L 3 -M 4 -a 7), then the n = 31
    demo (C32_CLI, an 8 GiB bf16 state), seeds in turn until it factors;
    the launch counters reset before each run and read after it."""
    import torch

    from quantumcomputer_tpu_torch import cli
    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit_mhigh

    C, a, L, M = (int(C32_CLI[C32_CLI.index(f) + 1]) for f in ("-C", "-a", "-L", "-M"))
    merged = stage_merges(shor_circuit_mhigh(C, a, L, M), L + M, torch.bfloat16)
    for argv, want in ((["-C", "15", "-L", "3", "-M", "4", "-a", "7", "--dtype", "complex32", "-v", "--seed", "0"],
                        " --- Factors of 15 found: (5, 3)."),):
        reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        for line in buf.getvalue().splitlines():
            log(f"  | {line}")
        counts = launches()
        check(rc == 0 and want in buf.getvalue(), f"the complex32 CLI on 15 returned {rc}")
        check(counts["fused_segment"] > 0, "the complex32 CLI run on 15 launched no fused-segment kernel")
        log(f"cli --dtype complex32: factored 15 = 5 x 3, launches {counts}")
    for seed in C32_CLI_SEEDS:
        reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(C32_CLI + ["--seed", str(seed)])
        wall = time.perf_counter() - t0
        counts = launches()
        for line in buf.getvalue().splitlines():
            log(f"  | {line}")
        log(f"cli n=31 complex32 m_high --seed {seed}: exit {rc}, {wall:.3f} s, launches {counts}")
        check(rc in (0, 3), f"the n=31 CLI returned {rc}")
        for k in ("fused_segment", "matmul", "block_sums", "strip", *(() if merged else ("ladder",))):
            check(counts[k] > 0, f"the n=31 complex32 CLI run launched no {k} kernel")
        if merged:
            check(counts["ladder"] == counts["cycle"] == 0, f"the n=31 complex32 CLI's merged stage walked: {counts}")
        if rc == 0:
            check(" --- Factors of 8189 found: (431, 19)." in buf.getvalue(), "the n=31 CLI did not factor 8189")
            return
    raise SmokeFailure(f"the n=31 complex32 CLI factored 8189 under none of the seeds {list(C32_CLI_SEEDS)}")


def phase_validation_c32(report: dict) -> None:
    """The validation layer at complex32: the experiments CLI with --dtype
    complex32 (TABLE I, 400 shots, on the complex32 cuda engine), and
    run_with_norms on the n = 28 flagship in both layouts (float32 norms,
    every one within C32_NORM_TOL of 1, one per entry of the plan).  With
    norms every plan entry runs on its own, so the m_high run walks its
    single oracles (the bf16 cycle walk, whose launches it reports) and
    launches no strip pass."""
    import torch

    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
    from quantumcomputer_tpu_torch.utils import experiments

    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = experiments.main(["--runs", "400", "--dtype", "complex32"])
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    counts = launches()
    log(f"experiments CLI --runs 400 --dtype complex32: exit {rc}, {time.perf_counter() - t0:.3f} s, launches {counts}")
    check(rc == 0 and "-> PASS" in buf.getvalue(), f"TABLE I at complex32 returned {rc}")
    check(counts["fused_segment"] > 0, "TABLE I at complex32 launched no fused-segment kernel")

    C, a, L, M = FLAGSHIP
    for layout, make_circuit in (("standard", shor_circuit), ("m_high", shor_circuit_mhigh)):
        circuit = make_circuit(C, a, L, M)
        eng = StateVectorEngine(Register(L=L, M=M), "complex32", device=DEVICE, layout=layout)
        reset_launches()
        state, norms = eng.run_with_norms(circuit)
        counts = launches()
        dev = float((norms - 1.0).abs().max())
        log(
            f"run_with_norms complex32 flagship n={L + M} {layout}: {len(norms)} {dname(norms.dtype)} norms (launches "
            f"{counts}), max |norm - 1| {dev:.3e} (tol {C32_NORM_TOL:.0e}): {[round(float(v), 6) for v in norms]}"
        )
        if layout == "m_high":
            check(counts["cycle"] > 0 and counts["ladder"] > 0 and counts["strip"] == 0,
                  f"the complex32 m_high run with norms did not run its walks and ladder one by one: {counts}")
            report["cycle_bf16"]["launches"], report["ladder_bf16"]["launches"] = counts["cycle"], counts["ladder"]
        check(state.dtype == torch.bfloat16 and norms.dtype == torch.float32, f"{layout}: {state.dtype}, {norms.dtype}")
        check(len(norms) == len(eng._plan(circuit)), f"{layout}: {len(norms)} norms for {len(eng._plan(circuit))} entries")
        check(dev <= C32_NORM_TOL, f"complex32 {layout} flagship norm trace deviates by {dev}")
        del state
        torch.cuda.empty_cache()


class Killed(RuntimeError):
    """A simulated preemption of a checkpointed run."""


def timed_saves(ckpt) -> list:
    """Wrap ckpt.save_state to record (bytes, seconds) of each snapshot, the
    device's queued work finished before the clock starts."""
    import torch

    saves, save = [], ckpt.save_state

    def timed(path, state, meta):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(path, state, meta)
        saves.append((state.numel() * state.element_size(), time.perf_counter() - t0))

    ckpt.save_state = timed
    return saves


def phase_checkpoint() -> None:
    """Checkpoint/resume on the card: the complex32 flagship (n = 28) in both
    layouts through run_with_checkpoints, killed after segment 3 and
    resumed, bit for bit against the uninterrupted segmented run and within
    C32_DIST_TOL of engine.run on the whole circuit; the README's CLI example
    with --checkpoint-dir; the M = 28 structured semiclassical attempt
    killed after its step-4 snapshot and resumed, against the uninterrupted
    and the unchecked attempts."""
    import shutil
    import tempfile

    import torch

    from quantumcomputer_tpu_torch import cli
    from quantumcomputer_tpu_torch.algorithms import semiclassical as sc
    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh
    from quantumcomputer_tpu_torch.sim import checkpoint as ckpt
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    t_phase = time.perf_counter()
    save = ckpt.save_state
    saves = timed_saves(ckpt)
    C, a, L, M = FLAGSHIP
    tmp = tempfile.mkdtemp(prefix="qc_ckpt_")
    try:
        for layout, build in (("standard", shor_circuit), ("m_high", shor_circuit_mhigh)):
            t0 = time.perf_counter()
            circuit = build(C, a, L, M)
            nseg = -(-len(circuit) // CKPT_SEGMENT_GATES)

            def engine():
                return StateVectorEngine(Register(L=L, M=M), "complex32", backend=KERNEL_BACKEND, device=DEVICE,
                                         layout=layout)

            whole = engine().run(circuit)
            reset_launches()
            eng = engine()
            segmented = ckpt.run_with_checkpoints(eng, circuit, os.path.join(tmp, "full"), CKPT_SEGMENT_GATES)
            counts = launches()
            check(ckpt.latest_segment(os.path.join(tmp, "full")) == nseg, f"{layout}: not every segment snapshotted")
            shutil.rmtree(os.path.join(tmp, "full"))
            check(counts["fused_segment"] > 0, f"{layout}: the segmented run launched no fused kernel: {counts}")
            if layout == "m_high":
                check(counts["cycle"] + counts["strip"] + counts["ladder"] + counts["cycle_masked"] > 0,
                      f"the segmented m_high run launched no oracle kernel: {counts}")
            eng = engine()
            run, done = eng.run, []

            def dying_run(circ, state=None):
                if len(done) >= CKPT_KILL_AFTER:
                    raise Killed(f"after segment {len(done)}")
                done.append(1)
                return run(circ, state)

            eng.run = dying_run
            killed_dir = os.path.join(tmp, "killed")
            try:
                ckpt.run_with_checkpoints(eng, circuit, killed_dir, CKPT_SEGMENT_GATES)
                check(False, f"{layout}: the killed run was not killed")
            except Killed:
                pass
            check(ckpt.latest_segment(killed_dir) == CKPT_KILL_AFTER, f"{layout}: {ckpt.all_segments(killed_dir)}")
            eng, executed = engine(), []
            run2 = eng.run
            eng.run = lambda circ, state=None: (executed.append(1), run2(circ, state))[1]
            resumed = ckpt.run_with_checkpoints(eng, circuit, killed_dir, CKPT_SEGMENT_GATES)
            shutil.rmtree(killed_dir)
            check(len(executed) == nseg - CKPT_KILL_AFTER, f"{layout}: resumed run executed {len(executed)} segments")
            check(torch.equal(resumed, segmented), f"{layout}: the resumed state differs from the segmented run")
            dist = float(torch.linalg.vector_norm(resumed.float() - whole.float()))
            log(f"checkpoint complex32 {layout} n={L + M}: {nseg} segments of {CKPT_SEGMENT_GATES} gates, killed after "
                f"{CKPT_KILL_AFTER}, resumed {len(executed)}: equal bit for bit to the segmented run; "
                f"||resumed - run||_2 = {dist:.3e} (tol {C32_DIST_TOL:.0e}); launches of the segmented run {counts}; "
                f"{time.perf_counter() - t0:.3f} s")
            check(dist <= C32_DIST_TOL, f"{layout}: checkpointed state {dist} from engine.run")
            del whole, segmented, resumed
            torch.cuda.empty_cache()
        nbytes, secs = sum(b for b, _ in saves), sum(t for _, t in saves)
        log(f"checkpoint snapshots: {len(saves)} of {saves[0][0] / 2**30:.3f} GiB, {secs / (nbytes / 2**30):.3f} s per GiB "
            f"(device to host and np.savez to {tempfile.gettempdir()})")

        argv = ["-C", "21", "-L", "4", "-M", "5", "-a", "2", "--seed", "1"]
        outs = []
        for extra in (["--checkpoint-dir", os.path.join(tmp, "cli")], []):
            reset_launches()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv + extra)
            outs.append((rc, [x for x in buf.getvalue().splitlines() if "Factors of" in x]))
            log(f"cli {' '.join(argv + extra)}: exit {rc}, {outs[-1][1]}, launches {launches()}")
        check(outs[0] == outs[1] and outs[0][0] == 0, f"the CLI with --checkpoint-dir: {outs}")
        check(os.listdir(os.path.join(tmp, "cli")) == [], "the CLI left its attempt directory")

        C, a, L, M = SC_M28
        gen = torch.Generator().manual_seed(SC_CKPT_SEED)
        rs = torch.rand((L,), generator=gen, dtype=torch.float32)
        t0 = time.perf_counter()
        plain = sc.run_semiclassical(C, a, L, M, rs, structured=True, device=DEVICE)
        t_plain = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        full = sc.run_semiclassical(C, a, L, M, rs, structured=True, device=DEVICE,
                                    checkpoint_dir=os.path.join(tmp, "sc"), checkpoint_every=4)
        t_full = time.perf_counter() - t0
        counts = launches()
        check(counts["offset_transpose"] > 0 and counts["transpose"] == counts["chunk_gather"] == 0,
              f"the checkpointed attempt: {counts}")
        timed = ckpt.save_state

        def save_and_kill(path, state, meta):
            timed(path, state, meta)
            raise Killed(f"after step {meta['step']}")

        ckpt.save_state = save_and_kill
        try:
            sc.run_semiclassical(C, a, L, M, rs, structured=True, device=DEVICE,
                                 checkpoint_dir=os.path.join(tmp, "sc"), checkpoint_every=4)
            check(False, "the semiclassical attempt was not killed")
        except Killed:
            pass
        ckpt.save_state = timed
        (attempt,) = os.listdir(os.path.join(tmp, "sc"))
        check(ckpt.all_segments(os.path.join(tmp, "sc", attempt)) == [4], "no step-4 snapshot")
        t0 = time.perf_counter()
        resumed = sc.run_semiclassical(C, a, L, M, rs, structured=True, device=DEVICE,
                                       checkpoint_dir=os.path.join(tmp, "sc"), checkpoint_every=4)
        t_resumed = time.perf_counter() - t0
        check(os.listdir(os.path.join(tmp, "sc")) == [], "the resumed attempt left its directory")
        for rec, what in ((full, "uninterrupted"), (resumed, "resumed")):
            check((rec.bits, rec.branch_probs) == (plain.bits, plain.branch_probs),
                  f"semiclassical {what}: {rec.bits} {rec.branch_probs} vs {plain.bits} {plain.branch_probs}")
        sc_save = saves[-1]
        log(f"checkpoint semiclassical M={M} C={C} a={a} L={L} complex64 structured: bits {plain.bits}, probs "
            f"{[round(p, 9) for p in plain.branch_probs]} equal without checkpoint_dir ({t_plain:.3f} s), "
            f"uninterrupted ({t_full:.3f} s) and resumed from step 4 ({t_resumed:.3f} s); snapshot "
            f"{sc_save[0] / 2**30:.3f} GiB in {sc_save[1]:.3f} s; launches {counts}")
    finally:
        ckpt.save_state = save
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase checkpoint: {time.perf_counter() - t_phase:.3f} s")


def amplitude_stats(state, marked: int) -> tuple:
    """(marked amplitude, mean, spread and largest imaginary part of every
    other amplitude), on the card, in float64, up to the global sign that
    makes the marked amplitude positive."""
    import torch

    re = state[0].double()
    sign = 1.0 if float(re[marked]) >= 0 else -1.0
    others = torch.cat([re[:marked], re[marked + 1:]]) * sign
    return (sign * float(re[marked]), float(others.mean()), float(others.max() - others.min()),
            float(state[1].double().abs().max()))


def phase_algorithms() -> None:
    """The generic algorithm layer at n = 28 on the card, complex64 and
    complex32 (PERF.md section 4): Grover, Bernstein-Vazirani,
    Deutsch-Jozsa, Simon, QPE in both forms, amplitude estimation, one
    full-width QV model circuit against the complex128 engine with its
    100-shot sample, and the QV protocol through the experiments CLI."""
    import math

    import numpy as np
    import torch

    from quantumcomputer_tpu_torch.algorithms import amplitude_estimation as ae
    from quantumcomputer_tpu_torch.algorithms import grover, oracle_algorithms as ora, qpe, quantum_volume as qv, simon
    from quantumcomputer_tpu_torch.models import circuit as cir
    from quantumcomputer_tpu_torch.ops import measure
    from quantumcomputer_tpu_torch.ops import gates as tops
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
    from quantumcomputer_tpu_torch.utils import experiments, kernel_checks

    t_phase = time.perf_counter()
    rng = np.random.default_rng(ALGO_SEED)
    n = ALGO_N
    secrets = {"grover": int(rng.integers(1 << n)), "bv": int(rng.integers(1, 1 << n)),
               "simon": int(rng.integers(1, 1 << (n // 2))), "qpe": int(rng.integers(1 << QPE_T)),
               "qpe_sc": int(rng.integers(1 << QPE_SC_T)),
               "ae": sorted(int(x) for x in rng.choice(1 << AE_N, AE_MARKED, replace=False))}
    draws = [float(x) for x in rng.random(64)]
    log(f"algorithms n={n}: secrets {secrets}")

    def engine(L, M, dtype):
        return StateVectorEngine(Register(L=L, M=M), dtype, backend=KERNEL_BACKEND, device=DEVICE)

    for dtype in (torch.complex64, "complex32"):
        name = "complex64" if dtype == torch.complex64 else "complex32"
        tol = ALGO_TOL[name]
        eng = engine(n, 0, dtype)

        t0 = time.perf_counter()
        reset_launches()
        tops.MCPHASE_CALLS = 0
        marked = secrets["grover"]
        state = eng.run(grover.grover_circuit(n, marked, iterations=GROVER_ITERS), eng.zero_state())
        amp, mean, spread, imag = amplitude_stats(state, marked)
        theta = math.asin(2.0 ** (-n / 2))
        want_amp = math.sin((2 * GROVER_ITERS + 1) * theta)
        want_other = math.cos((2 * GROVER_ITERS + 1) * theta) / math.sqrt((1 << n) - 1)
        idx, _ = eng.measure(state, draws[0])
        counts, mcp = launches(), tops.MCPHASE_CALLS
        del state
        log(f"grover {name} n={n} marked {marked}, {GROVER_ITERS} iterations: amplitude {amp:.9e} (sin(7 theta) "
            f"{want_amp:.9e}), others mean {mean:.9e} ({want_other:.9e}), spread {spread:.3e}, max |im| {imag:.3e}; "
            f"measured {idx}; mcphase calls {mcp}, launches {counts}; {time.perf_counter() - t0:.3f} s")
        check(abs(amp - want_amp) <= tol * want_amp, f"grover {name}: marked amplitude {amp} vs {want_amp}")
        check(abs(mean - want_other) <= tol * want_other and spread <= tol * want_other and imag <= tol * want_other,
              f"grover {name}: other amplitudes mean {mean} spread {spread} imag {imag}")
        check(mcp == 2 * GROVER_ITERS and counts["fused_segment"] > 0 and counts["block_sums"] == 1,
              f"grover {name}: mcphase {mcp}, launches {counts}")

        t0 = time.perf_counter()
        s = secrets["bv"]
        got = [ora.bernstein_vazirani(n, s, r, engine=eng) for r in draws[1:4]]
        const = ora.deutsch_jozsa(n, [], draws[4], engine=eng)
        balanced = ora.deutsch_jozsa(n, ora.bv_oracle(n, s), draws[5], engine=eng)
        log(f"bernstein-vazirani {name} n={n}: s {s}, three draws read {got}; deutsch-jozsa constant -> {const} "
            f"(index 0), balanced -> {balanced} (a non-zero index); {time.perf_counter() - t0:.3f} s")
        check(got == [s] * 3, f"bernstein-vazirani {name}: {got} != {s}")
        check(const is True and balanced is False, f"deutsch-jozsa {name}: constant {const}, balanced {balanced}")
        del eng
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        half = n // 2
        res = simon.simon_search(half, secrets["simon"], draws, engine=engine(half, half, dtype))
        log(f"simon {name} n={half} ({n} qubits): s {secrets['simon']} recovered {res.s} in {res.rounds} rounds; "
            f"{time.perf_counter() - t0:.3f} s")
        check(res.s == secrets["simon"], f"simon {name}: {res.s}")

        t0 = time.perf_counter()
        x = secrets["qpe"]
        cu = (lambda x: lambda j, c: [cir.CPHASE(c, 0, 2.0 * math.pi * x * (1 << j) / (1 << QPE_T))])(x)
        res = qpe.estimate_phase(cu, QPE_T, QPE_M, draws[6], engine=engine(QPE_T, QPE_M, dtype))
        log(f"qpe {name} full register t={QPE_T} M={QPE_M}: x {x} read {res.x} (raw {res.raw}); "
            f"{time.perf_counter() - t0:.3f} s")
        check(res.x == x, f"qpe {name}: read {res.x}, want {x}")
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        reset_launches()
        x = secrets["qpe_sc"]
        u = (lambda x: lambda j: [cir.PHASE(0, 2.0 * math.pi * x * (1 << j) / (1 << QPE_SC_T))])(x)
        res = qpe.run_semiclassical_qpe(u, QPE_SC_T, ALGO_N, draws[7:7 + QPE_SC_T], dtype=dtype,
                                        backend=KERNEL_BACKEND, device=DEVICE)
        log(f"qpe {name} semiclassical M={ALGO_N} t={QPE_SC_T}: x {x} read {res.x}, branch probabilities "
            f"min {min(res.record.branch_probs):.9f}; launches {launches()}; {time.perf_counter() - t0:.3f} s")
        check(res.x == x, f"semiclassical qpe {name}: read {res.x}, want {x}")
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        reset_launches()
        tops.MCPHASE_CALLS = 0
        ae_eng = engine(AE_T, AE_N, dtype)
        marginals = []
        ae_run = ae_eng.run

        def observed_run(circ, state=None, ae_run=ae_run, marginals=marginals):
            out = ae_run(circ, state)
            marginals.append(kernel_checks.counting_marginal(out, AE_N))  # before measure collapses it
            return out

        ae_eng.run = observed_run
        r = draws[20]
        est = ae.amplitude_estimate(AE_N, secrets["ae"], AE_T, r, engine=ae_eng)
        seconds, counts = time.perf_counter() - t0, launches()
        ideal = kernel_checks.ae_counting_probabilities(AE_N, AE_MARKED, AE_T)
        tv = 0.5 * float(np.abs(marginals[0] - ideal).sum())
        raw = lambda c: int(f"{c:0{AE_T}b}"[::-1], 2)  # the counting register's value <-> qpe's raw readout
        accepted = [qpe._negate_readout(raw(c), AE_T) for c in kernel_checks.readouts_within(ideal, r, tv + AE_SAMPLER_SLACK)]
        half = 1 << (AE_T - 1)  # an iterate without its oracle has eigenphase 1/2 alone
        a_true = AE_MARKED / float(1 << AE_N)
        bhmt = 2 * math.pi * math.sqrt(a_true * (1 - a_true)) / (1 << AE_T) + (math.pi / (1 << AE_T)) ** 2
        log(f"amplitude estimation {name} n={AE_N} t={AE_T} marked {secrets['ae']}: draw {r:.9f} read x {est.qpe.x}, "
            f"the ideal distribution gives {accepted} (x = {half} has probability "
            f"{ideal[raw(half)]:.3e}); counting register total variation from ideal {tv:.3e} (tol "
            f"{AE_TV_TOL[name]:g}); a_hat {est.a_hat:.9e} (a {a_true:.9e}, BHMT bound {bhmt:.9e}); mcphase calls "
            f"{tops.MCPHASE_CALLS}, launches {counts}; {seconds:.3f} s")
        check(tv <= AE_TV_TOL[name], f"amplitude estimation {name}: total variation {tv} from the ideal distribution")
        check(half not in accepted, f"amplitude estimation {name}: the draw cannot tell a from 0 ({accepted})")
        check(est.qpe.x in accepted, f"amplitude estimation {name}: read {est.qpe.x}, the ideal distribution gives {accepted}")
        check(abs(est.a_hat - a_true) <= bhmt, f"amplitude estimation {name}: {est.a_hat} vs {a_true}")
        del ae_eng
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    circ = qv.qv_model_circuit(n, np.random.default_rng(ALGO_SEED))
    states = {}
    for dtype in (torch.complex128, torch.complex64, "complex32"):
        eng = engine(n, 0, dtype)
        reset_launches()
        t1 = time.perf_counter()
        states[str(dtype)] = eng.run(circ, eng.zero_state())
        torch.cuda.synchronize()
        log(f"quantum volume m={n} {dtype}: {len(circ)} u2q gates, {time.perf_counter() - t1:.3f} s, launches {launches()}")
    d64 = float(torch.linalg.vector_norm(states["torch.complex64"].double() - states["torch.complex128"]))
    plan = engine(n, 0, "complex32")._plan(circ)
    pass_products = [kernel_checks.segment_products(e[1], 0, torch.bfloat16, n) for e in plan if e[0] == "fused"]
    d32 = float(torch.linalg.vector_norm(states["complex32"].double() - states["torch.complex64"].double()))
    bound32 = 2 * math.sqrt(sum((p + 1) ** 2 for p in pass_products)) * kernel_checks.BF16_UNIT
    log(f"quantum volume m={n}: ||c64 - c128||_2 = {d64:.3e} (tol {QV_C64_TOL:.0e}); ||c32 - c64||_2 = {d32:.3e} "
        f"(bf16_circuit_within: {len(pass_products)} passes, {sum(pass_products)} matrix products, root-sum-square "
        f"bound {bound32:.3e})")
    check(d64 <= QV_C64_TOL, f"quantum volume complex64 vs complex128: {d64}")
    check(kernel_checks.bf16_circuit_within(states["complex32"], states["torch.complex64"], pass_products),
          f"quantum volume complex32 vs complex64: {d32}")
    del states["torch.complex128"]
    torch.cuda.empty_cache()
    rs = torch.tensor(rng.random(QV_SHOTS), dtype=torch.float32)
    for key_, state in states.items():
        eng = engine(n, 0, torch.complex64 if key_ == "torch.complex64" else "complex32")
        reset_launches()
        samples = eng.sample(state, rs)
        one = measure.LAUNCHES
        batched_ms = time_ms(lambda: eng.sample(state, rs), reps=3)
        reset_launches()
        single = [measure.sample_index(state, float(r)) for r in rs]
        per_draw = measure.LAUNCHES
        single_ms = time_ms(lambda: [measure.sample_index(state, float(r)) for r in rs], reps=1)
        log(f"quantum volume m={n} {key_} sample of {QV_SHOTS} shots: {one} block_sums launch, {batched_ms:.3f} ms; "
            f"{QV_SHOTS} single sample_index calls {single_ms:.3f} ms ({per_draw} launches); equal: "
            f"{samples.tolist() == single}")
        check(one == 1, f"sample of {QV_SHOTS} shots made {one} block_sums launches")
        check(samples.tolist() == single, f"{key_}: the batched sampler differs from the per-draw sampler")
    del states
    torch.cuda.empty_cache()
    log(f"quantum volume full width: {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = experiments.main(["--qv", str(QV_PROTOCOL_M)])
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    log(f"experiments --qv {QV_PROTOCOL_M}: exit {rc}; {time.perf_counter() - t0:.3f} s")
    check(rc == 0 and f"QV m={QV_PROTOCOL_M}:" in buf.getvalue() and "PASS (QV=" in buf.getvalue(),
          f"experiments --qv {QV_PROTOCOL_M} exited {rc}")
    log(f"phase algorithms: {time.perf_counter() - t_phase:.3f} s")


def prep_circuit(n: int) -> tuple:
    """tests/test_variational_engines.py's state preparation: an entangled
    state touching every qubit."""
    from quantumcomputer_tpu_torch.models import circuit as cir

    gates = [cir.H(q) for q in range(0, n, 2)]
    gates += [cir.CNOT(q, q + 1) for q in range(0, n - 1, 2)]
    gates += [cir.RY(q, 0.3 + 0.11 * q) for q in range(n)]
    gates += [cir.CZ(q, (q + 2) % n) for q in range(0, n - 1)]
    gates += [cir.T(0), cir.S(n - 1)]
    return tuple(gates)


def random_regular_edges(n: int, degree: int, rng) -> list:
    """A random simple degree-regular graph on n nodes (the configuration
    model: stubs paired at random until no loop or multi-edge is left)."""
    import numpy as np

    while True:
        pairs = rng.permutation(np.repeat(np.arange(n), degree)).reshape(-1, 2)
        edges = {tuple(sorted((int(a), int(b)))) for a, b in pairs if a != b}
        if len(edges) == len(pairs):
            return sorted(edges)


def pass_products(eng, circuit) -> list:
    """One entry per fused pass of the engine's plan of `circuit` at bf16:
    its matrix products (kernel_checks.segment_products)."""
    import torch

    from quantumcomputer_tpu_torch.utils import kernel_checks

    n = eng.register.n
    return [kernel_checks.segment_products(e[1], eng.m_eff, torch.bfloat16, n) for e in eng._plan(circuit)
            if e[0] == "fused"]


BACKWARD_ENTRIES = {"fused_segment": "fused_segment", "permute": "camodc", "matmul": "fused_matmul",
                    "ladder": "ladder", "cycle": "cycle", "cycle_masked": "cycle_masked", "strip": "oracle_strip"}


def grad_flagship(report: dict, form) -> None:
    """The engine's gradient on the n = 28 flagship in one form: the loss
    sum(out * w), w a seeded unit planar state; p.grad equal to
    engine.run(dagger_circuit) of w (torch.equal, the same path);
    U^dagger U |reset> against |reset>; the forward with a gradient, the
    backward and the run without a gradient timed in turns; the backward's
    launches into the report entries as "backward_launches"."""
    import torch

    from quantumcomputer_tpu_torch.models.circuit import dagger_circuit
    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh
    from quantumcomputer_tpu_torch.scripts import prof_grad
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
    from quantumcomputer_tpu_torch.utils import kernel_checks

    name, dtype, layout, oracle_kind = form
    C, a, L, M = FLAGSHIP
    n = L + M
    turns = {"run": [], "forward": [], "backward": []}
    for _ in range(2):
        for k, ms in prof_grad.form_ms(form).items():
            turns[k].append(ms)
    circuit = (shor_circuit_mhigh if layout == "m_high" else shor_circuit)(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), torch.complex64 if dtype == "complex64" else dtype,
                            backend=KERNEL_BACKEND, device=DEVICE, layout=layout, oracle=oracle_kind)
    planes = eng.real_dtype
    w = prof_grad.cotangent(n, planes)
    p = eng.initial_state().requires_grad_()
    out = eng.run(circuit, p)
    check(out is not p and torch.equal(p.detach(), eng.initial_state()),
          f"gradient {name}: the run with a gradient changed its input")
    reset_launches()
    torch.sum(out * w).backward()
    counts = {k: v for k, v in launches().items() if v}
    adjoint = dagger_circuit(circuit, eng.m_eff)
    same = torch.equal(p.grad, eng.run(adjoint, w.clone()))
    reset = eng.initial_state()
    back = eng.run(adjoint, out.detach().clone())
    dist = float(torch.linalg.vector_norm(back.double() - reset.double()))
    if planes == torch.bfloat16:
        products = pass_products(eng, circuit) + pass_products(eng, adjoint)
        ok = kernel_checks.bf16_circuit_within(back, reset, products)
        tol = 2 * math.sqrt(sum((q + 1) ** 2 for q in products)) * kernel_checks.BF16_UNIT
        bound = f"bf16_circuit_within over {len(products)} passes, {sum(products)} matrix products: {tol:.3e}"
    else:
        ok, bound = dist <= FLAGSHIP_TOL, f"{FLAGSHIP_TOL:.0e}"
    log(f"gradient {name} n={n}: run {turns['run']} ms, forward with a gradient {turns['forward']} ms, backward "
        f"{turns['backward']} ms (turns run, forward, backward twice); {len(eng._plan(circuit))} / "
        f"{len(eng._plan(adjoint))} plan entries forward / backward; backward launches {counts}; p.grad equal to "
        f"run(dagger_circuit, w): {same}; grad dtype {p.grad.dtype}; ||U^dagger U|reset> - |reset>||_2 = {dist:.3e} "
        f"(tol {bound})")
    check(p.grad.dtype == planes and same, f"gradient {name}: p.grad ({p.grad.dtype}) differs from the dagger run")
    check(ok, f"gradient {name}: U^dagger U |reset> is {dist} from |reset>")
    check(counts.get("fused_segment", 0) > 0, f"gradient {name}: the backward launched no fused segment: {counts}")
    suffix = "_bf16" if planes == torch.bfloat16 else ""
    for counter, entry in BACKWARD_ENTRIES.items():
        if counts.get(counter):
            report[entry + suffix].setdefault("backward_launches", {})[name] = counts[counter]
    report["fused_segment" + suffix].setdefault("gradient_ms", {})[name] = turns
    if name == "gather":
        del back, reset
        plain = StateVectorEngine(Register(L=L, M=M), torch.complex64, backend="torch", device=DEVICE)
        q = plain.initial_state().requires_grad_()
        torch.sum(plain.run(circuit, q) * w).backward()
        d = float(torch.linalg.vector_norm(p.grad - q.grad))
        log(f"gradient {name} n={n}: ||grad cuda - grad torch backend||_2 = {d:.3e} (tol {FLAGSHIP_TOL:.0e})")
        check(d <= FLAGSHIP_TOL, f"gradient {name}: the cuda gradient is {d} from the torch backend's")


def expectation_engine_n28() -> None:
    """expectation_on_engine at n = 28 on the prep state: complex64 against
    the plain expectation of the same state within EXPECT_TOL sum |c_k|,
    complex32 against complex64 within the bound its bf16 passes give;
    each timed (host clock: one host fetch per term)."""
    import torch

    from quantumcomputer_tpu_torch.algorithms import variational as var
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
    from quantumcomputer_tpu_torch.utils import kernel_checks

    n = ALGO_N
    prep = prep_circuit(n)
    for label, terms in (("tfim", var.tfim_hamiltonian(n, J=1.1, h=0.6)), ("heisenberg", var.heisenberg_hamiltonian(n))):
        weight = sum(abs(c) for c, _ in terms)
        values = {}
        for dtype in (torch.complex64, "complex32"):
            eng = StateVectorEngine(Register(L=n, M=0), dtype, backend=KERNEL_BACKEND, device=DEVICE)
            state = eng.run(prep, eng.zero_state())
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = var.expectation_on_engine(eng, state, terms)
            seconds, counts = time.perf_counter() - t0, launches()
            values[str(dtype)] = got
            line = (f"expectation_on_engine {label} n={n} {dtype}: {len(terms)} terms, {got:.9f} in {seconds:.3f} s, "
                    f"fused launches {counts['fused_segment']}")
            check(counts["fused_segment"] == len(terms), f"expectation_on_engine {label}: launches {counts}")
            if dtype == torch.complex64:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plain = float(var.expectation(state, terms))
                diff = abs(got - plain)
                log(f"{line}; plain expectation {plain:.9f} in {time.perf_counter() - t0:.3f} s, |diff| {diff:.3e} "
                    f"(tol {EXPECT_TOL * weight:.3e})")
                check(diff <= EXPECT_TOL * weight, f"expectation_on_engine {label}: {got} vs plain {plain}")
            else:
                # The state's bf16 passes move it by at most eps in norm
                # (bf16_circuit_within's root sum of squares), so the energy
                # moves by at most (2 eps + eps^2) sum |c_k|; each Pauli string's
                # pass moves entries by 0 or +-1 times, and rounds nothing.
                products = pass_products(eng, prep)
                eps = 2 * math.sqrt(sum((q + 1) ** 2 for q in products)) * kernel_checks.BF16_UNIT
                tol = (2 * eps + eps * eps) * weight
                diff = abs(got - values["torch.complex64"])
                log(f"{line}; |c32 - c64| {diff:.3e} (tol {tol:.3e}: {len(products)} passes, state eps {eps:.3e})")
                check(diff <= tol, f"expectation_on_engine {label} complex32: {got} vs {values['torch.complex64']}")
            del state, eng
            torch.cuda.empty_cache()


def vqe_step_breakdown(ans, terms, theta, steps: int = 3) -> dict:
    """One VQE step's parts at n = 24 (ansatz forward, energy, backward,
    Adam), CUDA events around each, averaged over `steps` steps after a
    first step (a cold allocator: its host-clock ms apart); each step's
    host-clock ms (it ends in the host fetch of the energy); then
    torch.profiler over two steps for the device's busy share, the union
    of its device events' intervals over the wall time, or None where the
    trace holds no device event."""
    import torch

    from quantumcomputer_tpu_torch.algorithms import variational as var

    theta = theta.detach().clone().requires_grad_()
    opt = torch.optim.Adam([theta], lr=VAR_LR, betas=(0.9, 0.999), eps=1e-8)
    parts = {"ansatz": 0.0, "energy": 0.0, "backward": 0.0, "adam": 0.0}

    def step(events=None):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        marks[0].record()
        opt.zero_grad(set_to_none=True)
        planar = ans.apply(theta, torch.float32)
        marks[1].record()
        e = var.expectation(planar, terms)
        marks[2].record()
        e.backward()
        marks[3].record()
        opt.step()
        marks[4].record()
        value = float(e.detach())
        if events is not None:
            for k, (a, b) in zip(parts, zip(marks, marks[1:])):
                events[k] += a.elapsed_time(b) / steps
        return value

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(steps):
        step(parts)
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    busy = None
    try:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        device_us, end = 0.0, float("-inf")
        for a, b in spans:
            device_us += max(0.0, b - max(a, end))
            end = max(end, b)
        busy = device_us / wall_us if spans else None
    except RuntimeError as exc:
        log(f"vqe step profile: torch.profiler failed ({exc}); busy share not measured")
    return {"parts_ms": parts, "first_step_ms": first_ms, "step_ms": step_ms, "busy_share": busy}


def vqe_n24() -> None:
    """VQE at n = 24 on the card: the float64 gradient at the initial
    parameters against central differences, the 20-step run (energy
    falling), expectation against expectation_on_engine at the final
    parameters, ms per step, peak memory, and one step's breakdown."""
    import torch

    from quantumcomputer_tpu_torch.algorithms import variational as var
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    n = VAR_N
    terms = var.tfim_hamiltonian(n, J=1.0, h=1.0)
    weight = sum(abs(c) for c, _ in terms)
    ans = var.HardwareEfficientAnsatz(n, VQE_DEPTH, rotation="Y", entangler="brick")
    theta0 = ans.initial_parameters(torch.Generator().manual_seed(0))

    def energy64(th):
        return var.expectation(ans.apply(th, torch.float64), terms)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    th = theta0.double().to(DEVICE).requires_grad_()
    energy64(th).backward()
    grad = th.grad.cpu()
    readings = []
    with torch.no_grad():
        for idx in FD_PARAMS:
            bump = th.detach().clone()
            bump[idx] += FD_EPS
            ep = float(energy64(bump))
            bump[idx] -= 2 * FD_EPS
            em = float(energy64(bump))
            readings.append((idx, float(grad[idx]), (ep - em) / (2 * FD_EPS)))
    del th
    torch.cuda.empty_cache()
    worst = max(abs(g - fd) for _, g, fd in readings)
    log(f"vqe n={n} float64 gradient at the initial parameters against central differences (eps {FD_EPS:g}): "
        + ", ".join(f"{idx}: {g:.12f} vs {fd:.12f}" for idx, g, fd in readings)
        + f"; max |diff| {worst:.3e} (tol {FD_TOL:.0e}); {time.perf_counter() - t0:.3f} s")
    check(worst <= FD_TOL, f"vqe gradient against central differences: {worst}")

    # A process's first torch.optim optimizer costs about a second of imports, not a step's time.
    torch.optim.Adam([torch.zeros(1, requires_grad=True)])
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = var.vqe(terms, n, depth=VQE_DEPTH, steps=VAR_STEPS, learning_rate=VAR_LR, ansatz=ans, seed=0, device=DEVICE)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    final = torch.from_numpy(res.parameters).to(DEVICE)
    with torch.no_grad():
        state = ans.apply(final, torch.float32)
        plain = float(var.expectation(state, terms))
    eng = StateVectorEngine(Register(L=n, M=0), torch.complex64, backend=KERNEL_BACKEND, device=DEVICE)
    on_engine = var.expectation_on_engine(eng, state, terms)
    diff = abs(plain - on_engine)
    log(f"vqe n={n} depth {VQE_DEPTH} TFIM: {VAR_STEPS} steps in {seconds:.3f} s ({seconds / VAR_STEPS * 1e3:.3f} ms a "
        f"step, host clock over the call with its final energy and state); energy {res.energies[0]:.9f} -> "
        f"{res.energies[-1]:.9f}, final {res.energy:.9f}; peak memory {peak:.3f} GiB (residual reckoning "
        f"{VQE_RESIDUAL_GIB:.3f} GiB); expectation {plain:.9f} vs expectation_on_engine {on_engine:.9f}, |diff| "
        f"{diff:.3e} (tol {EXPECT_TOL * weight:.3e})")
    check(res.energies[-1] < res.energies[0], f"vqe energy did not fall: {res.energies[0]} -> {res.energies[-1]}")
    check(diff <= EXPECT_TOL * weight, f"vqe final state: expectation {plain} vs on the engine {on_engine}")
    del state, eng
    torch.cuda.empty_cache()
    br = vqe_step_breakdown(ans, terms, theta0.to(DEVICE))
    busy = "not measured" if br["busy_share"] is None else f"{br['busy_share']:.1%}"
    log(f"vqe n={n} step breakdown (CUDA events, mean of 3 steps): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in br["parts_ms"].items())
        + f"; host clock {br['step_ms']:.3f} ms a step, the first (cold allocator) {br['first_step_ms']:.3f} ms; "
        f"device busy share over two profiled steps {busy}")


def qaoa_n24() -> None:
    """QAOA at n = 24, p = 2 on a seeded random 3-regular graph: the
    expected cut rises, the ratio lies in (0, 1], best_cut is the cut of
    best_bitstring (counted from the edges) and at most the optimal cut."""
    import numpy as np
    import torch

    from quantumcomputer_tpu_torch.algorithms import variational as var

    n = VAR_N
    edges = random_regular_edges(n, QAOA_DEGREE, np.random.default_rng(QAOA_SEED))
    t0 = time.perf_counter()
    var.maxcut_cost_vector(n, edges)
    cost_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = var.qaoa_maxcut(n, edges, p=QAOA_P, steps=VAR_STEPS, learning_rate=VAR_LR, seed=0, device=DEVICE)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cut = sum(((res.best_bitstring >> a) ^ (res.best_bitstring >> b)) & 1 for a, b in edges)
    log(f"qaoa n={n} p={QAOA_P} on a random {QAOA_DEGREE}-regular graph ({len(edges)} edges): {VAR_STEPS} steps in "
        f"{seconds:.3f} s ({seconds / VAR_STEPS * 1e3:.3f} ms a step, host clock over the call: the card route builds its "
        f"cost table on the card; the CPU route's host-built cost vector would take {cost_s:.3f} s); expected cut {res.expectations[0]:.6f} -> {res.expectations[-1]:.6f}, final "
        f"{res.expected_cut:.6f}; optimal {res.optimal_cut:g}, ratio {res.approximation_ratio:.6f}; best bitstring "
        f"{res.best_bitstring} cuts {res.best_cut:g} (counted {cut}); peak memory {peak:.3f} GiB")
    check(len(edges) == n * QAOA_DEGREE // 2, f"qaoa graph has {len(edges)} edges")
    check(res.expectations[-1] > res.expectations[0], "qaoa expected cut did not rise")
    check(0.0 < res.approximation_ratio <= 1.0, f"qaoa ratio {res.approximation_ratio}")
    check(res.best_cut == cut <= res.optimal_cut, f"qaoa best cut {res.best_cut}, counted {cut}, optimal {res.optimal_cut}")


def phase_variational(report: dict) -> None:
    """The variational layer on the card (PERF.md section 4): the engine's
    gradient on the n = 28 flagship in prof_grad's four FORMS,
    expectation_on_engine at n = 28, VQE and QAOA at n = 24."""
    import torch

    from quantumcomputer_tpu_torch.scripts import prof_grad

    t_phase = time.perf_counter()
    for form in prof_grad.FORMS:
        t0 = time.perf_counter()
        grad_flagship(report, form)
        torch.cuda.empty_cache()
        log(f"gradient {form[0]}: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    expectation_engine_n28()
    log(f"expectation_on_engine n={ALGO_N}: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    vqe_n24()
    torch.cuda.empty_cache()
    log(f"vqe n={VAR_N}: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    qaoa_n24()
    torch.cuda.empty_cache()
    log(f"qaoa n={VAR_N}: {time.perf_counter() - t0:.3f} s")
    log(f"phase variational: {time.perf_counter() - t_phase:.3f} s")


# ---------------------------------------------------------------------------
# Phase 15: the sharded engine on a mesh of SHARDS shards on the one card.

SHARDS = 4  # shards on cuda:0 (d = 2)
SHARDED_C128 = (8191, 3, 11, 13)  # C, a, L, M: n = 24
SHARDED_C128_TOL = 1e-12  # max abs, sharded against the single card (tests/test_sharded.py's bound)
SHARDED_N32 = (8191, 3, 19, 13)  # n = 32, complex32 m_high: a 16 GiB state
N32_SHOTS, N32_SEED = 8, 32
# The n = 32 run's peak: the 16 GiB state, one more state for a ladder's
# out-of-place result and chunk temporaries (PERF.md section 6).
N32_PEAK_GIB = 40.0
# The sharded complex64 M = 30 attempt's depth: 12 of the factorization's 45
# steps (the time phase 16 needs, within the script's limit), held against
# the single card at the same depth; the complex32 one factors at the full
# depth, as phases 7 and 11 do on the single card.
SHARDED_SC_L = 12


def sharded_mesh():
    import torch

    from quantumcomputer_tpu_torch.parallel.mesh import build_mesh

    return build_mesh(devices=[torch.device(DEVICE, 0)] * SHARDS)


def sharded_entry_ms(eng, circuit) -> dict:
    """One run of the sharded plan entry by entry, each timed with CUDA
    events: ms and count of the fused segments (every shard's launch), of
    the entries that exchange (bytes from the transport) and of the other
    gates; and the exchanged bytes."""
    import torch

    from quantumcomputer_tpu_torch.parallel.sharded import apply_plan_sharded_

    out = {"fused": [0.0, 0], "exchange": [0.0, 0], "other": [0.0, 0]}
    state = eng.initial_state()
    eng.comm.reset()
    for entry in eng.plan(circuit):
        before = eng.comm.total_bytes()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        apply_plan_sharded_(state, [entry], n=eng.register.n, M=eng.m_eff, d=eng.d, comm=eng.comm, backend=eng.backend)
        end.record()
        end.synchronize()
        kind = "fused" if entry[0] == "fused" else "exchange" if eng.comm.total_bytes() > before else "other"
        out[kind][0] += start.elapsed_time(end)
        out[kind][1] += 1
    del state
    return {**{k: {"ms": v[0], "entries": v[1]} for k, v in out.items()}, "bytes": eng.comm.total_bytes()}


def shard_hashes(state, local) -> dict:
    """sha256 of each of this process's shards' bytes, by shard."""
    import hashlib

    import torch

    return {k: hashlib.sha256(state[k].contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
            for k in local}


def local_oracles(eng, plan) -> int:
    """The standard-layout oracle gates of a sharded plan whose control is
    shard-local: each shard runs each as its one-op camodc segment."""
    return sum(e[0] == "gate" and e[1].name == "camodc" and e[1].qubits[0] < eng.n_local for e in plan)


def sharded_flagship(report: dict, mesh, layout: str, planes, refs: dict) -> None:
    """The n = 28 flagship on the mesh against the single-card state.  For
    the forms the process mesh runs (PROCESS_FORMS), the run's shard hashes,
    counters, plan segments, norm and measured index go into `refs`."""
    import torch

    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh
    from quantumcomputer_tpu_torch.ops import fused
    from quantumcomputer_tpu_torch.parallel.sharded import ShardedStateVectorEngine
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    C, a, L, M = FLAGSHIP
    circuit = (shor_circuit_mhigh if layout == "m_high" else shor_circuit)(C, a, L, M)
    reg, dtype = Register(L=L, M=M), engine_dtype(planes)
    single = StateVectorEngine(reg, dtype, backend=KERNEL_BACKEND, layout=layout)
    single_ms = time_ms(lambda: single.run(circuit), reps=3)
    want = single.run(circuit)
    eng = ShardedStateVectorEngine(reg, dtype, mesh=mesh, backend=KERNEL_BACKEND, layout=layout)
    plan = eng.plan(circuit)
    segments, oracles = sum(e[0] == "fused" for e in plan), local_oracles(eng, plan)
    reset_launches()
    eng.comm.reset()
    state = eng.run(circuit)
    torch.cuda.synchronize()
    counts, sent = launches(), eng.comm.total_bytes()
    stats = eng.comm.world_stats()
    got = torch.cat(state, dim=1)
    dist = float(torch.linalg.vector_norm(got.float() - want.float()))
    norm = eng.norm(state)
    if (layout, dname(engine_dtype(planes))) in PROCESS_FORMS:
        refs[(layout, dname(engine_dtype(planes)))] = {
            "hashes": shard_hashes(state, range(mesh.size)), "stats": stats, "segments": segments,
            "oracles": oracles, "norm": norm,
            "index": eng.measure(state, PROCESS_DRAW)[0],
        }
    del state, got, want
    tol = FLAGSHIP_TOL if planes == torch.float32 else C32_DIST_TOL
    entry = report[key("fused_segment", planes)]
    entry.setdefault("sharded_launches", {})[f"n28 {layout}"] = counts["fused_segment"]
    if counts["matmul"]:
        report[key("fused_matmul", planes)].setdefault("sharded_launches", {})[f"n28 {layout}"] = counts["matmul"]
    sharded_ms = time_ms(lambda: eng.run(circuit), reps=3)
    if (layout, dname(engine_dtype(planes))) in refs:
        refs[(layout, dname(engine_dtype(planes)))]["ms"] = sharded_ms
    parts = sharded_entry_ms(eng, circuit)
    gates = [e[1].name for e in plan if e[0] == "gate"]
    log(
        f"sharded flagship n={L + M} {layout} {dname(planes)} on {mesh.size} shards: {sharded_ms:.3f} ms "
        f"(single card {single_ms:.3f} ms); ||sharded - single||_2 = {dist:.3e} (tol {tol:.0e}), norm {norm:.9f}; "
        f"plan {segments} fused segments a shard + {len(gates)} gates {sorted(set(gates))}; launches {counts} "
        f"(fused {counts['fused_segment']} = {mesh.size} x ({segments} + {oracles} local oracles)); exchanges {sent} "
        f"bytes; entry by entry "
        f"{json.dumps(parts)}"
    )
    check(dist <= tol, f"sharded flagship {layout} {dname(planes)}: distance {dist}")
    check(abs(norm - 1.0) <= (FLAGSHIP_TOL if planes == torch.float32 else C32_NORM_TOL), f"sharded norm {norm}")
    check(counts["fused_segment"] == mesh.size * (segments + oracles) and counts["permute"] == mesh.size * oracles,
          f"fused launches {counts['fused_segment']} (permute {counts['permute']}) != {mesh.size} x "
          f"({segments} local segments + {oracles} local oracles, one-op segments)")
    check(sent > 0, "the sharded flagship exchanged nothing")
    if planes == torch.bfloat16 and layout == "m_high":  # the standard plan's ops all lie above bit 12
        check(counts["matmul"] > 0, "the complex32 m_high sharded flagship launched no matrix group")
    torch.cuda.empty_cache()


def sharded_c128(mesh, layout: str) -> None:
    import torch

    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh
    from quantumcomputer_tpu_torch.parallel.sharded import ShardedStateVectorEngine
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    C, a, L, M = SHARDED_C128
    circuit = (shor_circuit_mhigh if layout == "m_high" else shor_circuit)(C, a, L, M)
    reg = Register(L=L, M=M)
    want = StateVectorEngine(reg, torch.complex128, backend=KERNEL_BACKEND, layout=layout).run(circuit)
    eng = ShardedStateVectorEngine(reg, torch.complex128, mesh=mesh, backend=KERNEL_BACKEND, layout=layout)
    reset_launches()
    got = torch.cat(eng.run(circuit), dim=1)
    err = float((got - want).abs().max())
    log(f"sharded complex128 n={L + M} {layout}: max abs vs single card {err:.3e} (tol {SHARDED_C128_TOL:.0e}), "
        f"||d||_2 {float(torch.linalg.vector_norm(got - want)):.3e}; launches {launches()['fused_segment']}")
    check(err <= SHARDED_C128_TOL, f"sharded complex128 {layout}: {err}")
    check(launches()["fused_segment"] > 0, "the complex128 sharded run launched no fused segment")


def sharded_factor(report: dict, mesh, layout: str, planes) -> None:
    from quantumcomputer_tpu_torch.algorithms.shor import shors_algorithm

    C, a, L, M = FACTOR
    reset_launches()
    t0 = time.perf_counter()
    result = shors_algorithm(C, L, M, forced_trial_int=a, seed=0, dtype=engine_dtype(planes), backend=KERNEL_BACKEND,
                             max_attempts_per_a=4, mesh=mesh, layout=layout)
    wall = time.perf_counter() - t0
    counts = launches()
    report[key("block_sums", planes)].setdefault("sharded_launches", {})[f"n30 {layout}"] = counts["block_sums"]
    report[key("fused_segment", planes)].setdefault("sharded_launches", {})[f"n30 {layout}"] = counts["fused_segment"]
    log(f"sharded factor n={L + M} C={C} a={a} {layout} {dname(planes)}: {result.outcome.value}, factors "
        f"{result.factors}, period {result.period}; attempts {[round(at.elapsed_s, 6) for at in result.attempts]} s, "
        f"total {wall:.3f} s; launches {counts}")
    check(result.factors == (2729, 3), f"sharded factors {result.factors} != (2729, 3)")
    check(counts["fused_segment"] > 0 and counts["block_sums"] > 0, f"sharded n=30 launches {counts}")


def sharded_n32(report: dict, mesh) -> None:
    """n = 32 at complex32 in the m_high layout: a state no single card of
    the port holds; its norm, peak memory and 8 shots whose composed
    indices must reach past 2^31 exactly."""
    import torch

    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit_mhigh
    from quantumcomputer_tpu_torch.parallel.sharded import ShardedStateVectorEngine
    from quantumcomputer_tpu_torch.sim.engine import Register

    C, a, L, M = SHARDED_N32
    n = L + M
    circuit = shor_circuit_mhigh(C, a, L, M)
    eng = ShardedStateVectorEngine(Register(L=L, M=M), "complex32", mesh=mesh, backend=KERNEL_BACKEND, layout="m_high")
    plan = eng.plan(circuit)
    gates = [e[1].name for e in plan if e[0] == "gate"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    eng.comm.reset()
    t0 = time.perf_counter()
    state = eng.run(circuit)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, sent = launches(), eng.comm.total_bytes()
    norm = eng.norm(state)
    rs = torch.rand((N32_SHOTS,), generator=torch.Generator().manual_seed(N32_SEED), dtype=torch.float32)
    shots = eng.sample(state, rs).tolist()
    counts["block_sums"] = launches()["block_sums"]  # the sample's, one a shard
    peak = torch.cuda.max_memory_allocated() / 2**30
    probs = []
    for idx in shots:
        dev, loc = divmod(idx, eng.shard_len)
        probs.append(float(state[dev][:, loc].float().square().sum()))
    high = sum(idx >= 1 << 31 for idx in shots)
    report[key("fused_segment", torch.bfloat16)].setdefault("sharded_launches", {})["n32 m_high"] = counts["fused_segment"]
    report[key("fused_matmul", torch.bfloat16)].setdefault("sharded_launches", {})["n32 m_high"] = counts["matmul"]
    report[key("block_sums", torch.bfloat16)].setdefault("sharded_launches", {})["n32 m_high"] = counts["block_sums"]
    log(f"sharded n={n} complex32 m_high on {mesh.size} shards: run {wall:.3f} s, norm {norm:.6f} (tol {C32_NORM_TOL:.0e}), "
        f"peak memory {peak:.3f} GiB (reckoning <= {N32_PEAK_GIB:.0f}); plan {sum(e[0] == 'fused' for e in plan)} "
        f"fused segments a shard, gates {[(g, gates.count(g)) for g in sorted(set(gates))]}; exchanges {sent} bytes; "
        f"launches {counts}")
    log(f"sharded n={n} shots {shots} (>= 2^31: {high}), logical {[eng.logical_index(i) for i in shots]}, "
        f"|amp|^2 {probs}")
    check(abs(norm - 1.0) <= C32_NORM_TOL, f"n=32 norm {norm}")
    check(peak <= N32_PEAK_GIB, f"n=32 peak memory {peak:.3f} GiB above {N32_PEAK_GIB} GiB")
    check(all(0 <= i < 1 << n for i in shots), f"n=32 shots out of range {shots}")
    check(all(p > 0.0 for p in probs), f"n=32 shot on a zero amplitude: {probs}")
    check(counts["fused_segment"] > 0 and counts["matmul"] > 0 and counts["block_sums"] > 0, f"n=32 launches {counts}")
    del state
    torch.cuda.empty_cache()


def sharded_semiclassical(mesh, planes, reference=None) -> None:
    """1,060,314,373 at M = 30 with the work register over the mesh,
    through shors_algorithm(semiclassical=True, mesh=...), 0 overflow.
    With `reference` (the single card's attempt of phase 11 on the same
    draws, seed SC_SEED) at the full depth: the same bits and the factors.
    Without: at a depth of SHARDED_SC_L steps, the bits of the single
    card's attempt at that depth."""
    import torch

    from quantumcomputer_tpu_torch.algorithms.shor import shors_algorithm

    C, a, L, M = SC_FACTOR
    kwargs = dict(forced_trial_int=a, seed=SC_SEED, dtype=engine_dtype(planes), backend=KERNEL_BACKEND,
                  semiclassical=True)
    if reference is None:
        L = SHARDED_SC_L
        reference = shors_algorithm(C, L, M, **kwargs).attempts[0].semiclassical
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = shors_algorithm(C, L, M, mesh=mesh, **kwargs)
    wall = time.perf_counter() - t0
    attempt = result.attempts[0]
    rec = attempt.semiclassical
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"sharded semiclassical M={M} C={C} a={a} L={L} {dname(planes)} on {mesh.size} shards: "
        f"{result.outcome.value}, factors {result.factors}; attempt {attempt.elapsed_s:.3f} s "
        f"({attempt.elapsed_s / L * 1e3:.3f} ms a step), total {wall:.3f} s; capacity {rec.capacity} slots a bin "
        f"({mesh.size} bins a shard), overflow {rec.overflow}; peak memory {peak:.3f} GiB; bits {rec.bits}, equal to "
        f"the single card's: {rec.bits == reference.bits}")
    log(f"sharded semiclassical {dname(planes)} exchange bytes by step {rec.exchange_bytes}")
    check(rec.bits == reference.bits, f"sharded bits {rec.bits} != single-card bits {reference.bits}")
    if L == SC_FACTOR[2]:
        check(result.factors == SC_FACTORS, f"sharded semiclassical factors {result.factors}")
    check(rec.overflow == 0, f"overflow {rec.overflow}")
    torch.cuda.empty_cache()


def phase_sharded(report: dict, sc32) -> dict:
    """The sharded engine (parallel/sharded.py, sharded_semiclassical.py)
    on SHARDS shards of the one card (PERF.md section 4); `sc32` is phase
    11's complex32 attempt record.  Returns the references of the process
    mesh's runs (sharded_flagship)."""
    import torch

    t_phase = time.perf_counter()
    mesh = sharded_mesh()
    log(f"phase sharded: mesh {mesh}")
    refs: dict = {}
    for planes in (torch.float32, torch.bfloat16):
        for layout in ("standard", "m_high"):
            sharded_flagship(report, mesh, layout, planes, refs)
    for layout in ("standard", "m_high"):
        sharded_c128(mesh, layout)
    for planes in (torch.float32, torch.bfloat16):
        for layout in ("standard", "m_high"):
            sharded_factor(report, mesh, layout, planes)
    torch.cuda.empty_cache()
    sharded_n32(report, mesh)
    sharded_semiclassical(mesh, torch.float32)
    sharded_semiclassical(mesh, torch.bfloat16, reference=sc32)
    log(f"phase sharded: {time.perf_counter() - t_phase:.3f} s")
    return refs


# ---------------------------------------------------------------------------
# Phase 16: the mesh across processes, on the one card.

# The n = 28 flagship forms the process mesh runs: (layout, dtype name).
PROCESS_FORMS = (("m_high", "complex64"), ("m_high", "complex32"), ("standard", "complex64"))
PROCESS_DRAW = 0.37  # the measurement's draw, in phase 15 and in every worker
# The semiclassical attempt across processes: C = 2^24 - 3, a, L, M.  M = 24,
# not the M = 30 of phase 15, whose all_to_all moves 12 GiB a step.
PROCESS_SC = (16777213, 7, 12, 24)
PROCESS_SC_SEED = 24
PROCESS_PROBE_BYTES = 1 << 28  # the transfer probe's message (256 MiB)
PROCESS_GLOO_TIMEOUT_S = 300
PROCESS_GROUP_TIMEOUT_S = 420


def transfer_probe(rank: int) -> dict:
    """GB/s of one PROCESS_PROBE_BYTES copy device -> pinned host and back,
    and of one gloo message each way between the two processes at once
    (the second of two tries each), host clock."""
    import torch
    import torch.distributed as dist

    dev = torch.cuda.current_device()
    x = torch.ones(PROCESS_PROBE_BYTES // 4, dtype=torch.float32, device=dev)
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    rates = {}
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host.copy_(x, non_blocking=True)
        torch.cuda.synchronize()
        rates["d2h_gbps"] = PROCESS_PROBE_BYTES / (time.perf_counter() - t0) / 1e9
        t0 = time.perf_counter()
        x.copy_(host, non_blocking=True)
        torch.cuda.synchronize()
        rates["h2d_gbps"] = PROCESS_PROBE_BYTES / (time.perf_counter() - t0) / 1e9
        back = torch.empty_like(host)
        peer = 1 - rank
        dist.barrier()
        t0 = time.perf_counter()
        for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, host, peer), dist.P2POp(dist.irecv, back, peer)]):
            work.wait()
        rates["gloo_gbps"] = PROCESS_PROBE_BYTES / (time.perf_counter() - t0) / 1e9
    return rates


def process_flagship(mesh, layout: str, dtype_name: str) -> dict:
    """One form of the n = 28 flagship on this process's share of the world
    mesh: one run, counted (launches, counters, hashes, norm, the measured
    index) and timed (host clock; the process's first run of a state size
    also allocates its pinned host buffers), and the peak memory."""
    import torch

    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh
    from quantumcomputer_tpu_torch.parallel.sharded import ShardedStateVectorEngine
    from quantumcomputer_tpu_torch.sim.engine import Register

    C, a, L, M = FLAGSHIP
    circuit = (shor_circuit_mhigh if layout == "m_high" else shor_circuit)(C, a, L, M)
    dtype = "complex32" if dtype_name == "complex32" else torch.complex64
    eng = ShardedStateVectorEngine(Register(L=L, M=M), dtype, mesh=mesh, backend=KERNEL_BACKEND, layout=layout)
    segments, oracles = sum(e[0] == "fused" for e in eng.plan(circuit)), local_oracles(eng, eng.plan(circuit))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    eng.comm.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = eng.run(circuit)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launches()
    stats = {kind: dict(v) for kind, v in eng.comm.stats.items()}
    hashes = shard_hashes(state, mesh.local)
    norm = eng.norm(state)
    reset_launches()
    index = eng.measure(state, PROCESS_DRAW)[0]
    measure_sums = launches()["block_sums"]
    del state
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    return {"layout": layout, "dtype": dtype_name, "segments": segments, "oracles": oracles, "launches": counts,
            "stats": stats,
            "hashes": hashes, "norm": norm, "index": index, "measure_block_sums": measure_sums, "run_s": run_s,
            "peak_gib": peak}


def process_semiclassical(mesh) -> dict:
    import torch

    from quantumcomputer_tpu_torch.parallel.sharded_semiclassical import run_semiclassical_sharded

    C, a, L, M = PROCESS_SC
    rs = torch.rand((L,), generator=torch.Generator().manual_seed(PROCESS_SC_SEED), dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = run_semiclassical_sharded(C, a, L, M, rs, mesh, dtype=torch.complex64)
    torch.cuda.synchronize()
    return {"bits": rec.bits, "probs": [float(p) for p in rec.branch_probs], "exchange_bytes": rec.exchange_bytes,
            "capacity": rec.capacity, "overflow": rec.overflow, "s": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def mesh_worker(job: dict) -> int:
    """One process of the mesh (python3 chip_smoke.py --mesh-worker JOB):
    join the gloo group, build the world mesh of job["shards"] shards of
    cuda:0 a process, run the job's forms, print one MESH_RESULT line."""
    import torch

    from quantumcomputer_tpu_torch.ops import _build
    from quantumcomputer_tpu_torch.parallel import launch
    from quantumcomputer_tpu_torch.parallel.mesh import build_mesh

    prebuilt = os.path.exists(_build.library_path())
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    launch.join(job["store"], job["rank"], job["world"], timeout_s=PROCESS_GLOO_TIMEOUT_S)
    mesh = build_mesh(devices=[torch.device(DEVICE, 0)] * job["shards"])
    _build.load()
    out = {"rank": job["rank"], "library_prebuilt": prebuilt, "join_s": time.perf_counter() - t0,
           "local": list(mesh.local), "owners": [s.process_index for s in mesh.slots]}
    if job.get("probe"):
        out["probe"] = transfer_probe(job["rank"])
    out["forms"] = [process_flagship(mesh, layout, dtype) for layout, dtype in job["forms"]]
    if job.get("semiclassical"):
        out["semiclassical"] = process_semiclassical(mesh)
    launch.leave()
    print("MESH_RESULT " + json.dumps(out), flush=True)
    return 0


def run_mesh_group(world: int, shards: int, **job) -> list:
    """Start `world` workers of `shards` shards each and return their
    MESH_RESULT records, rank by rank; a worker that fails or outlasts
    PROCESS_GROUP_TIMEOUT_S fails the phase (its log's end is printed)."""
    import tempfile

    from quantumcomputer_tpu_torch.parallel import launch

    with tempfile.TemporaryDirectory(prefix="mesh_group_") as tmp:
        store = os.path.join(tmp, "store")
        commands = [[sys.executable, os.path.abspath(__file__), "--mesh-worker",
                     json.dumps({**job, "world": world, "shards": shards, "rank": r, "store": store})]
                    for r in range(world)]
        t0 = time.perf_counter()
        ran = launch.run(commands, [os.path.join(tmp, f"worker{r}.log") for r in range(world)],
                         timeout_s=PROCESS_GROUP_TIMEOUT_S)
        wall = time.perf_counter() - t0
    results = []
    for r, (rc, out) in enumerate(ran):
        lines = [ln for ln in out.splitlines() if ln.startswith("MESH_RESULT ")]
        if rc != 0 or len(lines) != 1:
            log(f"process mesh {world}x{shards}: worker {r} exited {rc}; its output ends:\n{out[-6000:]}")
        check(rc == 0 and len(lines) == 1, f"process mesh {world}x{shards}: worker {r} failed (exit {rc})")
        results.append(json.loads(lines[0][len("MESH_RESULT "):]))
    log(f"process mesh {world}x{shards}: {world} workers ran in {wall:.3f} s (join {[round(x['join_s'], 3) for x in results]} s)")
    return results


def check_process_form(report: dict, results: list, ref: dict, group: str) -> None:
    """Every rank's run of one form against the one-process 4-shard run of
    phase 15: hash-equal shards, the same index and norm, counters (calls
    on each rank, bytes summed) equal, fused launches = local shards x the
    local plan's segments and local oracle gates (their one-op segments)."""
    import torch

    layout, dtype = ref["form"]
    runs = [next(f for f in r["forms"] if (f["layout"], f["dtype"]) == (layout, dtype)) for r in results]
    hashes = {int(k): v for run in runs for k, v in run["hashes"].items()}
    planes = torch.bfloat16 if dtype == "complex32" else torch.float32
    crossing = sum(v["crossing"] for run in runs for v in run["stats"].values())
    counted = sum(v["bytes"] for run in runs for v in run["stats"].values())
    log(f"process mesh {group} n=28 {layout} {dtype}: run {[round(run['run_s'], 3) for run in runs]} s a process "
        f"(one-process 4 shards {ref['ms']:.3f} ms); "
        f"bytes crossing processes {crossing} ({crossing / 2**30:.3f} GiB), counted {counted} "
        f"(one process: {sum(v['bytes'] for v in ref['stats'].values())}); peak "
        f"{[round(run['peak_gib'], 3) for run in runs]} GiB a process; index {[run['index'] for run in runs]} "
        f"(one process {ref['index']}); norm {runs[0]['norm']:.9f}; fused launches "
        f"{[run['launches']['fused_segment'] for run in runs]} ({ref['segments']} segments a shard); "
        f"hash-equal {hashes == ref['hashes']}; sha256 by shard {json.dumps(hashes, sort_keys=True)}")
    check(hashes == ref["hashes"], f"process mesh {group} {layout} {dtype}: shard hashes differ from the one-process run")
    check(all(run["index"] == ref["index"] for run in runs), f"process mesh {group} {layout} {dtype}: indices differ")
    check(all(run["norm"] == ref["norm"] for run in runs), f"process mesh {group} {layout} {dtype}: norms differ")
    for kind, want in ref["stats"].items():
        check(all(run["stats"][kind]["count"] == want["count"] for run in runs), f"{group} {kind} calls differ")
        check(sum(run["stats"][kind]["bytes"] for run in runs) == want["bytes"],
              f"process mesh {group} {layout} {dtype}: {kind} bytes summed over the processes != the one-process run's")
    check(crossing > 0, f"process mesh {group} {layout} {dtype}: no byte crossed processes")
    for r, run in zip(results, runs):
        check(run["segments"] == ref["segments"], f"process mesh {group}: plan segments {run['segments']} != {ref['segments']}")
        check(run["oracles"] == ref["oracles"], f"process mesh {group}: local oracles {run['oracles']} != {ref['oracles']}")
        check(run["launches"]["fused_segment"] == len(r["local"]) * (ref["segments"] + ref["oracles"]) > 0
              and run["launches"]["permute"] == len(r["local"]) * ref["oracles"],
              f"process mesh {group} rank {r['rank']}: fused launches {run['launches']['fused_segment']} (permute "
              f"{run['launches']['permute']}) != {len(r['local'])} x ({ref['segments']} + {ref['oracles']})")
        check(run["measure_block_sums"] >= len(r["local"]), f"process mesh {group}: the measure launched no block sums")
        if (layout, dtype) == ("m_high", "complex32"):
            check(run["launches"]["matmul"] > 0, f"process mesh {group}: no matrix group launched")
    per_process = {"fused_segment": [run["launches"]["fused_segment"] for run in runs],
                   "block_sums": [run["measure_block_sums"] for run in runs]}
    if (layout, dtype) == ("m_high", "complex32"):
        per_process["fused_matmul"] = [run["launches"]["matmul"] for run in runs]
    for name, counts in per_process.items():
        report[key(name, planes)].setdefault("process_launches", {})[f"n28 {layout} {group}"] = counts


def phase_process_mesh(report: dict, refs: dict) -> None:
    """The mesh across processes (parallel/comm.ProcessTransport over gloo,
    CUDA operands staged through pinned host memory) on the one card:
    2 processes x 2 shards and 4 x 1, against phase 15's one-process runs."""
    import numpy as np
    import torch

    from quantumcomputer_tpu_torch.parallel.sharded_semiclassical import run_semiclassical_sharded

    t_phase = time.perf_counter()
    C, a, L, M = PROCESS_SC
    rs = torch.rand((L,), generator=torch.Generator().manual_seed(PROCESS_SC_SEED), dtype=torch.float32)
    t0 = time.perf_counter()
    sc_ref = run_semiclassical_sharded(C, a, L, M, rs, sharded_mesh(), dtype=torch.complex64)
    torch.cuda.synchronize()
    sc_ref_s = time.perf_counter() - t0
    for form, ref in refs.items():
        ref["form"] = form
    torch.cuda.empty_cache()  # the workers share the card

    results = run_mesh_group(2, 2, forms=PROCESS_FORMS, probe=True, semiclassical=True)
    for r in results:
        check(r["library_prebuilt"], f"worker {r['rank']} found no built library")
        check(r["owners"] == [0, 0, 1, 1] and r["local"] == [2 * r["rank"], 2 * r["rank"] + 1],
              f"worker {r['rank']}: mesh not process-major: {r['owners']}")
        log(f"process mesh 2x2 rank {r['rank']} transfers of {PROCESS_PROBE_BYTES} bytes: {json.dumps(r['probe'])}")
    for form in PROCESS_FORMS:
        check_process_form(report, results, refs[form], "2x2")
    sc = [r["semiclassical"] for r in results]
    cap = sc[0]["capacity"]
    crossing = 8 * 2 * cap * 4  # a step: the 8 (sender, receiver) pairs across processes, (2, cap) float32 slots each
    log(f"process mesh 2x2 semiclassical M={M} C={C} a={a} L={L}: {[round(x['s'], 3) for x in sc]} s "
        f"(one process 4 shards {sc_ref_s:.3f} s); capacity {cap}, crossing {crossing} bytes a step with an exchange; "
        f"exchange bytes summed {np.sum([x['exchange_bytes'] for x in sc], axis=0).tolist() == sc_ref.exchange_bytes}; "
        f"peak {[round(x['peak_gib'], 3) for x in sc]} GiB; bits {sc[0]['bits']}")
    check(all(x["bits"] == sc_ref.bits and x["probs"] == [float(p) for p in sc_ref.branch_probs] for x in sc),
          "process mesh semiclassical: bits or probabilities differ from the one-process attempt")
    check(all(x["overflow"] == 0 for x in sc), "process mesh semiclassical: overflow")
    check(np.sum([x["exchange_bytes"] for x in sc], axis=0).tolist() == sc_ref.exchange_bytes,
          "process mesh semiclassical: exchange bytes summed over the processes != the one-process attempt's")

    results = run_mesh_group(4, 1, forms=(("m_high", "complex32"),))
    for r in results:
        check(r["owners"] == [0, 1, 2, 3] and r["local"] == [r["rank"]], f"worker {r['rank']}: mesh {r['owners']}")
    check_process_form(report, results, refs[("m_high", "complex32")], "4x1")
    log(f"phase process mesh: {time.perf_counter() - t_phase:.3f} s")


OFFSET_REPLACES = ("none: one pass a leg, fusing the passes of quantumcomputer_tpu/ops/pallas_transpose.py:36 and "
                   "pallas_chunkgather.py:79 that the JAX package's legs make")
# The old legs' kernels: no path launches them (the main path's counts, 0,
# are their entries' launches); phase 6 holds them against their plain
# versions.
OFF_PATH = "null: off every path since the offset transpose"


def new_report() -> dict:
    """One JSON entry per kernel instance: the float32 / float64 kernels,
    then the bf16 ("complex32") instances, whose `replaces` names the TPU
    kernel's bf16 lines."""
    no_call = "null: no single PyTorch call "
    camodc_library = "torch.index_select of each camodc op's control-1 half along the work register, summed (out of place)"
    matmul_library = ("torch.matmul of the complex64 state's (2^(n-7), 128) view by each lanemat table and of each "
                      "rowmat's V by its (2^(n-13), 64, 128) view, summed (out of place)")
    rows = (
        ("fused_segment", "fused_segment.cu", "pallas_fused.py:1002", no_call + "applies a segment of gates"),
        ("camodc", "camodc_permute.cu", "pallas_fused.py:967", camodc_library),
        ("block_sums", "block_sums.cu", "pallas_measure.py:66", None),
        ("ladder", "oracle_ladder.cu", "pallas_oracle.py:101", None),
        ("cycle", "oracle_cycle.cu", "pallas_oracle.py:274", None),
        ("cycle_masked", "oracle_cycle.cu", "pallas_oracle.py:531", None),
        ("offset_transpose", "transpose.cu", OFFSET_REPLACES, "x.index_select(1, idx) of the plane by the whole permutation"),
        ("transpose", "transpose.cu", "pallas_transpose.py:36", OFF_PATH),
        ("chunk_gather", "chunk_gather.cu", "pallas_chunkgather.py:79", OFF_PATH),
        ("oracle_gather", "oracle_gather.cu", "pallas_oracle.py:47", None),
        ("probe_copy", "probes.cu", "scripts/prof_chunkgather.py:86", None),
        ("probe_roll2", "probes.cu", "scripts/prof_chunkgather.py:99", None),
        ("probe_mxuroll", "probes.cu", "scripts/prof_chunkgather.py:120", None),
        ("probe_dynroll", "probes.cu", "scripts/prof_rowperm.py:158", None),
        ("probe_rowroll", "probes.cu", "scripts/prof_rowperm.py:186", None),
        # The bf16 instances, on the complex32 paths.
        ("fused_segment_bf16", "fused_segment.cu", "pallas_fused.py:1010-1025", no_call + "applies a segment of gates"),
        ("camodc_bf16", "camodc_permute.cu", "pallas_fused.py:1089-1091", camodc_library),
        ("block_sums_bf16", "block_sums.cu", "pallas_measure.py:60-63", None),
        ("ladder_bf16", "oracle_ladder.cu", "pallas_oracle.py:147-163", None),
        ("cycle_bf16", "oracle_cycle.cu", "pallas_oracle.py:389-392", None),
        ("cycle_masked_bf16", "oracle_cycle.cu", "pallas_oracle.py:431-449", None),
        ("offset_transpose_bf16", "transpose.cu", OFFSET_REPLACES, "x.index_select(1, idx) of the plane by the whole permutation"),
        ("transpose_bf16", "transpose.cu", "pallas_transpose.py:36", OFF_PATH),
        ("chunk_gather_bf16", "chunk_gather.cu", "pallas_chunkgather.py:211-239", OFF_PATH),
        # The matrix groups (both instances) and the row gather at bf16.
        ("fused_matmul", "fused_matmul.cu", "pallas_fused.py:911-966", matmul_library),
        ("fused_matmul_bf16", "fused_matmul.cu", "pallas_fused.py:911-966", matmul_library),
        ("oracle_gather_bf16", "oracle_gather.cu", "pallas_oracle.py:47", None),
        # The m_high plan's oracle stage (its walks and ladder), merged into one pass.
        ("oracle_strip", "oracle_strip.cu", "pallas_oracle.py:274", None),
        ("oracle_strip_bf16", "oracle_strip.cu", "pallas_oracle.py:389-392", None),
    )
    return {
        name: {
            "name": name, "route": "cuda", "source": f"quantumcomputer_tpu_torch/ops/csrc/{source}",
            "replaces": replaces if replaces.startswith(("scripts/", "none")) else f"quantumcomputer_tpu/ops/{replaces}",
            "launches": 0, "max_abs_err": 0.0, "ms": None, "plain_ms": None,
            "bound_ms": None, "bound_by": None, "library_ms": None, "library": library,
        }
        for name, source, replaces, library in rows
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "quantumcomputer_tpu_torch")):
        print("chip_smoke: run it from a checkout that holds quantumcomputer_tpu_torch/", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    if sys.argv[1:2] == ["--mesh-worker"]:
        return mesh_worker(json.loads(sys.argv[2]))

    report = new_report()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    phase_build()
    phase_kernels(report)
    phase_matrix_kernels(report)
    phase_camodc_kernels(report)
    phase_kernel_checks()
    phase_cli()
    phase_flagship(report)
    phase_factor(report, torch.float32)
    phase_modperm_kernels(report)
    phase_semiclassical_timing(report, torch.float32)
    phase_semiclassical_cli()
    sc64 = phase_semiclassical_factor(report, torch.float32)
    phase_gather_oracle(report)
    phase_probes(report)
    phase_validation(report)
    # complex32 (bf16 planes): every path again, through the bf16 instances.
    phase_flagship_c32(report)
    phase_factor(report, torch.bfloat16)
    phase_cli_c32()
    phase_semiclassical_timing(report, torch.bfloat16)
    sc32 = phase_semiclassical_factor(report, torch.bfloat16, reference=sc64)
    phase_validation_c32(report)
    phase_checkpoint()
    phase_algorithms()
    phase_variational(report)
    refs = phase_sharded(report, sc32)
    phase_process_mesh(report, refs)

    for entry in report.values():
        if entry["library"] == OFF_PATH:
            check(entry["launches"] == 0, f"kernel {entry['name']}: off the path, yet launched {entry}")
            continue
        check(entry["launches"] > 0 and entry["ms"] is not None and entry["plain_ms"] is not None,
              f"kernel {entry['name']}: incomplete report {entry}")
        check(entry["bound_ms"] is not None and entry["bound_by"] in ("bytes", "operations"),
              f"kernel {entry['name']}: no bound {entry}")
        check(entry["library_ms"] is not None or str(entry["library"]).startswith("null"),
              f"kernel {entry['name']}: neither library_ms nor a reason {entry}")
    log(json.dumps({"kernels": list(report.values())}))
    log(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
