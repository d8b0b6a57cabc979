"""Command-line interface: the JAX package's flag surface on PyTorch.

The same flags, choices, validation messages and exit codes as
``quantumcomputer_tpu/cli.py`` (exit 2 for bad arguments, 3 when no period
is found), with ``--backend auto|torch|cuda`` in place of
``auto|xla|pallas``.  ``--semiclassical`` runs on the CUDA device with the
cuda backend and on the CPU otherwise.  ``--dtype dd64`` runs complex128,
which the card has natively; ``--strict-reference`` forces the torch
backend, as the JAX package forces xla, and runs its plain ops on the CUDA
device when one is present.  ``--dtype complex32`` (bf16 planes computed
in float32) runs the full register on the cuda backend's kernel path, as
the JAX package forces pallas: on the card when there is one, else on the
CPU through the kernels' plain versions (the JAX package's interpret mode);
the semiclassical engine runs it on the card or the CPU like any dtype.
``--checkpoint-dir`` snapshots the full-register circuit between segments
of 8 gates, or the semiclassical work state every 4 steps, and resumes a
killed run.  ``--devices N > 1`` shards the state (or the semiclassical work
register) over a mesh of N distinct devices (``parallel/mesh.build_mesh``):
the visible CUDA cards, or on a host with no card the CPU's 8 virtual
shards; more than the host has exits 2, as the JAX CLI does.  ``--backend
cuda`` on a host with no CUDA device exits 2 as well, and never runs on the
CPU.  On a CUDA card a register of 32 qubits (the reference's bound) runs
unsharded at complex64 or complex32 when the card holds its state; with no
card the JAX package's 31-qubit bound and message stand.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch

from quantumcomputer_tpu_torch.algorithms import number_theory as nt
from quantumcomputer_tpu_torch.algorithms.shor import Outcome, issue_warnings, shors_algorithm
from quantumcomputer_tpu_torch.sim.statevec import real_dtype_of
from quantumcomputer_tpu_torch.utils.logging import configure, get_logger
from quantumcomputer_tpu_torch.utils.memory import state_fits

log = get_logger("cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="quantumcomputer-tpu-torch",
        description="State-vector simulation of Shor's algorithm on PyTorch (CUDA kernels on the GPU).",
    )
    p.add_argument("-C", type=int, required=True, help="number to factorise")
    p.add_argument("-L", type=int, required=True, help="size of the L (counting) register")
    p.add_argument("-M", type=int, required=True, help="size of the M (work) register")
    p.add_argument("-a", type=int, default=0, help="forced trial integer (0 = loop over all)")
    p.add_argument("-v", action="store_true", dest="verbose", help="medium verbosity")
    p.add_argument("-V", action="store_true", dest="very_verbose", help="high verbosity")
    p.add_argument("--seed", type=int, default=None, help="RNG seed (default: wall clock)")
    p.add_argument(
        "--dtype",
        choices=["complex64", "complex128", "complex32", "dd64"],
        default="complex64",
        help=(
            "amplitude precision: complex64 (default), complex128 (f64 planes on the same device), "
            "complex32 (bf16 storage, f32 compute; cuda backend) "
            "or dd64 (the JAX package's f64-parity mode, here complex128)"
        ),
    )
    p.add_argument(
        "--backend",
        choices=["auto", "torch", "cuda"],
        default="auto",
        help="gate backend (auto: cuda when a CUDA device is present, torch elsewhere)",
    )
    p.add_argument("--devices", type=int, default=1, help="shard the state vector over this many devices")
    p.add_argument("--layout", choices=["standard", "m_high"], default="standard", help="physical qubit layout")
    p.add_argument(
        "--oracle",
        choices=["gather", "benes"],
        default="gather",
        help="modular-multiply kernel (benes: inside the fused segments' in-place pass; cuda backend)",
    )
    p.add_argument("--fractions", type=int, default=nt.NUM_CONTINUED_FRACTIONS, help="continued-fraction depth")
    p.add_argument("--trials", type=int, default=nt.TRIALS_PER_DENOMINATOR, help="multiples tried per denominator")
    p.add_argument("--semiclassical", action="store_true", help="one-control-qubit period finding")
    p.add_argument(
        "--strict-reference",
        action="store_true",
        help="reference bug-compatibility oracle (warn-and-wrap scatter when 2^M < C); forces backend=torch",
    )
    p.add_argument("--checkpoint-dir", default=None, help="snapshot the state between circuit segments")
    return p


def validate(args: argparse.Namespace) -> Optional[str]:
    """The JAX package's argument checks, in its order and with its
    messages (backend names translated: xla -> torch, pallas -> cuda)."""
    if args.C <= 3:
        return "Number to be factorised C is invalid (must be > 3)."
    if args.dtype == "dd64" and args.layout != "standard":
        return "dd64 parity mode uses the standard layout."
    if args.semiclassical and (args.layout != "standard" or args.strict_reference):
        return (
            "semiclassical mode is its own engine: no layouts or "
            "strict-reference (complex32 and dd64 ARE supported; "
            "--devices N shards the work register)."
        )
    if args.semiclassical and args.dtype == "dd64" and args.devices > 1:
        return "dd64 semiclassical is single-chip (parity mode)."
    if args.semiclassical and args.dtype == "dd64" and args.checkpoint_dir:
        return "dd64 semiclassical has no checkpointing (parity mode)."
    if args.semiclassical and args.checkpoint_dir and args.devices > 1:
        return (
            "semiclassical checkpointing is single-chip only (the sharded "
            "attempt is one fused dispatch with no step boundary)."
        )
    if args.strict_reference and (
        args.devices > 1 or args.layout != "standard" or args.backend == "cuda"
        or args.dtype in ("complex32", "dd64")
    ):
        return "strict-reference mode is single-chip, standard layout, torch backend, complex64/128."
    if args.dtype == "complex32" and args.backend == "torch" and not args.semiclassical:
        return "complex32 requires the cuda backend (no 32-bit complex dtype exists)."
    if args.L <= 0:
        return "L is invalid (must be positive)."
    if args.M <= 0:
        return "M is invalid (must be positive)."
    if args.a and not (1 < args.a < args.C - 1):
        return "Forced trial integer must satisfy 1 < a < C-1."
    if args.semiclassical:
        # The state is 2^M amplitudes whatever L is (the control qubit is
        # implicit): the L + M bounds do not apply; M, C and L have their own.
        if args.M > 30:
            return "semiclassical work register M > 30 exceeds the int32 index budget."
        if (1 << args.M) < args.C:
            return (
                f"semiclassical work register 2^M={1 << args.M} < C={args.C}: "
                "the modular-multiply gate is not unitary (M must satisfy 2^M >= C)."
            )
        if args.L > 52:
            return "semiclassical L > 52 exceeds the float64 omega mantissa (x_tilde / 2^L)."
        if args.C >= (1 << 30):
            return "semiclassical mode needs C < 2^30 (int32 shift-add modular arithmetic)."
        if args.devices > 1 and args.M - (args.devices.bit_length() - 1) < 1:
            return "semiclassical sharding needs M - log2(devices) >= 1 (no local work rows)."
        return None
    if args.L + args.M > 32:
        return "L + M > 32 qubits exceeds the index budget (the reference's own bound, qc_shor.c:68-73)."
    if args.L + args.M - (args.devices.bit_length() - 1) > 31 and args.dtype != "complex128" and not _one_card(args):
        # The JAX package's condition and message, word for word: its
        # "runs on CPU" clause describes the JAX package's complex128 mode;
        # this package runs complex128 on the card.
        return (
            "L + M > 31 qubits exceeds the int32 single-chip index budget: "
            "shard with --devices so L + M - log2(devices) <= 31 "
            "(or use --dtype complex128, which runs on CPU with 64-bit indices)."
        )
    if args.layout == "m_high" and args.devices > (1 << args.M):
        return "m_high sharding needs devices <= 2^M (global bits must fit in the work register)."
    return None


def _one_card(args: argparse.Namespace) -> bool:
    """True when the register (L + M <= 32, the reference's bound) runs
    unsharded on this host's CUDA card: complex64 or complex32 on the cuda
    backend, and a state the engine's memory rule holds there
    (utils/memory.state_fits).  The int32 bound of 31 qubits is the JAX
    package's, whose TPU holds 16 GiB; the port indexes with int64.  With no
    card the JAX package's answer stands."""
    if args.devices != 1 or args.backend == "torch" or args.strict_reference:
        return False
    if args.dtype not in ("complex64", "complex32") or not torch.cuda.is_available():
        return False
    return state_fits(args.L + args.M, real_dtype_of(args.dtype), torch.device("cuda"))


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    err = validate(args)
    if err:
        print(f"Error: {err}", file=sys.stderr)
        return 2
    backend = args.backend
    if args.strict_reference:
        backend = "torch"  # plain torch ops for exact comparison runs, as the JAX package forces xla
    if backend == "cuda" and not torch.cuda.is_available():
        print("Error: --backend cuda needs a CUDA device, and none is available.", file=sys.stderr)
        return 2

    configure(args.verbose, args.very_verbose)
    for w in issue_warnings(args.C, args.L, args.M):
        print(f" --- *WARNING* {w}")

    mesh = None
    if args.devices > 1:
        from quantumcomputer_tpu_torch.parallel.mesh import build_mesh

        try:
            mesh = build_mesh(num_devices=args.devices)
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 2
        print(f" --- Sharding state vector over {mesh.size} device(s).")

    print("\n --- Finding factors...\n")
    result = shors_algorithm(
        C=args.C,
        L=args.L,
        M=args.M,
        forced_trial_int=args.a,
        seed=args.seed,
        dtype={"complex128": torch.complex128, "dd64": "dd64", "complex32": "complex32"}.get(args.dtype, torch.complex64),
        backend=backend,
        mesh=mesh,
        num_fractions=args.fractions,
        trials_per_denominator=args.trials,
        layout=args.layout,
        oracle=args.oracle,
        strict_reference=args.strict_reference,
        semiclassical=args.semiclassical,
        checkpoint_dir=args.checkpoint_dir,
    )

    if args.verbose:
        print(f" --- Time to run Shor's Algorithm: {result.elapsed_s:.6f}s.")

    if result.outcome is Outcome.OK and result.factors:
        f0, f1 = result.factors
        print(f" --- Factors of {args.C} found: ({f0}, {f1}).")
        # Divisibility, not f0*f1 == C: with more than two prime factors the
        # gcd pair need not multiply to C but is still correct.
        if args.C % f0 != 0 or args.C % f1 != 0:
            print(" --- These factors are incorrect. Consider increasing register sizes as per the warnings.")
        elif f0 * f1 != args.C:
            print(f" --- Note: {args.C} has more than two prime factors; {args.C} = {f0} * {args.C // f0}.")
        return 0
    print(f" --- A valid period was not found and hence C = {args.C} could not be factorised.")
    return 3


if __name__ == "__main__":
    sys.exit(main())
