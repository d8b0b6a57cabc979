"""Command-line interface: the JAX package's flag surface on PyTorch.

The same flags, choices, validation messages and exit codes as
``quantumcomputer_tpu/cli.py`` (exit 2 for bad arguments, 3 when no period
is found), with ``--backend auto|torch|cuda`` in place of
``auto|xla|pallas``.  Flags whose path is not ported yet exit 2 with a
message that says so; ``--backend cuda`` on a host with no CUDA device
exits 2 as well, and never runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch

from quantumcomputer_tpu_torch.algorithms import number_theory as nt
from quantumcomputer_tpu_torch.algorithms.shor import Outcome, issue_warnings, shors_algorithm
from quantumcomputer_tpu_torch.utils.logging import configure, get_logger

log = get_logger("cli")

PACKAGE = "quantumcomputer_tpu_torch"


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
        help="amplitude precision: complex64 (default) or complex128 (f64 planes on the same device)",
    )
    p.add_argument(
        "--backend",
        choices=["auto", "torch", "cuda"],
        default="auto",
        help="gate backend (auto: cuda when a CUDA device is present, torch elsewhere)",
    )
    p.add_argument("--devices", type=int, default=1, help="shard the state vector over this many devices")
    p.add_argument("--layout", choices=["standard", "m_high"], default="standard", help="physical qubit layout")
    p.add_argument("--oracle", choices=["gather", "benes"], default="gather", help="modular-multiply kernel")
    p.add_argument("--fractions", type=int, default=nt.NUM_CONTINUED_FRACTIONS, help="continued-fraction depth")
    p.add_argument("--trials", type=int, default=nt.TRIALS_PER_DENOMINATOR, help="multiples tried per denominator")
    p.add_argument("--semiclassical", action="store_true", help="one-control-qubit period finding")
    p.add_argument("--strict-reference", action="store_true", help="reference bug-compatibility oracle")
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
    if args.strict_reference and (
        args.devices > 1 or args.layout != "standard" or args.backend == "cuda"
        or args.dtype in ("complex32", "dd64")
    ):
        return "strict-reference mode is single-chip, standard layout, torch backend, complex64/128."
    if args.L <= 0:
        return "L is invalid (must be positive)."
    if args.M <= 0:
        return "M is invalid (must be positive)."
    if args.a and not (1 < args.a < args.C - 1):
        return "Forced trial integer must satisfy 1 < a < C-1."
    if args.semiclassical:
        return None  # its state is 2^M amplitudes: the L + M bounds do not apply
    if args.L + args.M > 32:
        return "L + M > 32 qubits exceeds the index budget (the reference's own bound, qc_shor.c:68-73)."
    if args.L + args.M > 31 and args.dtype != "complex128":
        return (
            "L + M > 31 qubits exceeds the 2^31 index budget of the hierarchical "
            "sampler (use --dtype complex128, which samples with the flat scan)."
        )
    return None


def not_ported(args: argparse.Namespace) -> Optional[str]:
    """The first flag whose path this package does not carry yet, or None."""
    if args.layout == "m_high":
        return "--layout m_high"
    if args.semiclassical:
        return "--semiclassical"
    if args.devices > 1:
        return "--devices > 1"
    if args.oracle == "benes":
        return "--oracle benes"
    if args.checkpoint_dir is not None:
        return "--checkpoint-dir"
    if args.strict_reference:
        return "--strict-reference"
    if args.dtype in ("complex32", "dd64"):
        return f"--dtype {args.dtype}"
    return None


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    err = validate(args)
    if err:
        print(f"Error: {err}", file=sys.stderr)
        return 2
    missing = not_ported(args)
    if missing:
        print(f"Error: {missing} is not yet ported to {PACKAGE}.", file=sys.stderr)
        return 2
    if args.backend == "cuda" and not torch.cuda.is_available():
        print("Error: --backend cuda needs a CUDA device, and none is available.", file=sys.stderr)
        return 2

    configure(args.verbose, args.very_verbose)
    for w in issue_warnings(args.C, args.L, args.M):
        print(f" --- *WARNING* {w}")

    print("\n --- Finding factors...\n")
    result = shors_algorithm(
        C=args.C,
        L=args.L,
        M=args.M,
        forced_trial_int=args.a,
        seed=args.seed,
        dtype=torch.complex128 if args.dtype == "complex128" else torch.complex64,
        backend=args.backend,
        num_fractions=args.fractions,
        trials_per_denominator=args.trials,
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
