"""Structured logging with the reference's two-level verbosity surface.

The reference uses two globals, verbose / very_verbose, set by -v / -V
(qc_shor.c:228-229, 1202-1209).  Here they map onto standard logging
levels: -v -> INFO, -V -> DEBUG, default WARNING.
"""

from __future__ import annotations

import logging
import sys

_ROOT = "quantumcomputer_tpu_torch"
_configured = False
_verbose = False
_very_verbose = False


def configure(verbose: bool = False, very_verbose: bool = False) -> None:
    """Set the package log level from the CLI verbosity flags.  -V implies
    -v, like the reference's getopt handler (qc_shor.c:1201-1208)."""
    global _configured, _verbose, _very_verbose
    _verbose = verbose or very_verbose
    _very_verbose = very_verbose
    level = logging.WARNING
    if very_verbose:
        level = logging.DEBUG
    elif verbose:
        level = logging.INFO
    logger = logging.getLogger(_ROOT)
    logger.setLevel(level)
    if not _configured:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(" --- %(name)s: %(message)s"))
        logger.addHandler(handler)
        logger.propagate = False
        _configured = True


def verbosity() -> tuple[bool, bool]:
    """(verbose, very_verbose) — the reference's two globals
    (qc_shor.c:228-229), set by configure()."""
    return _verbose, _very_verbose


def ui_active() -> bool:
    """True once configure() has run (i.e., we're serving a CLI user).
    Messages the reference prints UNCONDITIONALLY (e.g. the trivial-factor
    notices, qc_shor.c:1052/1107) are gated on this so library callers
    don't get stdout pollution."""
    return _configured


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"{_ROOT}.{name}")
