"""Probes of the row-gather and variable-lane-rotate permutation legs on the
card.

The port of the JAX package's ``scripts/prof_rowperm.py``.  On a (2, 2^M)
float32 state with one arbitrary run start per 128-element output row:

  row-take aligned     whole-row take at the row-aligned starts
  runs take+roll7+sel  take rows floor(s/128) and +1, 7 conditional rolls, select
  runs packed roll7    the same, rolling both takes as one tensor
  runs rw=8 take       runs from 8-aligned starts through a (dim/8, 8) take
  transpose pad        (Qp, u) view padded to (8, 128) multiples, transposed
  transpose 128        (R, 128) -> (128, R)
  dynroll, rowroll     the probe kernels (ops/probes.py): a lane roll with
                       one shift per 8-row block, and with one per row

The first six are plain torch ops, as they were XLA ops in the JAX script;
each is held exactly against the same function written as one index map.
The two kernels are held against their plain versions.  Times: CUDA
events; GB/s for one read and one write of the state.

    python -m quantumcomputer_tpu_torch.scripts.prof_rowperm   # M=26
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from quantumcomputer_tpu_torch.ops import probes
from quantumcomputer_tpu_torch.scripts import probe_row

LANE = 128
U = 2582  # the JAX script's unaligned transpose width


def _roll7(t: torch.Tensor, c: torch.Tensor, bit_shape) -> torch.Tensor:
    """t[..., l] <- t[..., (l + c) mod 128] by 7 conditional fixed rolls."""
    for k in range(7):
        bit = ((c >> k) & 1).bool().view(bit_shape)
        t = torch.where(bit, torch.roll(t, -(1 << k), dims=-1), t)
    return t


def xla_rows(x: torch.Tensor, starts: torch.Tensor, reps: int, device) -> list:
    """The plain torch rows, each against its index map."""
    dim = x.shape[1]
    R = dim // LANE
    st = starts.to(torch.int64)
    lane = torch.arange(LANE, device=device)

    def by_index(make_idx):
        return lambda: x[:, make_idx().reshape(-1)]

    def rowtake():
        return x.view(2, R, LANE)[:, st // LANE].reshape(2, dim)

    def runs_roll7():
        g = x.view(2, R, LANE)[:, torch.stack([st // LANE, st // LANE + 1], 1).reshape(-1)].view(2, R, 2, LANE)
        c = st % LANE
        a = _roll7(g[:, :, 0], c, (1, R, 1))
        b = _roll7(g[:, :, 1], c, (1, R, 1))
        return torch.where(lane[None, None, :] < (LANE - c)[None, :, None], a, b).reshape(2, dim)

    def runs_roll7_packed():
        g = x.view(2, R, LANE)[:, torch.stack([st // LANE, st // LANE + 1], 1).reshape(-1)].view(2, R, 2, LANE)
        c = st % LANE
        g = _roll7(g, c, (1, R, 1, 1))
        return torch.where(lane[None, None, :] < (LANE - c)[None, :, None], g[:, :, 0], g[:, :, 1]).reshape(2, dim)

    def runs8():
        r0 = (st // 8 * 8) // 8
        idx = (r0[:, None] + torch.arange(17, device=device)[None, :]).reshape(-1)
        return x.view(2, dim // 8, 8)[:, idx].reshape(2, R, 17 * 8)[:, :, :LANE].reshape(2, dim)

    Qp = dim // U
    u_pad, Qp_pad = -(-U // LANE) * LANE, -(-Qp // 8) * 8

    def transpose_padded():
        zz = torch.nn.functional.pad(x[:, : Qp * U].view(2, Qp, U), (0, u_pad - U, 0, Qp_pad - Qp))
        return zz.transpose(1, 2).reshape(2, -1)[:, :dim]

    def transpose_padded_index():
        t = torch.arange(min(dim, u_pad * Qp_pad), device=device)
        i, j = t // Qp_pad, t % Qp_pad
        live = (i < U) & (j < Qp)
        return torch.where(live, x[:, torch.where(live, j * U + i, 0)], 0.0)

    def transposed_index():
        t = torch.arange(dim, device=device)
        return (t % R) * LANE + t // R

    cases = (
        ("row-take aligned      ", rowtake, by_index(lambda: st[:, None] // LANE * LANE + lane)),
        ("runs take+roll7+sel   ", runs_roll7, by_index(lambda: st[:, None] + lane)),
        ("runs packed roll7     ", runs_roll7_packed, by_index(lambda: st[:, None] + lane)),
        ("runs rw=8 take        ", runs8, by_index(lambda: st[:, None] // 8 * 8 + lane)),
        (f"transpose pad {Qp_pad}x{u_pad}", transpose_padded, transpose_padded_index),
        ("transpose (R,128)->(128,R)", lambda: x.view(2, R, LANE).transpose(1, 2).reshape(2, dim),
         by_index(transposed_index)),
    )
    return [probe_row(name, fn, ref, 2 * x.numel() * 4, device, reps, time_reference=False) for name, fn, ref in cases]


def kernel_rows(x: torch.Tensor, starts: torch.Tensor, reps: int, device) -> list:
    """The two roll kernels on the (2R/8, 8, 128) view, against their plain
    versions; the shifts as in the JAX script."""
    zz = x.view(-1, 8, LANE)
    c = starts % LANE
    c_block = c[: zz.shape[0]]
    c_row = c.repeat(2)[: zz.shape[0] * 8]
    nbytes = 2 * x.numel() * 4
    return [
        probe_row("pallas dyn-roll blk8  ", lambda: probes.dynroll(zz, c_block),
                  lambda: probes.dynroll_plain(zz, c_block), nbytes, device, reps),
        probe_row("pallas per-row roll   ", lambda: probes.rowroll(zz, c_row),
                  lambda: probes.rowroll_plain(zz, c_row), nbytes, device, reps),
    ]


def run(M: int = 26, reps: int = 3, device="cuda") -> list:
    """All rows on a seeded (2, 2^M) state, starts from the JAX script's
    np.random.RandomState(0)."""
    dim = 1 << M
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((2, dim), generator=gen, device=device)
    starts = np.random.RandomState(0).randint(0, dim - 129, size=(dim // LANE,)).astype(np.int32)
    starts = torch.from_numpy(starts).to(device)
    rows = xla_rows(x, starts, reps, device) + kernel_rows(x, starts, reps, device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("prof_rowperm: no CUDA device is available; it times kernels on the card", file=sys.stderr)
        return 1
    print(f"prof_rowperm: M=26 on {torch.cuda.get_device_name(0)}", flush=True)
    rows = run()
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
