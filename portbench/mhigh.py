"""The m_high layout's side of the full-register cells: the closed form in
the layout's physical order, the byte count of its oracle passes, and the
runner that compares a window with them.

In the m_high layout the work register is the top M physical bits and the
counting register the low L, so a logical index z * 2^M + w (the order of
``reference.ShorDistribution``) sits at physical index w * 2^L + z.  The
program's sampler scans the state in physical order, so a draw maps to an
index through the physical-order CDF; the amplitudes are the same.

The oracle's bytes are worked out here from the circuit (C, a^(2^j) mod C
on control bit j) and the state's size, apart from the program: a pass of
K adjacent gates out of place (the ladder) reads and writes every element
of both planes; in place (a cycle walk, an in-place pair, a strip run) it
reads and writes the elements it moves: for each nonzero mask m of its
control bits, the 2^(L-K) columns with those bits, times the rows j < C
that the composed multiplier mu_m moves, C - gcd(mu_m - 1, C) of them.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import numpy as np
import torch

from portbench import reference
from portbench.full_register import FullRegisterRunner


class MhighDistribution(reference.ShorDistribution):
    """ShorDistribution with the CDF, the inverse CDF and the state in the
    m_high layout's physical order (indices stay logical)."""

    def __init__(self, C: int, a: int, L: int, M: int):
        super().__init__(C, a, L, M)
        # Within a column w: the sum of the probabilities of rows z' <= z.
        self.col_hi = np.cumsum(self.p_hi)
        self.col_lo = np.cumsum(self.p_lo)
        # The whole columns below w.
        column = self.is_hi * self.col_hi[-1] + self.is_lo * self.col_lo[-1]
        self.col_cdf = np.concatenate(([0.0], np.cumsum(column)))

    def physical(self, index: int) -> int:
        return ((index & ((1 << self.M) - 1)) << self.L) | (index >> self.M)

    def cdf(self, index: int) -> float:
        """Probability of every physical index <= that of `index`."""
        z, w = index >> self.M, index & ((1 << self.M) - 1)
        within = self.col_hi[z] if self.is_hi[w] else self.col_lo[z] if self.is_lo[w] else 0.0
        return float(self.col_cdf[w] + within)

    def exact_index(self, r: float) -> int:
        """The logical index the exact physical-order inverse CDF gives draw r."""
        w = min(int(np.searchsorted(self.col_cdf[1:], r, side="left")), (1 << self.M) - 1)
        col = self.col_hi if self.is_hi[w] else self.col_lo if self.is_lo[w] else np.zeros(1 << self.L)
        z = min(int(np.searchsorted(self.col_cdf[w] + col, r, side="left")), (1 << self.L) - 1)
        return (z << self.M) | w

    def state_gap(self, planar: torch.Tensor, rows_per_block: int = 1 << 10) -> float:
        """|| psi - psi_ref ||_2 of a (2, 2^n) planar state in physical
        order, in blocks of counting rows on the state's device, in float64."""
        N, W = 1 << self.L, 1 << self.M
        re_p, im_p = planar[0].view(W, N), planar[1].view(W, N)
        acc = torch.zeros((), dtype=torch.float64, device=planar.device)
        for lo in range(0, N, rows_per_block):
            hi = min(N, lo + rows_per_block)
            re, im = self.amplitudes(lo, hi, planar.device)
            acc += ((re_p[:, lo:hi].T.to(torch.float64) - re) ** 2 + (im_p[:, lo:hi].T.to(torch.float64) - im) ** 2).sum()
            del re, im
        return math.sqrt(float(acc))


def pass_bytes(C: int, multipliers: Iterable[int], n: int, M: int, itemsize: int, in_place: bool) -> int:
    """Bytes an oracle pass of the gates with these multipliers reads and
    writes on a (2, 2^n) planar state of `itemsize`-byte elements."""
    A = [int(x) % C for x in multipliers]
    if not in_place:
        return 2 * 2 * itemsize * (1 << n)
    moved = 0
    for m in range(1, 1 << len(A)):
        mu = 1
        for k, x in enumerate(A):
            if (m >> k) & 1:
                mu = (mu * x) % C
        moved += C - math.gcd(mu - 1, C)
    return 2 * 2 * itemsize * moved * (1 << (n - M - len(A)))


def oracle_bytes(passes, C: int, a: int, L: int, M: int, itemsize: int) -> Optional[int]:
    """Bytes of a sequence of m_high oracle passes, each (gates K, in
    place): the passes take the circuit's gates (control j, multiplier
    a^(2^j) mod C) in order, attempt after attempt.  None where the gates
    do not come out as whole attempts."""
    mult = [pow(a, 1 << j, C) for j in range(L)]
    total, j = 0, 0
    for K, in_place in passes:
        if K < 1 or j + K > L:
            return None
        total += pass_bytes(C, mult[j : j + K], L + M, M, itemsize, bool(in_place))
        j = (j + K) % L
    return total if j == 0 else None


class MhighRunner(FullRegisterRunner):
    """FullRegisterRunner on an m_high engine, compared with the closed
    form in physical order."""

    def check(self, attempts, seed: int) -> dict:
        dists = {}

        def dist(a):
            if a not in dists:
                dists[a] = MhighDistribution(self.C, a, self.L, self.M)
            return dists[a]

        gap, mismatches = 0.0, 0
        for at in attempts:
            o = at.out
            gap = max(gap, dist(o["a"]).index_gap(o["index"], o["r"]))
            omega = reference.read_omega(o["index"], self.L, self.M)
            if omega != o["omega"] or reference.period_from_omega(omega, o["a"], self.C) != o["period"]:
                mismatches += 1
        # One more attempt through the same call, its state kept for the comparison.
        i = attempts[-1].i + 1 if attempts else 0
        self._keep = []
        out = self.attempt(i)
        state = self._keep[-1]
        self._keep = None
        gap = max(gap, dist(out["a"]).index_gap(out["index"], out["r"]))
        state_gap = dist(out["a"]).state_gap(state)
        del state
        return {"state_gap": state_gap, "index_gap": gap, "driver_mismatches": float(mismatches)}
