"""The plain reference of the benchmark: Shor period finding worked out
exactly, independent of the program under test.

Plain NumPy and PyTorch only.  Nothing here imports ``jax``, the JAX
package or the PyTorch port; every table the program derives (orbits,
permutations, plans, draws) is worked out again here.

Full register (n = L + M qubits, work register in bits [0, M), counting
register in bits [M, M + L), reset |0..01>): after the Hadamards and the
controlled multiplies the state is 2^(-L/2) sum_x |x>|a^x mod C>; the
inverse QFT of the reference circuit (no final swaps) leaves the counting
bits holding z = rev_L(y) with amplitude

    psi(z, w) = 2^-L * sum_{x : a^x = w} exp(2 pi i x y / 2^L).

With r = ord_C(a), w = a^x0 (0 <= x0 < r) and K(x0) = #{x < 2^L : x = x0
mod r}, the sum is the geometric series

    psi = 2^-L * exp(2 pi i x0 y / 2^L) * sum_{k < K} exp(i phi k),
    phi = 2 pi r y / 2^L,

so every amplitude, every probability and the cumulative distribution in
index order (index = z * 2^M + w) come in closed form, in float64, without
a state vector.  ``plain_state`` runs the circuit gate by gate on a small
register to hold the closed form to the circuit's definition.

Semiclassical: the eigenphase posterior of ``scripts/predict_semiclassical.py``
(copied): the work register |1> = r^-1/2 sum_k |u_k>, and step s measures 0
with probability sum_k w_k cos^2(pi (2^(L-1-s) k / r + phi_s / 2)), the
posterior w_k updated by the measured bit.

The classical pipeline (bit-reversed readout, continued fractions, the
period test) follows ``qc_shor.c:806-964`` in its C integers: the
denominators and candidate periods wrap modulo 2^64, as the program's
native classical layer (``native/qc_classical.cpp``) computes them.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

NUM_CONTINUED_FRACTIONS = 15
TRIALS_PER_DENOMINATOR = 10


# -- number theory -------------------------------------------------------------


def factorize(C: int) -> dict:
    """Prime factors of C by trial division (moduli up to about 2^40)."""
    fac, x, d = {}, int(C), 2
    while d * d <= x:
        while x % d == 0:
            fac[d] = fac.get(d, 0) + 1
            x //= d
        d += 1
    if x > 1:
        fac[x] = fac.get(x, 0) + 1
    return fac


def multiplicative_order(a: int, C: int) -> int:
    """ord_C(a), reduced prime by prime from Carmichael's lambda."""
    if math.gcd(a, C) != 1:
        raise ValueError(f"{a} is not a unit mod {C}")
    orders = []
    for p, k in factorize(C).items():
        pk = p**k
        o = (p - 1) * p ** (k - 1)
        for q in factorize(o):
            while o % q == 0 and pow(a, o // q, pk) == 1:
                o //= q
        orders.append(o)
    return math.lcm(*orders)


def read_omega(index: int, L: int, M: int) -> float:
    """omega = rev_L(counting bits) / 2^L of a full-register index."""
    z = index >> M
    y = int(format(z, f"0{L}b")[::-1], 2)
    return y / float(1 << L)


U64 = 1 << 64


def continued_fraction_denominators(omega: float, num_fractions: int = NUM_CONTINUED_FRACTIONS) -> List[int]:
    """Convergent denominators as qc_shor.c:806-846 builds them, in its C
    integers: each coefficient floor(1/omega) from the double recurrence
    (saturating at 2^64 - 1), each denominator rebuilt from the
    coefficients before it in reverse, wrapping modulo 2^64; omega == 0
    gives coefficient 0."""
    out, coeffs = [], []
    for _ in range(num_fractions):
        if omega <= 0.0:
            coeffs.append(0)
        else:
            inv = 1.0 / omega
            frac = inv - float(int(inv))
            c = inv - frac
            coeffs.append(U64 - 1 if c >= 1.8446744073709552e19 else int(c))
            omega = frac
        den, num = 1, 0
        for c in reversed(coeffs[:-1]):
            num, den = den, (num + den * c) % U64
        out.append(den)
    return out


def period_from_omega(omega: float, a: int, C: int) -> Optional[int]:
    """The first m * d (d a convergent denominator, m = 1..10, the product
    modulo 2^64) with a^(m d) = 1 mod C (qc_shor.c:941-955); None when no
    candidate passes, or when the first that passes does not fit a signed
    64-bit period."""
    for d in continued_fraction_denominators(omega):
        if d == 0:
            continue
        for m in range(1, TRIALS_PER_DENOMINATOR + 1):
            p = (m * d) % U64
            if p and pow(a, p, C) == 1:
                return p if p < (1 << 63) else None
    return None


def bit_reverse(values: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros_like(values)
    v = values.copy()
    for _ in range(bits):
        out = (out << 1) | (v & 1)
        v >>= 1
    return out


# -- the full register in closed form ---------------------------------------------


class ShorDistribution:
    """The final state and the measurement distribution of the Shor circuit
    (C, a, L, M) in closed form."""

    def __init__(self, C: int, a: int, L: int, M: int):
        if (1 << M) < C:
            raise ValueError(f"2^M = {1 << M} < C = {C}")
        self.C, self.a, self.L, self.M = C, a, L, M
        self.r = r = multiplicative_order(a, C)
        # x0 of each work value on the orbit of 1 (-1 off the orbit).
        x0 = np.full(1 << M, -1, dtype=np.int64)
        w = 1
        for x in range(r):
            x0[w] = x
            w = (w * a) % C
        self.x0 = x0
        N = 1 << L
        self.k_hi = -(-N // r)  # K of x0 < N mod r (all of them when r | N)
        k_of = np.where(x0 >= 0, (N - 1 - x0) // r + 1, 0)
        self.is_hi = (k_of == self.k_hi) & (x0 >= 0)
        self.is_lo = (k_of == self.k_hi - 1) & (x0 >= 0) & (self.k_hi > 1)
        self.n_hi, self.n_lo = int(self.is_hi.sum()), int(self.is_lo.sum())
        # Per counting value z: y = rev(z), the probability of one orbit entry
        # with K = k_hi and with K = k_hi - 1.
        z = np.arange(N, dtype=np.int64)
        self.y_of_z = bit_reverse(z, L)
        self.p_hi = self._geometric_power(self.y_of_z, self.k_hi)
        self.p_lo = self._geometric_power(self.y_of_z, self.k_hi - 1)
        row = self.n_hi * self.p_hi + self.n_lo * self.p_lo
        self.row_cdf = np.concatenate(([0.0], np.cumsum(row)))  # row_cdf[z] = sum of rows before z
        self.cnt_hi = np.cumsum(self.is_hi)  # orbit entries <= w with K = k_hi
        self.cnt_lo = np.cumsum(self.is_lo)

    def _geometric_power(self, y: np.ndarray, K: int) -> np.ndarray:
        """|sum_{k<K} e^{i phi k}|^2 / 4^L with phi = 2 pi r y / 2^L."""
        if K <= 0:
            return np.zeros(y.shape, dtype=np.float64)
        N = 1 << self.L
        t = (self.r * y) % N  # phi = 2 pi t / N, exactly
        half = np.pi * t / N
        s = np.sin(half)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(t == 0, float(K * K), (np.sin(K * half) / np.where(t == 0, 1.0, s)) ** 2)
        return ratio / float(N) ** 2

    def total(self) -> float:
        return float(self.row_cdf[-1])

    def prob(self, index: int) -> float:
        z, w = index >> self.M, index & ((1 << self.M) - 1)
        return float(self.p_hi[z] if self.is_hi[w] else self.p_lo[z] if self.is_lo[w] else 0.0)

    def cdf(self, index: int) -> float:
        """Probability of every index <= `index`."""
        z, w = index >> self.M, index & ((1 << self.M) - 1)
        return float(self.row_cdf[z] + self.cnt_hi[w] * self.p_hi[z] + self.cnt_lo[w] * self.p_lo[z])

    def index_gap(self, index: int, r: float) -> float:
        """How far the draw r lies outside (F(index - 1), F(index)], the
        interval of draws the exact inverse CDF maps to `index`."""
        hi = self.cdf(index)
        lo = hi - self.prob(index)
        return max(0.0, lo - r, r - hi)

    def exact_index(self, r: float) -> int:
        """The index the exact inverse CDF gives draw r."""
        z = int(np.searchsorted(self.row_cdf[1:], r, side="left"))
        z = min(z, (1 << self.L) - 1)
        within = self.row_cdf[z] + self.cnt_hi * self.p_hi[z] + self.cnt_lo * self.p_lo[z]
        w = min(int(np.searchsorted(within, r, side="left")), (1 << self.M) - 1)
        return (z << self.M) | w

    def amplitudes(self, z_lo: int, z_hi: int, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
        """(re, im) float64 of rows z_lo..z_hi-1 of the (2^L, 2^M) state."""
        N = 1 << self.L
        y = torch.from_numpy(self.y_of_z[z_lo:z_hi]).to(device)[:, None]
        x0 = torch.from_numpy(self.x0).to(device)[None, :]
        K = torch.from_numpy(np.where(self.is_hi, self.k_hi, np.where(self.is_lo, self.k_hi - 1, 0))).to(device)[None, :]
        t = (self.r * y) % N
        half = math.pi * t.to(torch.float64) / N
        s = torch.sin(half)
        mag = torch.where(t == 0, K.to(torch.float64), torch.sin(K * half) / torch.where(t == 0, torch.ones_like(s), s))
        # arg = 2 pi x0 y / N + (K - 1) phi / 2, phases reduced modulo N exactly.
        turns = ((x0.clamp(min=0) * y) % N).to(torch.float64) / N
        ang = 2 * math.pi * turns + (K - 1).to(torch.float64) * half
        mag = torch.where(x0 >= 0, mag, torch.zeros_like(mag)) / N
        return mag * torch.cos(ang), mag * torch.sin(ang)

    def state_gap(self, planar: torch.Tensor, rows_per_block: int = 1 << 10) -> float:
        """|| psi - psi_ref ||_2 of a (2, 2^n) planar state, worked out in
        blocks of counting rows on the state's device, in float64."""
        N, W = 1 << self.L, 1 << self.M
        re_p, im_p = planar[0].view(N, W), planar[1].view(N, W)
        acc = torch.zeros((), dtype=torch.float64, device=planar.device)
        for lo in range(0, N, rows_per_block):
            hi = min(N, lo + rows_per_block)
            re, im = self.amplitudes(lo, hi, planar.device)
            acc += ((re_p[lo:hi].to(torch.float64) - re) ** 2 + (im_p[lo:hi].to(torch.float64) - im) ** 2).sum()
            del re, im
        return math.sqrt(float(acc))


def plain_state(C: int, a: int, L: int, M: int) -> np.ndarray:
    """The Shor circuit run gate by gate in complex128 on a small register:
    H on each counting qubit, the controlled multiplies by a^(2^j) mod C on
    the work register (control qubit M + j), then the reference loop's
    inverse QFT, H(l) and CP(l, k, pi / 2^(l - k)) for l from the top."""
    n = L + M
    psi = np.zeros(1 << n, dtype=np.complex128)
    psi[1] = 1.0
    idx = np.arange(1 << n)

    def h(q):
        nonlocal psi
        lo = (idx >> q) & 1 == 0
        a0, a1 = psi[lo], psi[idx[lo] | (1 << q)]
        out = psi.copy()
        out[lo] = (a0 + a1) / math.sqrt(2)
        out[idx[lo] | (1 << q)] = (a0 - a1) / math.sqrt(2)
        psi = out

    for j in range(L):
        h(M + j)
    wmask = (1 << M) - 1
    for j in range(L):
        A = pow(a, 1 << j, C)
        w = idx & wmask
        ctrl = (idx >> (M + j)) & 1 == 1
        dst = np.where(ctrl & (w < C), (idx & ~wmask) | ((A * w) % C), idx)
        out = np.zeros_like(psi)
        out[dst] = psi
        psi = out
    for l in range(M + L - 1, M - 1, -1):
        h(l)
        for k in range(l - 1, M - 1, -1):
            both = ((idx >> l) & 1 == 1) & ((idx >> k) & 1 == 1)
            psi = np.where(both, psi * np.exp(1j * math.pi / (1 << (l - k))), psi)
    return psi


# -- the semiclassical attempt ------------------------------------------------------


class EigenphasePosterior:
    """Exact conditional bit probabilities of a semiclassical attempt, given
    the bits measured before each step."""

    def __init__(self, C: int, a: int, L: int, r: Optional[int] = None):
        self.C, self.a, self.L = C, a, L
        self.r = r if r is not None else multiplicative_order(a, C)

    def replay(self, bits: Sequence[int]) -> List[float]:
        """p0 of every step, the posterior following `bits` (the program's)."""
        r, L = self.r, self.L
        k = np.arange(r, dtype=np.int64)
        w = np.full(r, 1.0 / r)
        phi, p0s = 0.0, []
        for s in range(L):
            e = pow(2, L - 1 - s, r)
            frac = ((e * k) % r) / r
            p0k = np.cos(np.pi * (frac + phi / 2.0)) ** 2
            p0 = float(np.dot(w, p0k))
            p0s.append(p0)
            bit = int(bits[s])
            like = p0k if bit == 0 else 1.0 - p0k
            w = w * like
            w /= w.sum()
            phi = (phi + bit) / 2.0
        return p0s


def sc_gap(p0s: Sequence[float], bits: Sequence[int], probs: Sequence[float], rs: Sequence[float]) -> float:
    """The widest of, over the steps: the gap between the program's
    conditional probability of its bit and the exact one, and how far the
    draw lies on the other side of the exact p0 where the program's bit
    disagrees with the draw (bit 1 iff draw >= p0)."""
    gap = 0.0
    for p0, b, p, r in zip(p0s, bits, probs, rs):
        gap = max(gap, abs(float(p) - (p0 if b == 0 else 1.0 - p0)))
        if (float(r) >= p0) != (b == 1):
            gap = max(gap, abs(float(r) - p0))
    return gap


def x_tilde(bits: Sequence[int]) -> int:
    """The first measured bit is the least significant."""
    return sum(int(b) << i for i, b in enumerate(bits))
