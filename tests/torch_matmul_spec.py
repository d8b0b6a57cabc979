"""The packed-table layout and the TF32 rounding of the matrix-group kernel
(csrc/fused_matmul.cu), stated here on their own, apart from
ops/fused.py: the tests read the port's packed bytes back through these
unpackers and emulate the kernel's arithmetic with this rounding.

A lanemat / rowmat table is the products' operand B[k][n] = tab[re/im][k][n]
(K = N = 128 for a lanemat, 64 for a rowmat), parts re hi, re lo (then im
hi, im lo), per k-step of 32 bytes of K, byte offset
    step * parts * N * 32 + part * N * 32 + (n // 8) * 256 + half * 128
    + (n % 8) * 16 + e * itemsize
for the step's K index half * (16 / itemsize) + e, whose activation index
(lane or row) is ``k_order``.  An xtable is four 16 KB chunks of float4s,
chunk q, warpgroup wg, float4 v, thread t."""

from __future__ import annotations

import ml_dtypes
import numpy as np


def tf32_rna(x) -> np.ndarray:
    """Normal float32 values rounded to TF32 as cvt.rna.tf32.f32 rounds
    them: 11 significant bits, to nearest, ties away from zero; float32."""
    x = np.asarray(x, np.float32).astype(np.float64)
    m, e = np.frexp(np.abs(x))  # |x| = m 2^e, m in [0.5, 1)
    return (np.sign(x) * np.ldexp(np.floor(m * 2.0 ** 11 + 0.5), e - 11)).astype(np.float32)


def tf32_parts(x):
    """(hi, lo) of the 3xTF32 split: hi = x rounded to TF32, lo the float32
    remainder x - hi (exact) rounded to TF32."""
    x = np.asarray(x, np.float32)
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


LANE = 128


def k_order(kind: str, bf16: bool) -> np.ndarray:
    """Activation index of each K index of the products, from the kernel's
    loads: a rowmat's rows in order at TF32, at bf16 each odd c of a quad
    swapping its row pairs; a lanemat thread c (0..3) loads lanes
    16p + 4c .. 16p + 4c + 3 of its rows and feeds them as the A fragment's
    K (2c, 2c + 1, 2c + 8, 2c + 9) of bf16 step p, or (c, c + 4) of TF32
    steps 2p (lanes +0, +1) and 2p + 1 (lanes +2, +3)."""
    if kind == "rowmat":  # bf16: thread c of a quad reads rows 2c + (e ^ (c & 1)) for K 2c + e
        k = np.arange(64)
        c, e = (k % 8) // 2, k % 2
        return k - e + (e ^ (c & 1)) if bf16 else k
    out = np.empty(LANE, np.int64)
    for p in range(8):
        for c in range(4):
            lanes = 16 * p + 4 * c + np.arange(4)
            if bf16:
                out[16 * p + np.array([2 * c, 2 * c + 1, 2 * c + 8, 2 * c + 9])] = lanes
            else:
                out[8 * (2 * p) + np.array([c, c + 4])] = lanes[:2]
                out[8 * (2 * p + 1) + np.array([c, c + 4])] = lanes[2:]
    return out


def unpack_product(buf: np.ndarray, kind: str, real: bool, bf16: bool) -> np.ndarray:
    """(parts, K, N) of a packed lanemat / rowmat table (bf16 parts as
    float32), K in activation order: the inverse of the stated layout."""
    size = LANE if kind == "lanemat" else 64
    parts = 2 if real else 4
    item = 2 if bf16 else 4
    per16 = 16 // item
    part, k, n = np.indices((parts, size, size))
    step, kk = k // (2 * per16), k % (2 * per16)
    off = step * parts * size * 32 + part * size * 32 + (n // 8) * 256 + (kk // per16) * 128 + (n % 8) * 16 + (kk % per16) * item
    assert buf.nbytes == parts * size * size * item
    if bf16:
        vals = buf.view(np.uint16)[off // 2].view(ml_dtypes.bfloat16).astype(np.float32)
    else:
        vals = buf.view(np.float32)[off // 4]
    out = np.empty_like(vals)
    out[:, k_order(kind, bf16), :] = vals
    if kind == "rowmat":  # output n is row 8j + 2c + (e ^ (c & 1)) for n = 8j + 2c + e
        n = np.arange(64)
        rows = n - n % 2 + ((n % 2) ^ ((n // 2) & 1))
        out[:, :, rows] = out.copy()
    return out


def unpack_xtable(buf: np.ndarray) -> np.ndarray:
    """(2 cos/sin, 64, 128) of a packed xtable: thread t = 32 w + 4 g + c of
    warpgroup wg holds, in float4 v of chunk q, (cos, sin) of its elements
    i = 2v and 2v + 1; element i = 4 jj + e lies at row 16q + 8jj + 2c +
    ((e & 1) ^ (c & 1)), lane 64 wg + 16 w + 2 g + (e >> 1)."""
    x = buf.view(np.float32).reshape(4, 2, 4, 128, 4)
    out = np.full((2, 64, LANE), np.nan, np.float32)
    for q in range(4):
        for wg in range(2):
            for t in range(128):
                w, g, c = t >> 5, (t & 31) >> 2, t & 3
                for v in range(4):
                    for half in range(2):
                        i = 2 * v + half
                        jj, e = i >> 2, i & 3
                        row, lane = 16 * q + 8 * jj + 2 * c + ((e & 1) ^ (c & 1)), 64 * wg + 16 * w + 2 * g + (e >> 1)
                        out[:, row, lane] = x[q, wg, v, t, 2 * half: 2 * half + 2]
    return out
