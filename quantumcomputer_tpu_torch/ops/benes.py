"""Benes/Waksman network routing: any permutation as butterfly swap stages.

A copy of the JAX package's ``ops/benes.py`` (numpy only), the spec of the
Benes form of the controlled modular multiply: a permutation of the
2^M-element work register factors into exactly 2M - 1 conditional
exchanges at stride 2^b,

    bits  M-1, M-2, ..., 1, 0, 1, ..., M-2, M-1

each stage carrying a boolean mask over ELEMENTS: element p exchanges with
p ^ 2^b iff mask[p] == 1 (full-size (2^k,) masks, symmetric within each
pair).  The masks are computed on the host (Waksman's recursive
2-coloring, O(M 2^M)).  The fused segment's plain version applies these
stages (``ops/fused.py``); its CUDA kernel gathers by the inverse
permutation instead, and the two must agree exactly.

Conventions: permutations are in *scatter* form pi: the element at input
slot i must end at output slot pi[i].  (The gather map of the oracle's
gather path is its inverse.)
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def benes_route(pi: np.ndarray) -> List[Tuple[int, np.ndarray]]:
    """Factor scatter-permutation pi over 2^k elements into swap stages.

    Returns [(bit, elem_mask), ...] in application order, where elem_mask is
    a (2^k,) uint8 array: element p exchanges with p ^ 2^bit iff
    elem_mask[p] == 1 (the mask is symmetric in each pair).
    """
    pi = np.asarray(pi, dtype=np.int64)
    size = pi.shape[0]
    k = size.bit_length() - 1
    assert size == 1 << k
    assert np.array_equal(np.sort(pi), np.arange(size)), "not a permutation"
    stages = _route(pi, k)
    # sanity: simulate
    x = np.arange(size)
    for bit, mask in stages:
        partner = x.copy()
        idx = np.arange(size)
        swapped = np.where(mask == 1, partner[idx ^ (1 << bit)], partner)
        x = swapped
    # x[p] is the element now at slot p; need element i at slot pi[i]:
    want = np.empty(size, dtype=np.int64)
    want[pi] = np.arange(size)
    assert np.array_equal(x, want), "Benes routing self-check failed"
    return stages


def _route(pi: np.ndarray, k: int) -> List[Tuple[int, np.ndarray]]:
    size = 1 << k
    if k == 0:
        return []
    if k == 1:
        mask = np.zeros(2, dtype=np.uint8)
        if pi[0] == 1:
            mask[:] = 1
        return [(0, mask)]
    H = size // 2
    b = k - 1
    inv = np.empty(size, dtype=np.int64)
    inv[pi] = np.arange(size)

    # 2-color elements: h[e] = 0 (top) / 1 (bottom).  Constraint edges:
    #   input pair  (e, e^H)                -> different halves
    #   output pair (e, o(e)=inv[pi[e]^H])  -> different halves
    # Every element has one edge of each kind, so the constraint graph is a
    # union of even alternating cycles: walk each cycle assigning colors.
    h = np.full(size, -1, dtype=np.int8)
    for start in range(size):
        if h[start] >= 0:
            continue
        e, c = start, 0
        while h[e] < 0:
            h[e] = c
            pin = e ^ H  # input partner: opposite color
            if h[pin] < 0:
                h[pin] = 1 - c
            # continue along pin's output edge; its partner gets 1 - h[pin]
            e = inv[pi[pin] ^ H]
            c = 1 - h[pin]

    alpha = np.zeros(H, dtype=np.uint8)  # input-stage swaps per pair base i
    beta = np.zeros(H, dtype=np.uint8)  # output-stage swaps per pair base j
    pi_top = np.empty(H, dtype=np.int64)
    pi_bot = np.empty(H, dtype=np.int64)
    for i in range(H):
        alpha[i] = h[i]  # element at lower slot goes bottom iff colored 1
        e_top = i if h[i] == 0 else i + H
        e_bot = i + H if h[i] == 0 else i
        pi_top[i] = pi[e_top] & (H - 1)
        pi_bot[i] = pi[e_bot] & (H - 1)
    for j in range(H):
        beta[j] = h[inv[j]]  # out slot j fed from bottom iff its element is colored 1

    sub_top = _route(pi_top, k - 1)
    sub_bot = _route(pi_bot, k - 1)

    stages: List[Tuple[int, np.ndarray]] = []
    in_mask = np.empty(size, dtype=np.uint8)
    in_mask[:H] = alpha
    in_mask[H:] = alpha
    stages.append((b, in_mask))
    # merge sub-stages: top acts on elements with bit b == 0, bottom bit b == 1
    assert len(sub_top) == len(sub_bot)
    for (bt, mt), (bb, mb) in zip(sub_top, sub_bot):
        assert bt == bb
        merged = np.empty(size, dtype=np.uint8)
        merged[:H] = mt
        merged[H:] = mb
        stages.append((bt, merged))
    out_mask = np.empty(size, dtype=np.uint8)
    out_mask[:H] = beta
    out_mask[H:] = beta
    stages.append((b, out_mask))
    return stages


def benes_stage_count(M: int) -> int:
    return max(0, 2 * M - 1)
