"""The port's probe kernels (quantumcomputer_tpu_torch/ops/probes.py,
csrc/probes.cu) and their scripts (quantumcomputer_tpu_torch/scripts/).

The JAX probes cannot run on the CPU: ``scripts/prof_chunkgather.py:_call``
has no interpret flag, and ``scripts/prof_rowperm.py`` runs its probes when
it is imported.  So each plain version is held, exactly, against the JAX
scripts' own definition of what the probe computes:

  * ``np_expect`` (scripts/prof_chunkgather.py:145), re-stated below: the
    function of ``_roll2_kernel`` and ``_mxuroll_kernel``, and of
    ``_copy_kernel`` on 1024-aligned starts;
  * ``_copy_kernel`` (scripts/prof_chunkgather.py:86-92) DMAs the tiles from
    ``starts[i] >> 10``, so on any start it copies from the start rounded
    down to a multiple of 1024;
  * ``pltpu.roll(x, -c, axis)`` is ``np.roll(x, -c, axis)``, one shift per
    8-row block in ``kern`` (prof_rowperm.py:158) and one per row in
    ``kern2`` (prof_rowperm.py:186).

The kernels themselves are held against the plain versions on the card by
chip_smoke.py and quantumcomputer_tpu_torch/utils/kernel_checks.py."""

import numpy as np
import pytest
import torch

from quantumcomputer_tpu_torch.ops import probes
from quantumcomputer_tpu_torch.scripts import (prof_ae_drift, prof_benes, prof_chunkgather, prof_fused, prof_measure,
                                               prof_rowperm, prof_strip)

M, W = 16, 2048
DIM = 1 << M
NC = DIM // W


def np_expect(xh, starts_h):
    """scripts/prof_chunkgather.py:145-149, with its DIM and W."""
    out = np.empty(DIM, np.float32)
    for i, s in enumerate(starts_h):
        out[i * W:(i + 1) * W] = xh[s:s + W]
    return out


def _plane(seed):
    return np.random.default_rng(seed).standard_normal(DIM).astype(np.float32)


def _starts(seed, align):
    """The JAX script's starts_for: below DIM - W - 1024, rounded to align."""
    s = np.random.default_rng(seed).integers(0, DIM - W - 1024, NC)
    return (s // align * align).astype(np.int32)


@pytest.mark.parametrize("align", [1, 8, 1024])
def test_unaligned_chunk_plain_is_np_expect(align):
    xh, st = _plane(1), _starts(2 + align, align)
    got = probes.chunk_gather_plain(torch.from_numpy(xh), torch.from_numpy(st), W)
    np.testing.assert_array_equal(got.numpy(), np_expect(xh, st))
    for fn in (probes.chunk_roll2, probes.chunk_mxuroll):  # their plain versions on the CPU
        np.testing.assert_array_equal(fn(torch.from_numpy(xh), torch.from_numpy(st), W).numpy(), got.numpy())


@pytest.mark.parametrize("align", [None, 1024, 1])
def test_copy_plain_rounds_starts_down_to_tiles(align):
    xh = _plane(3)
    st = np.arange(NC, dtype=np.int32) * W if align is None else _starts(4, align)
    got = probes.chunk_copy(torch.from_numpy(xh), torch.from_numpy(st), W)
    np.testing.assert_array_equal(got.numpy(), np_expect(xh, (st >> 10) << 10))


def test_chunk_starts_are_clamped_into_the_plane():
    xh = _plane(5)
    st = np.array([-5000, -1, DIM - W, DIM - W + 3, DIM + 77, 12345], np.int32)
    clamped = np.clip(st, 0, DIM - W)
    x, s = torch.from_numpy(xh), torch.from_numpy(st)
    want = np.concatenate([xh[c:c + W] for c in clamped])
    np.testing.assert_array_equal(probes.chunk_gather_plain(x, s, W).numpy(), want)
    tiles = np.clip((st.astype(np.int64) >> 10) << 10, 0, DIM - W)
    want = np.concatenate([xh[c:c + W] for c in tiles])
    np.testing.assert_array_equal(probes.chunk_copy_plain(x, s, W).numpy(), want)


@pytest.mark.parametrize("per_row", [False, True])
def test_roll_plain_is_np_roll(per_row):
    rng = np.random.default_rng(6)
    B = 40
    xh = rng.standard_normal((B, 8, 128)).astype(np.float32)
    c = rng.integers(-300, 300, B * 8 if per_row else B).astype(np.int32)
    fn = probes.rowroll if per_row else probes.dynroll
    got = fn(torch.from_numpy(xh), torch.from_numpy(c)).numpy()
    for b in range(B):
        for k in range(8):
            shift = c[8 * b + k] if per_row else c[b]
            np.testing.assert_array_equal(got[b, k], np.roll(xh[b, k], -shift, -1))


def test_wrappers_validate_and_launch_nothing_on_cpu():
    before = dict(probes.LAUNCHES)
    x = torch.from_numpy(_plane(7))
    s = torch.zeros(NC, dtype=torch.int32)
    for fn in (probes.chunk_copy, probes.chunk_roll2, probes.chunk_mxuroll):
        with pytest.raises(ValueError, match="multiples of 1024"):
            fn(x, s, 1000)
        with pytest.raises(TypeError, match="float32"):
            fn(x.double(), s, W)
        with pytest.raises(ValueError, match="flat plane"):
            fn(x.view(2, -1), s, W)
        with pytest.raises(ValueError, match="no .* probe path for device meta"):
            fn(torch.empty(DIM, device="meta"), s, W)
    x3 = x.view(-1, 8, 128)
    with pytest.raises(ValueError, match="length 64"):
        probes.dynroll(x3, torch.zeros(65, dtype=torch.int32))
    with pytest.raises(ValueError, match="length 512"):
        probes.rowroll(x3, torch.zeros(64, dtype=torch.int32))
    with pytest.raises(ValueError, match="must be \\(B, 8, 128\\)"):
        probes.dynroll(x.view(-1, 4, 128), torch.zeros(128, dtype=torch.int32))
    assert probes.LAUNCHES == before


def test_scripts_rows_are_ok_on_cpu(capsys):
    """Both scripts end to end at a small size on the CPU, where the rows
    are checked (each exactly equal to its reference) and not timed."""
    rows = prof_chunkgather.run(M=14, W=1024, device="cpu", shapes=((300, 523), (256, 1000)))
    rows += prof_rowperm.run(M=14, device="cpu")
    assert len(rows) == 6 + 8
    assert all(r["ok"] and r["max_abs_err"] == 0.0 and r["ms"] is None for r in rows)
    out = capsys.readouterr().out
    assert "mxuroll : not measured  ok=True" in out
    assert "pallas per-row roll   : not measured  ok=True" in out


def test_scripts_need_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert prof_chunkgather.main() == 1
    assert prof_rowperm.main() == 1
    assert prof_benes.main([]) == 1
    assert prof_fused.main([]) == 1
    assert prof_strip.main([]) == 1
    assert prof_measure.main([]) == 1
    assert prof_ae_drift.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
