"""K13 of the PyTorch package (ops/stream_read.py), the streaming read that
calibrates the card's device-memory rate, and utils/calibrate.py, on the
CPU.

The TPU kernel (``rd`` inside bench.py::calibrate) is local to that
function and runs only on a TPU, so its function is written out here in
numpy: for each of ``passes`` passes and each [rows, cols] block of the
slab, add the block's float32 column sums into o, and keep the first 128
columns. K13's plain version must equal it within 1e-5 relative (the
same float32 sums of bf16 values, added in another order: at the TPU
shape scaled down, 8192 additions to a sum near 4096, where a float32
step is 4.9e-4). chip_smoke's K13 check, which
compares all ``cols`` sums, must reject a kernel that read only the 128
columns it returns.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu_torch import runtime
from multimodal_audio_search_tpu_torch.ops import stream_read as SR
from multimodal_audio_search_tpu_torch.utils import calibrate as CAL

torch.set_num_threads(1)


def _kern_statement(x: np.ndarray, rows: int, passes: int) -> np.ndarray:
    """bench.py's kern over grid (passes, n_chunk), in numpy."""
    o = np.zeros((1, 128), np.float32)
    for _ in range(passes):
        for i in range(x.shape[0] // rows):
            blk = x[i * rows:(i + 1) * rows].astype(np.float32)
            o += np.sum(blk, axis=0, keepdims=True)[:, :128]
    return o


def _slab(rng, n_rows, cols):
    """Uniform [0, 1) values rounded to bf16: (torch bf16, numpy float32
    of the same values)."""
    x = torch.from_numpy(rng.random((n_rows, cols), np.float32)).to(
        torch.bfloat16)
    return x, x.float().numpy()


@pytest.mark.parametrize("rows,n_chunk,cols,passes", [
    (64, 16, 512, 8),      # the TPU shape, scaled down
    (32, 5, 128, 3),
    (8, 3, 264, 1)])
def test_k13_plain_matches_the_tpu_kernel(rng, rows, n_chunk, cols, passes):
    x, xf = _slab(rng, rows * n_chunk, cols)
    ref = _kern_statement(xf, rows, passes)
    got = SR.stream_read_plain(x, passes)
    assert got.shape == (1, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
    runtime.reset_counts()
    np.testing.assert_array_equal(SR.stream_read(x, passes).numpy(),
                                  got.numpy())
    assert set(runtime.COUNTS.values()) == {0}    # plain on the CPU
    sums = SR.stream_read_sums(x, passes)
    np.testing.assert_allclose(sums.numpy(), passes * xf.sum(0), rtol=1e-5)


def test_k13_card_check_rejects_reading_128_columns(rng):
    """chip_smoke's K13 check over all columns (K13_CHECK_SHAPE's width):
    the plain sums pass, float64 sums pass, and a kernel that summed only
    the first 128 columns -- whose [1, 128] output is right -- fails."""
    x, xf = _slab(rng, 4096, 512)
    ref = SR.stream_read_sums_plain(x, CAL.PASSES)
    chip_smoke.check_k13("K13", torch.from_numpy(
        (CAL.PASSES * xf.astype(np.float64).sum(0)).astype(np.float32)), ref)
    faulty = torch.zeros_like(ref)
    faulty[:128] = SR.stream_read_sums_plain(x[:, :128], CAL.PASSES)
    np.testing.assert_array_equal(faulty[:128].numpy(), ref[:128].numpy())
    with pytest.raises(AssertionError, match="column sums"):
        chip_smoke.check_k13("K13 first 128 columns", faulty, ref)


def test_k13_bound_counts_the_slab_once():
    """The calibration's slab is 4 GiB; its 8 passes move 34.4 GB, the
    function itself needs the slab read once (chip_smoke.bound)."""
    nbytes = CAL.ROWS * CAL.N_CHUNK * CAL.COLS * 2
    assert nbytes == 4 * 2 ** 30
    once = chip_smoke.bound(nbytes)
    passes = chip_smoke.bound(CAL.PASSES * nbytes)
    assert once["bound_by"] == passes["bound_by"] == "bytes"
    assert passes["bound_ms"] == pytest.approx(10.256, abs=1e-3)
    assert once["bound_ms"] == pytest.approx(passes["bound_ms"] / 8)


def test_calibrate_needs_a_card():
    with pytest.raises(RuntimeError):
        CAL.calibrate("cpu")
    with pytest.raises(RuntimeError):
        CAL.calibrate("cuda")        # no card here
    assert CAL.STREAM_READ_LAUNCHES == 1 + CAL.TRIALS
