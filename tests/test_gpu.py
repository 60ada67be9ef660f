"""Checks that need the card: compiled for the GPU, the kernels of the
render path agree with their plain references at the widths the bench
renders.  Skipped elsewhere; run on a machine with a GPU with
``GOOFER_TPU_TEST_PLATFORM=gpu python -m pytest -m gpu tests/``."""
import jax
import numpy as np
import pytest

from goofer_tpu.ops.envelope import _decode_matrix, decode_env_from_knots
from goofer_tpu.ops.pulse import pulse_train
from tests import oracles as o
from tests.test_resample_oracle import pulse_keep_mask

pytestmark = pytest.mark.gpu

SR, N_FFT = 44100, 1024


def test_knot_decode_is_f32_exact_on_gpu(gpu):
    """The decode's product runs at HIGHEST precision on the card: TF32
    would leave ~1e-3 relative error in the log envelope, exp'd."""
    rng = np.random.default_rng(0)
    knots = rng.uniform(-12.0, 0.0, (64, 130)).astype(np.float32)
    got = np.asarray(jax.jit(
        lambda k: decode_env_from_knots(k, SR, N_FFT, N_FFT // 2 + 1))(
            jax.device_put(knots, gpu)))
    want = np.exp(_decode_matrix(SR, N_FFT, 64).astype(np.float64)
                  @ knots.astype(np.float64))[: N_FFT // 2 + 1]
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_pulse_train_matches_oracle_at_bench_width_on_gpu(gpu):
    n, batch = 33075, 8
    t = np.arange(n) / SR
    base = np.linspace(110.0, 330.0, batch)[:, None]
    f0 = base * 2 ** (0.3 * np.sin(2 * np.pi * 2.0 * t))[None, :]
    f0[:, int(0.3 * n): int(0.4 * n)] = 0.0
    f0 = f0.astype(np.float32)
    got = np.asarray(jax.jit(jax.vmap(lambda f: pulse_train(f, SR)))(
        jax.device_put(f0, gpu)))
    for row, f in zip(got, f0):
        keep = pulse_keep_mask(f, SR)
        assert keep.mean() > 0.9
        assert np.max(np.abs(row - o.o_pulse_train(f, SR))[keep]) < 5e-3
