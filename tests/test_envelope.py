import numpy as np
import jax.numpy as jnp

from goofer_tpu.ops import envelope as env_mod
from tests import oracles as o

RNG = np.random.default_rng(11)
SR = 44100
N_FFT = 1024
N_BINS = N_FFT // 2 + 1


def _smooth_env(t=40):
    """A plausible spectral envelope: smooth in frequency, positive."""
    base = np.exp(-np.linspace(0, 6, N_BINS))[:, None]
    wob = 1.0 + 0.3 * np.sin(np.linspace(0, 20, N_BINS))[:, None]
    drift = 1.0 + 0.1 * np.sin(np.linspace(0, 3, t))[None, :]
    return (base * wob * drift + 1e-4).astype(np.float32)


def test_knot_codec_roundtrip_error_budget():
    env = _smooth_env()
    pack = env_mod.compress_env_to_knots(env, SR, N_FFT)
    assert pack["mode"] == "knots"
    assert pack["knot_vals_log"].dtype == np.float16
    dec = np.asarray(env_mod.decode_env_from_knots(
        jnp.asarray(pack["knot_vals_log"], dtype=jnp.float32),
        SR, N_FFT, N_BINS))
    # the codec accepts the first K with max relative error < 1e-2 against
    # the 0.5-bin smoothed envelope; fp16 knot storage adds ~1e-3
    env_s = o.o_gaussian1d(env, 0.5, axis=0)
    rel = np.max(np.abs(dec - env_s) / (env_s + 1e-8))
    assert rel < 2e-2, rel


def test_knot_decode_matches_matmul():
    k = 48
    knots = RNG.standard_normal((k, 7)).astype(np.float32)
    w = env_mod._decode_matrix(SR, N_FFT, k)
    want = np.exp(w @ knots)[:N_BINS]
    got = np.asarray(env_mod.decode_env_from_knots(
        jnp.asarray(knots), SR, N_FFT, N_BINS))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_shift_formants_global():
    env = _smooth_env(5)
    got = np.asarray(env_mod.shift_formants_global(jnp.asarray(env), 1.2, SR))
    freqs = np.linspace(0, SR / 2, N_BINS)
    warped = np.clip(freqs / 1.2, 0, SR / 2)
    want = np.stack([o.o_interp_extrap(freqs, env[:, t], warped)
                     for t in range(5)], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def test_warp_env_by_formants_matches_oracle():
    t = 6
    env = _smooth_env(t)
    orig = np.stack([
        np.full(t, 600.0), np.full(t, 1200.0),
        np.full(t, 2600.0), np.full(t, 3900.0)]).astype(np.float32)
    orig = orig * (1 + 0.05 * RNG.standard_normal((4, t))).astype(np.float32)
    # make F3 invalid in some frames to exercise the anchor compaction
    orig[2, 1] = 0.0
    orig[2, 3] = np.float32(SR)
    shift = orig * np.array([1.1, 0.9, 1.05, 1.0])[:, None]
    got = np.asarray(env_mod.warp_env_by_formants(
        jnp.asarray(env), jnp.asarray(orig), jnp.asarray(shift), SR))
    want = o.o_warp_env_by_formants(env.astype(np.float64), orig, shift, SR)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-5)


def test_formant_width_warp():
    env = _smooth_env(4)
    amount = 0.05
    got = np.asarray(env_mod.formant_width_warp(jnp.asarray(env), amount))
    bins = np.arange(N_BINS, dtype=np.float64)
    center = N_BINS / 2.0
    warped = np.clip((bins - center) * (1 + amount) + center, 0, N_BINS - 1)
    lo = np.floor(warped).astype(int)
    hi = np.minimum(lo + 1, N_BINS - 1)
    frac = warped - lo
    want = (1 - frac)[:, None] * env[lo] + frac[:, None] * env[hi]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_brightness_tilt_mean_normalized():
    env = _smooth_env(3)
    got = np.asarray(env_mod.brightness_tilt(jnp.asarray(env), 1.5, SR))
    freqs = np.linspace(1e-6, SR * 0.5, N_BINS, dtype=np.float32)
    norm_f = np.clip(freqs / (SR * 0.5), 0.02, 1.0)
    tilt = norm_f ** 0.5
    tilt /= tilt.mean() + 1e-12
    np.testing.assert_allclose(got, env * tilt[:, None], rtol=1e-4)


def test_env_shape_preserves_frame_means():
    env = _smooth_env(8)
    for amt in (-0.5, 0.7):
        got = np.asarray(env_mod.env_shape(jnp.asarray(env), amt))
        np.testing.assert_allclose(got.mean(axis=0), env.mean(axis=0),
                                   rtol=1e-3)


def test_formant_strength_gain():
    t = 5
    tracks = np.stack([np.full(t, 700.0), np.full(t, 1300.0),
                       np.full(t, 2500.0), np.full(t, 3600.0)]).astype(
                           np.float32)
    tracks[1, 2] = 10.0  # invalid: below 50 Hz -> no gain that frame
    strengths = (0.5, -0.3, 0.0, 0.2)
    gain = np.asarray(env_mod.formant_strength_gain(
        (N_BINS, t), jnp.asarray(tracks), strengths, SR))
    freqs = np.linspace(0, SR / 2, N_BINS, dtype=np.float32)
    want = np.ones((N_BINS, t), dtype=np.float64)
    sigmas = [100.0, 200.0, 350.0, 500.0]
    for j in range(t):
        for k in range(4):
            s = strengths[k]
            f = tracks[k, j]
            if abs(s) < 1e-6 or f <= 50.0 or f >= SR * 0.5:
                continue
            w = np.exp(-0.5 * ((freqs - f) / sigmas[k]) ** 2)
            want[:, j] *= 1.0 + s * w
    np.testing.assert_allclose(gain, want, rtol=1e-4, atol=1e-5)


def test_fry_env_shift():
    env = _smooth_env(4)
    w = np.array([0.0, 0.5, 1.0, 0.0], dtype=np.float32)
    got = np.asarray(env_mod.fry_env_shift(jnp.asarray(env), jnp.asarray(w)))
    # weight 0 frames unchanged
    np.testing.assert_allclose(got[:, 0], env[:, 0])
    np.testing.assert_allclose(got[:, 3], env[:, 3])
    # weight 1 frame: scale s = 0.92, column sampled at bin/s
    s = 1.0 - 1.0 * (1.0 - 0.92)
    src = np.clip(np.arange(N_BINS) / s, 0, N_BINS - 1)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, N_BINS - 1)
    frac = src - lo
    want = (1 - frac) * env[lo, 2] + frac * env[hi, 2]
    np.testing.assert_allclose(got[:, 2], want, rtol=1e-4, atol=1e-6)


def test_match_env_frames():
    env = _smooth_env(10)
    assert env_mod.match_env_frames(jnp.asarray(env), 6).shape == (N_BINS, 6)
    padded = np.asarray(env_mod.match_env_frames(jnp.asarray(env), 14))
    assert padded.shape == (N_BINS, 14)
    np.testing.assert_allclose(padded[:, 10:], env[:, 9:10].repeat(4, axis=1))


def test_knot_decode_bf16_optin(monkeypatch):
    """bfloat16 envelope-decode opt-in stays within the codec's own
    error budget."""
    import numpy as np
    import jax.numpy as jnp

    from goofer_tpu import config
    from goofer_tpu.ops.envelope import (
        compress_env_to_knots,
        decode_env_from_knots,
    )

    rng = np.random.default_rng(0)
    sr, n_fft = 44100, 1024
    n_bins = n_fft // 2 + 1
    env = np.exp(rng.standard_normal((n_bins, 40)) * 0.5).astype(np.float32)
    knots = compress_env_to_knots(env, sr, n_fft)

    ref = np.asarray(decode_env_from_knots(
        jnp.asarray(knots["knot_vals_log"], jnp.float32), sr, n_fft, n_bins))
    monkeypatch.setattr(config, "ENVELOPE_MATMUL_DTYPE", "bfloat16")
    got = np.asarray(decode_env_from_knots(
        jnp.asarray(knots["knot_vals_log"], jnp.float32), sr, n_fft, n_bins))
    rel = np.abs(got - ref) / (ref + 1e-8)
    assert rel.max() < 2e-2


def test_banded_gather_equals_gather():
    """banded_gather_lerp_columns must be float-equivalent to the
    per-element gather whenever the offset bound holds (the banded form
    replaces a per-element gather)."""
    import numpy as np

    from goofer_tpu.ops.envelope import (
        banded_gather_lerp_columns,
        gather_lerp_columns,
    )

    rng = np.random.default_rng(5)
    for _ in range(4):
        nb, t = 257, int(rng.integers(3, 60))
        env = jnp.asarray(rng.random((nb, t)).astype(np.float32))
        off = rng.uniform(-20, 20, size=(nb, t)).astype(np.float32)
        pos = np.clip(np.arange(nb)[:, None] + off, 0, nb - 1)
        got = np.asarray(banded_gather_lerp_columns(
            env, jnp.asarray(pos), -21, 21))
        want = np.asarray(gather_lerp_columns(env, jnp.asarray(pos)))
        np.testing.assert_allclose(got, want, atol=2e-6)


def test_banded_warp_matches_gather_warp():
    """warp_env_by_formants with a host-derived band == unbounded."""
    import numpy as np

    from goofer_tpu.ops.envelope import warp_env_by_formants

    rng = np.random.default_rng(1)
    sr = 44100
    nyq = sr / 2.0
    for _ in range(3):
        nb, t = 513, int(rng.integers(5, 80))
        env = jnp.asarray(rng.random((nb, t)).astype(np.float32))
        forms = np.stack([
            700 + 50 * rng.standard_normal(t),
            1200 + 80 * rng.standard_normal(t),
            2600 + 120 * rng.standard_normal(t),
            3400 + 150 * rng.standard_normal(t)]).astype(np.float32)
        forms[0, :3] = 0.0                  # invalid anchors
        ratios = 1.0 + rng.uniform(-0.2, 0.2, 4)
        shifted = (forms * ratios[:, None]).astype(np.float32)
        off = 0.0
        for k in range(4):
            valid = (np.isfinite(forms[k]) & (forms[k] > 50)
                     & (forms[k] < nyq) & (shifted[k] > 50))
            if np.any(valid):
                off = max(off, float(np.max(
                    np.abs(forms[k] - shifted[k])[valid])))
        band = int(np.ceil(off * (nb - 1) / nyq)) + 2
        got = np.asarray(warp_env_by_formants(
            env, jnp.asarray(forms), jnp.asarray(shifted), sr, band=band))
        want = np.asarray(warp_env_by_formants(
            env, jnp.asarray(forms), jnp.asarray(shifted), sr, band=0))
        np.testing.assert_allclose(got, want, atol=2e-6)
