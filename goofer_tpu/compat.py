"""GOOFER.py-compatible module surface.

``import goofer_tpu.compat as gf`` exposes the same function names and
signatures as the reference engine module, so code written against
``import GOOFER as gf`` ports by changing one import.  Hot paths dispatch
to the jitted device ops; small host utilities are NumPy.

Each symbol cites its reference definition.  Stochastic functions accept
an optional ``seed`` like the reference; parity is spectral, not
sample-exact (different RNG streams).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from goofer_tpu import config
from goofer_tpu.analysis.formants import track_formants
from goofer_tpu.analysis.pitch import PitchConfig, track_pitch
from goofer_tpu.analysis.pitch import fix_f0_gaps as _fix_f0_gaps_op
from goofer_tpu.io.goofy import (  # noqa: F401  (re-exports)
    formants_to_int_keys,
    load_features,
    pad_trim_to_len,
    save_features,
)
from goofer_tpu.models.hnm import (  # noqa: F401
    extract_features,
    synthesize,
)
from goofer_tpu.ops import envelope as _env
from goofer_tpu.ops import filters as _filters
from goofer_tpu.ops import jitter as _jitter
from goofer_tpu.ops import pulse as _pulse
from goofer_tpu.ops import scan_iir as _iir
from goofer_tpu.ops import stft as _stft
from goofer_tpu.ops.windows import (
    boost_curve as _boost,
    brightness_curve as _bright,
    brightness_curves as _brights,
    rfft_freqs as _freqs,
    sqrt_hann_window as _win,
)

DSTORAGE = config.STORAGE_DTYPE
DCOMPUTE = config.COMPUTE_DTYPE


# -- caches (ref: GOOFER.py:12-46); here pure memoized constructors --------

def get_cached_window(sr, n_fft):
    return _win(n_fft)


def get_cached_freqs(sr, n_fft):
    return _freqs(sr, n_fft)


def get_cached_boost(sr, n_fft):
    return _boost(n_fft)


def get_cached_brightness(sr, n_fft):
    return _brights(sr, n_fft)


def to_compute(x):
    return np.asarray(x, dtype=DCOMPUTE)


# -- mel-knot codec (ref: GOOFER.py:74-168) --------------------------------

hz_to_mel = _env.hz_to_mel
mel_to_hz = _env.mel_to_hz


def make_mel_knots(sr, n_fft, K):
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr).astype(DCOMPUTE)
    return freqs, _env.mel_knot_freqs(sr, n_fft, K)


def precompute_interp_matrix(freqs_full, hz_knots):
    return _env.interp_matrix(np.asarray(freqs_full), np.asarray(hz_knots))


def compress_env_to_knots(env_spec, sr, n_fft, eps=1e-2, K_start=32,
                          K_step=16, K_max=192, smooth_sigma_bins=0.5):
    return _env.compress_env_to_knots(env_spec, sr, n_fft, eps=eps)


def decode_env_from_knots(env_pack):
    assert env_pack["mode"] == "knots"
    return np.asarray(_env.decode_env_from_knots(
        jnp.asarray(np.asarray(env_pack["knot_vals_log"]),
                    dtype=jnp.float32),
        int(env_pack["sr"]), int(env_pack["n_fft"]),
        int(env_pack["n_bins"])))


# -- math utils (ref: GOOFER.py:170-285) -----------------------------------

def rms(x):
    return float(np.sqrt(np.mean(np.square(x)) + 1e-12))


def interp1d(x, y, kind="linear", fill_value="extrapolate"):
    """Closure-factory linear interpolator with the reference's
    extrapolation semantics (ref: GOOFER.py:173-239)."""
    if kind != "linear":
        raise ValueError("Only 'linear' interpolation is supported.")
    x = np.asarray(x)
    y = np.asarray(y)
    if len(x) == 0:
        raise ValueError("x cannot be empty")
    if len(x) == 1:
        x0, y0 = x[0], y[0]

        def single(x_new):
            x_new = np.asarray(x_new)
            if fill_value == "extrapolate":
                return np.full_like(x_new, y0, dtype=y.dtype)
            fv = float(fill_value)
            out = np.full_like(x_new, fv)
            out[np.isclose(x_new, x0)] = y0
            return out

        return single

    sl = (y[1] - y[0]) / (x[1] - x[0] + 1e-10)
    sr_ = (y[-1] - y[-2]) / (x[-1] - x[-2] + 1e-10)

    def interp(x_new):
        x_new = np.asarray(x_new)
        out = np.interp(x_new, x, y)
        if fill_value == "extrapolate":
            lo = x_new < x[0]
            hi = x_new > x[-1]
            out = np.where(lo, y[0] + sl * (x_new - x[0]), out)
            out = np.where(hi, y[-1] + sr_ * (x_new - x[-1]), out)
        else:
            fv = float(fill_value)
            inside = (x_new >= x[0]) & (x_new <= x[-1])
            out = np.where(inside, out, fv)
        return out

    return interp


def gaussian_filter1d(input_array, sigma, axis=-1, truncate=4.0):
    arr = np.asarray(input_array)
    if arr.size == 0 or arr.shape[axis] == 0 or sigma <= 0.0:
        return arr.copy()
    return np.asarray(_filters.gaussian_blur1d(
        jnp.asarray(arr, dtype=jnp.float32), float(sigma), axis=axis,
        truncate=truncate))


def gaussian_filter(input_array, sigma):
    arr = np.asarray(input_array)
    if arr.ndim != 2:
        raise ValueError("gaussian_filter expects a 2D array.")
    if arr.size == 0:
        return arr.copy()
    if isinstance(sigma, (list, tuple)):
        s0, s1 = (max(float(s), 0.0) for s in sigma)
    else:
        s0 = s1 = max(float(sigma), 0.0)
    out = arr
    if s0 > 0:
        out = gaussian_filter1d(out, s0, axis=0)
    if s1 > 0:
        out = gaussian_filter1d(out, s1, axis=1)
    return out


# -- analysis (ref: GOOFER.py:341-353, 415-435, 768-792) -------------------

def f0_estimate(y, sr, fr_duration, f0_min=75, f0_max=950):
    """Praat-AC-equivalent pitch track.  Signature differs from the
    reference only in taking (y, sr) instead of a parselmouth Sound."""
    return track_pitch(jnp.asarray(np.asarray(y), dtype=jnp.float32),
                       sr, fr_duration,
                       PitchConfig(f0_min=f0_min, f0_max=f0_max))


def fix_f0_gaps(f0_array, max_gap=4):
    return np.asarray(_fix_f0_gaps_op(jnp.asarray(
        np.asarray(f0_array, dtype=np.float32)), max_gap))


def extract_formants(y, sr, hop_length, max_formants=5, target_frames=None):
    tracks = track_formants(jnp.asarray(np.asarray(y), dtype=jnp.float32),
                            sr, hop_length / sr, max_formants=max_formants,
                            target_frames=target_frames)
    return {i + 1: list(tracks[i]) for i in range(tracks.shape[0])}


# -- STFT (ref: GOOFER.py:355-413) -----------------------------------------

def stft(x, n_fft=2048, hop_length=512, window=None):
    return np.asarray(_stft.stft(jnp.asarray(np.asarray(x),
                                             dtype=jnp.float32),
                                 n_fft, hop_length, window))


def istft(S, hop_length=512, window=None, length=None):
    return np.asarray(_stft.istft(jnp.asarray(np.asarray(S)),
                                  hop_length, window, length))


# -- glottal source (ref: GOOFER.py:437-554, 571-583) ----------------------

def lf_model_pulse(T, Ra=0.01, Rg=1.47, Rk=0.34, sr=44100, smoothing=False):
    """Single LF pulse sampled over one period (ref: GOOFER.py:437-471)."""
    T0 = int(round(sr * T))
    if T0 <= 3:
        T0 = 3
    u = np.arange(T0) / T0
    vals = np.asarray(_pulse.lf_pulse_value(
        jnp.asarray(u, dtype=jnp.float32), jnp.float32(T), Ra, Rg, Rk,
        guard=False))
    if smoothing:
        vals = _smooth_arx_pulse(vals, T0)
    peak = np.max(np.abs(vals))
    if peak > 0:
        vals = vals / peak
    return vals.astype(np.float32)


def _smooth_arx_pulse(pulse, T0_samples):
    out = np.asarray(pulse).copy()
    if len(pulse) > 5:
        sigma = max(1, T0_samples // 20)
        out = gaussian_filter1d(out, sigma=sigma)
    closed = int(T0_samples * 0.7)
    if closed < len(out):
        out[closed:] = 0.0
    return out


def pulse_train_numba(f0_interp, sr, Ra=0.02, Rg=1.7, Rk=0.8):
    """Name kept for drop-in compatibility; the implementation is the
    vectorized gather kernel (ops/pulse.py), not Numba."""
    return np.asarray(_pulse.pulse_train(
        jnp.asarray(np.asarray(f0_interp), dtype=jnp.float32), sr,
        Ra=Ra, Rg=Rg, Rk=Rk)).astype(np.float32)


def add_subharms(f0_interp, sr, subharm_weight=0.5, subharm_semitones=-12,
                 voicing_mask=None):
    f0 = np.asarray(f0_interp, dtype=np.float32)
    if voicing_mask is None:
        voicing_mask = (f0 > 0).astype(np.float32)
    return np.asarray(_pulse.subharm_pulse_train(
        jnp.asarray(f0), sr, jnp.asarray(np.asarray(voicing_mask,
                                                    dtype=np.float32)),
        subharm_semitones, subharm_weight))


def add_multiple_subharms(f0_interp, sr, semitone_list=(-12, 12),
                          weights=None, voicing_mask=None):
    """Weighted sum of independently-normalized subharmonic layers
    (ref: GOOFER.py:738-746)."""
    semitone_list = list(semitone_list)
    if weights is None:
        weights = [1.0 / len(semitone_list)] * len(semitone_list)
    total = np.zeros_like(np.asarray(f0_interp, dtype=np.float32))
    for semi, w in zip(semitone_list, weights):
        total = total + add_subharms(f0_interp, sr,
                                     voicing_mask=voicing_mask,
                                     subharm_weight=w,
                                     subharm_semitones=semi)
    return total


def apply_subharm_vibrato(f0_interp, sr, vibrato_rate=6.0, vibrato_depth=0.1,
                          vibrato_delay=0.1, seed=None):
    return np.asarray(_jitter.subharm_vibrato(
        jnp.asarray(np.asarray(f0_interp), dtype=jnp.float32), sr,
        vibrato_rate, vibrato_depth, vibrato_delay))


# -- texture (ref: GOOFER.py:556-670, 894-938) -----------------------------

def smooth_mask_ds(mask, sigma=100, ds=4):
    return np.asarray(_filters.smooth_mask_downsampled(
        jnp.asarray(np.asarray(mask), dtype=jnp.float32), sigma, ds))


def create_brightness_curve(n_bins, sr, start_hz=4000, end_hz=4500,
                            gain_db=6.0):
    return _bright(n_bins, sr, start_hz, end_hz, gain_db)


def create_volume_jitter(length, sr, speed=6.0, strength=0.1, seed=None,
                         vibrato=False):
    key = jax.random.PRNGKey(0 if seed is None else seed)
    return np.asarray(_jitter.volume_jitter(key, length, sr, speed,
                                            strength, vibrato))


def apply_f0_jitter(f0_array, sr, speed=40.0, strength=0.04, seed=None):
    key = jax.random.PRNGKey(0 if seed is None else seed)
    return np.asarray(_jitter.f0_jitter(key, len(f0_array), sr, speed,
                                        strength))


def make_smooth_noise(length, sr, smooth_ms=120.0, seed=None):
    key = jax.random.PRNGKey(0 if seed is None else seed)
    return np.asarray(_jitter.smooth_noise(key, length, sr, smooth_ms))


def one_pole_highpass(x, sr, fc):
    return np.asarray(_iir.one_pole_highpass(
        jnp.asarray(np.asarray(x), dtype=jnp.float32), sr, fc))


def apply_vocal_roughness(y, f0_interp, voicing_mask, sr, k_list=(2, 3, 4),
                          h_list=None, alpha=0.6, hp_fc=300.0,
                          noise_amp=0.6, noise_smooth_ms=120.0,
                          alpha_slew_ms=120.0):
    return np.asarray(_jitter.vocal_roughness(
        jax.random.PRNGKey(0),
        jnp.asarray(np.asarray(y), dtype=jnp.float32),
        jnp.asarray(np.asarray(f0_interp), dtype=jnp.float32),
        jnp.asarray(np.asarray(voicing_mask), dtype=jnp.float32),
        sr, k_list=k_list, h_list=h_list, alpha=alpha, hp_fc=hp_fc,
        noise_amp=noise_amp, noise_smooth_ms=noise_smooth_ms,
        alpha_slew_ms=alpha_slew_ms))


# -- envelope transforms (ref: GOOFER.py:585-875) --------------------------

def stretch_feature(feature, stretch, kind="linear"):
    from goofer_tpu.ops.interp import resample_1d, resample_2d

    feature = np.asarray(feature)
    if stretch == 1.0:
        return feature.copy()
    target = int(feature.shape[-1] * stretch)
    if feature.ndim == 1:
        return np.asarray(resample_1d(jnp.asarray(feature), target))
    if feature.ndim == 2:
        return np.asarray(resample_2d(jnp.asarray(feature), target))
    raise ValueError("Only 1D or 2D features are supported.")


def shift_formants(env, shift_ratio, sr):
    return np.asarray(_env.shift_formants_global(
        jnp.asarray(np.asarray(env), dtype=jnp.float32), shift_ratio, sr))


def match_env_frames(env, target_frames):
    return np.asarray(_env.match_env_frames(
        jnp.asarray(np.asarray(env)), target_frames))


def transpose_formants(formant_tracks, shift_ratios):
    """Dict version (ref: GOOFER.py:794-803)."""
    return {i: np.array(track) * shift_ratios.get(i, 1.0)
            for i, track in formant_tracks.items()}


def transpose_formants_array(formant_array, shift_ratios):
    """(4, T) array version (ref: GOOFER.py:805-812)."""
    ratios = np.asarray(shift_ratios, dtype=np.float64)
    return np.asarray(formant_array) * ratios[:, None]


def warp_env_by_formants(env, orig_formants, shifted_formants, sr):
    return np.asarray(_env.warp_env_by_formants(
        jnp.asarray(np.asarray(env), dtype=jnp.float32),
        jnp.asarray(np.asarray(orig_formants), dtype=jnp.float32),
        jnp.asarray(np.asarray(shifted_formants), dtype=jnp.float32), sr))
