"""Spectral-envelope codec and envelope-domain transforms.

The mel-knot codec compresses a (n_bins, T) spectral envelope to K
log-amplitude knots on a mel grid with an adaptive K search
(ref: GOOFER.py:74-168); decode is a dense (n_bins, K) @ (K, T) matmul
followed by exp.

The transform zoo mirrors the reference's envelope-domain flag effects:
global/per-formant frequency warps, width expansion, tilt, smoothing/
sharpening, and per-formant Gaussian strength bells, all vectorized over
frames instead of per-frame Python loops.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from goofer_tpu.config import COMPUTE_DTYPE
from goofer_tpu.ops.filters import gaussian_blur1d
from goofer_tpu.ops.interp import gather_lerp

KNOT_K_START = 32
KNOT_K_STEP = 16
KNOT_K_MAX = 192
KNOT_EPS = 1e-2


def hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + hz / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_knot_freqs(sr: int, n_fft: int, k: int) -> np.ndarray:
    """K knot frequencies equally spaced on the mel scale over [0, sr/2]
    (ref: GOOFER.py:77-82)."""
    mel_min, mel_max = hz_to_mel(0.0), hz_to_mel(sr / 2.0)
    mel_knots = np.linspace(mel_min, mel_max, k, dtype=COMPUTE_DTYPE)
    return mel_to_hz(mel_knots).astype(COMPUTE_DTYPE)


def interp_matrix(freqs_full: np.ndarray, hz_knots: np.ndarray) -> np.ndarray:
    """Sparse-in-spirit (n_bins, K) linear-interp matrix; env = exp(W @ knots)
    (ref: GOOFER.py:84-95)."""
    n = len(freqs_full)
    k = len(hz_knots)
    idx = np.searchsorted(hz_knots, freqs_full, side="right") - 1
    idx = np.clip(idx, 0, k - 2)
    x0 = hz_knots[idx]
    x1 = hz_knots[idx + 1]
    w1 = (freqs_full - x0) / np.maximum(x1 - x0, 1e-12)
    w0 = 1.0 - w1
    w = np.zeros((n, k), dtype=COMPUTE_DTYPE)
    rows = np.arange(n)
    w[rows, idx] = w0
    w[rows, idx + 1] = w1
    return w


@functools.lru_cache(maxsize=None)
def _decode_matrix(sr: int, n_fft: int, k: int) -> np.ndarray:
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr).astype(COMPUTE_DTYPE)
    return interp_matrix(freqs, mel_knot_freqs(sr, n_fft, k))


@functools.lru_cache(maxsize=None)
def _knot_bin_idx(sr: int, n_fft: int, k: int, n_bins: int) -> np.ndarray:
    bin_resolution = sr / n_fft
    hz_knots = mel_knot_freqs(sr, n_fft, k)
    return np.clip(np.round(hz_knots / bin_resolution).astype(np.int64),
                   0, n_bins - 1)


def decode_env_from_knots(knot_vals_log: jnp.ndarray, sr: int, n_fft: int,
                          n_bins: int) -> jnp.ndarray:
    """exp(W @ knots), truncated to n_bins rows (ref: GOOFER.py:149-168).

    The matmul runs in config.ENVELOPE_MATMUL_DTYPE (f32 default; bf16
    opt-in halves its memory traffic — the knots are fp16-stored anyway)
    and accumulates in f32."""
    from goofer_tpu.config import ENVELOPE_MATMUL_DTYPE

    k = knot_vals_log.shape[0]
    mm_dtype = jnp.dtype(ENVELOPE_MATMUL_DTYPE)
    w = jnp.asarray(_decode_matrix(sr, n_fft, k)).astype(mm_dtype)
    # f32 pins HIGHEST: a TF32 product's error is exponentiated into the
    # envelope; the bf16 opt-in keeps its own precision
    precision = (jax.lax.Precision.HIGHEST if mm_dtype == jnp.float32
                 else None)
    log_env = jnp.dot(w, knot_vals_log.astype(mm_dtype),
                      precision=precision,
                      preferred_element_type=jnp.float32)
    env = jnp.exp(log_env.astype(jnp.float32))
    if env.shape[0] != n_bins:
        env = env[:n_bins, :]
    return env


def _knot_errors(env: jnp.ndarray, sr: int, n_fft: int,
                 smooth_sigma_bins: float = 0.5):
    """Reconstruction error for every candidate K, plus the smoothed
    log-envelope the knots are read from (ref: GOOFER.py:97-123)."""
    env = env.astype(jnp.float32)
    if smooth_sigma_bins > 0:
        env_s = gaussian_blur1d(env, smooth_sigma_bins, axis=0)
    else:
        env_s = env
    log_env = jnp.log(jnp.maximum(env_s, 1e-8))
    n_bins, t = env.shape
    check_idx = np.linspace(0, t - 1, min(256, t)).astype(np.int64)
    env_check = env_s[:, check_idx]
    log_check = log_env[:, check_idx]

    errs = []
    k_values = list(range(KNOT_K_START, KNOT_K_MAX + 1, KNOT_K_STEP))
    for k in k_values:
        bin_idx = _knot_bin_idx(sr, n_fft, k, n_bins)
        knots = log_check[bin_idx, :]
        w = jnp.asarray(_decode_matrix(sr, n_fft, k))
        recon = jnp.exp(jnp.dot(w, knots,
                                precision=jax.lax.Precision.HIGHEST,
                                preferred_element_type=jnp.float32))
        rel = jnp.max(jnp.abs(recon - env_check) / (env_check + 1e-8))
        errs.append(rel)
    return jnp.stack(errs), log_env, k_values


def compress_env_to_knots(env, sr: int, n_fft: int, eps: float = KNOT_EPS):
    """Adaptive-K mel-knot compression returning the reference's dict layout
    (ref: GOOFER.py:97-147).  The K search evaluates every candidate on
    device in one dispatch and picks the first K under ``eps`` on host
    (fallback: K_max)."""
    env = jnp.asarray(env, dtype=jnp.float32)
    n_bins = env.shape[0]
    errs, log_env, k_values = _knot_errors(env, sr, n_fft)
    errs = np.asarray(errs)
    chosen = k_values[-1]
    for k, e in zip(k_values, errs):
        if e < eps:
            chosen = k
            break
    bin_idx = _knot_bin_idx(sr, n_fft, chosen, n_bins)
    knot_vals_log = np.asarray(log_env)[bin_idx, :]
    return {
        "mode": "knots",
        "knot_vals_log": knot_vals_log.astype(np.float16),
        "hz_knots": mel_knot_freqs(sr, n_fft, chosen),
        "n_bins": int(n_bins),
        "n_fft": int(n_fft),
        "sr": int(sr),
    }


# ---------------------------------------------------------------------------
# Envelope-domain transforms
# ---------------------------------------------------------------------------

def gather_lerp_columns(env: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """out[b, t] = env[pos[b, t], t] with linear interpolation and edge
    clamping; ``pos`` is a fractional row index per (bin, frame)."""
    n_bins = env.shape[0]
    pos = jnp.clip(pos, 0.0, n_bins - 1.0)
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, max(n_bins - 2, 0))
    frac = (pos - lo).astype(env.dtype)
    a = jnp.take_along_axis(env, lo, axis=0)
    b = jnp.take_along_axis(env, jnp.minimum(lo + 1, n_bins - 1), axis=0)
    return a * (1.0 - frac) + b * frac


def shift_formants_global(env: jnp.ndarray, shift_ratio: float,
                          sr: int) -> jnp.ndarray:
    """Global formant shift: resample each frame at freqs/ratio
    (ref: GOOFER.py:618-627)."""
    n_bins = env.shape[0]
    freqs = jnp.linspace(0.0, sr / 2.0, n_bins)
    warped = jnp.clip(freqs / shift_ratio, 0.0, sr / 2.0)
    pos = warped / (sr / 2.0) * (n_bins - 1)
    return gather_lerp(env, pos, axis=0)


def warp_env_by_formants(env: jnp.ndarray, orig_formants: jnp.ndarray,
                         shifted_formants: jnp.ndarray, sr: int,
                         band: int = 0) -> jnp.ndarray:
    """Per-formant piecewise-linear frequency warp (ref: GOOFER.py:840-875).

    Per frame, anchors map shifted->orig frequency: (0, 0), each valid
    formant pair (f_shifted, f_orig) where f_orig in (50, sr/2) and
    f_shifted > 50, and (sr/2, sr/2).  The envelope column is then resampled
    at the warped frequencies.  Invalid anchors are pushed past sr/2 via a
    per-frame sort so the anchor set is always 6 wide and sorted.
    """
    n_bins, n_frames = env.shape
    nyq = sr / 2.0
    freqs = jnp.linspace(0.0, nyq, n_bins)

    f_orig = orig_formants.astype(jnp.float32)      # (4, T)
    f_shift = shifted_formants.astype(jnp.float32)  # (4, T)
    valid = (f_orig > 50.0) & (f_orig < nyq) & (f_shift > 50.0)

    big = jnp.float32(nyq * 4.0)
    slot_bump = jnp.arange(1, 5, dtype=jnp.float32)[:, None]  # keep distinct
    dst_mid = jnp.where(valid, f_shift, big + slot_bump)
    src_mid = jnp.where(valid, f_orig, big + slot_bump)

    zeros = jnp.zeros((1, n_frames), dtype=jnp.float32)
    nyqs = jnp.full((1, n_frames), nyq, dtype=jnp.float32)
    dst = jnp.concatenate([zeros, dst_mid, nyqs], axis=0)  # (6, T)
    src = jnp.concatenate([zeros, src_mid, nyqs], axis=0)

    order = jnp.argsort(dst, axis=0)
    dst = jnp.take_along_axis(dst, order, axis=0)
    src = jnp.take_along_axis(src, order, axis=0)

    # Piecewise-linear eval of (dst -> src) at the uniform freq grid.
    # seg[b, t] = number of anchors <= freqs[b], minus one, clipped.
    cmp = (dst[None, :, :] <= freqs[:, None, None])  # (n_bins, 6, T)
    seg = jnp.clip(jnp.sum(cmp, axis=1) - 1, 0, 4)   # (n_bins, T)
    x0 = jnp.take_along_axis(dst, seg, axis=0)
    x1 = jnp.take_along_axis(dst, seg + 1, axis=0)
    y0 = jnp.take_along_axis(src, seg, axis=0)
    y1 = jnp.take_along_axis(src, seg + 1, axis=0)
    w = (freqs[:, None] - x0) / jnp.maximum(x1 - x0, 1e-10)
    warped_freqs = y0 + w * (y1 - y0)               # (n_bins, T)

    pos = warped_freqs / nyq * (n_bins - 1)
    # ``band``: host-derived bound on |pos - bin| (the warp's max anchor
    # deviation, sampler/resampler.py) routes the resample through the
    # banded dense-select form — ~20x the per-element gather when the
    # shifts are moderate.  band=0 (unknown/too wide) keeps the gather.
    if band and band < n_bins // 2:
        return banded_gather_lerp_columns(env, pos, -band, band)
    return gather_lerp_columns(env, pos)


def formant_width_warp(env: jnp.ndarray, amount: float) -> jnp.ndarray:
    """Stretch the envelope's bin axis away from its midpoint
    (ref: SillySampler.py:554-574)."""
    n_bins = env.shape[0]
    bins = jnp.arange(n_bins, dtype=jnp.float32)
    center = n_bins / 2.0
    warped = jnp.clip((bins - center) * (1.0 + amount) + center,
                      0.0, n_bins - 1.0)
    return gather_lerp(env, warped, axis=0)


def brightness_tilt(env: jnp.ndarray, brightness_env: float,
                    sr: int) -> jnp.ndarray:
    """Mean-normalized spectral tilt ``norm_f ** alpha``
    (ref: SillySampler.py:503-515)."""
    n_bins = env.shape[0]
    freqs = np.linspace(1e-6, sr * 0.5, n_bins, dtype=np.float32)
    norm_f = np.clip(freqs / (sr * 0.5), 0.02, 1.0)
    alpha = float(np.clip(brightness_env - 1.0, -0.9, 1.0))
    tilt = norm_f ** alpha
    tilt = tilt / (tilt.mean() + 1e-12)
    return env * jnp.asarray(tilt[:, None], dtype=env.dtype)


def _match_frame_means(orig: jnp.ndarray, mod: jnp.ndarray) -> jnp.ndarray:
    m0 = jnp.mean(orig, axis=0, keepdims=True)
    m1 = jnp.mean(mod, axis=0, keepdims=True)
    return mod * (m0 / (m1 + 1e-12))


def env_shape(env: jnp.ndarray, shape_amt: float) -> jnp.ndarray:
    """Envelope smoothing (shape_amt < 0) or unsharp-mask sharpening
    (shape_amt > 0), frame-mean preserving (ref: SillySampler.py:518-551)."""
    if shape_amt == 0.0 or env.size == 0:
        return env
    s = abs(float(shape_amt))
    if shape_amt < 0.0:
        sigma = 1.0 + 6.0 * s
        blur = gaussian_blur1d(env, sigma, axis=0)
        return jnp.maximum(0.0, _match_frame_means(env, blur))
    sigma = 0.8 + 4.0 * s
    amount = 5.0 * s
    blur = gaussian_blur1d(env, sigma, axis=0)
    out = jnp.maximum(0.0, env + amount * (env - blur))
    return _match_frame_means(env, out)


def env_shape_traced(env: jnp.ndarray, es) -> jnp.ndarray:
    """Traced-amount env_shape for the universal fallback graph
    (render_core.RenderStatic.universal): both branches run with
    traced-sigma blurs (static max window) and the sign of ``es``
    selects; es == 0 is an exact identity.  For |es| <= 1 the blur taps
    equal the static path's exactly (gaussian_blur1d_traced)."""
    from goofer_tpu.ops.filters import gaussian_blur1d_traced

    es = jnp.asarray(es, jnp.float32)
    s = jnp.abs(es)
    blur_sm = gaussian_blur1d_traced(env, 1.0 + 6.0 * s, max_sigma=7.0,
                                     axis=0)
    smooth = jnp.maximum(0.0, _match_frame_means(env, blur_sm))
    blur_sh = gaussian_blur1d_traced(env, 0.8 + 4.0 * s, max_sigma=4.8,
                                     axis=0)
    sharp = _match_frame_means(
        env, jnp.maximum(0.0, env + (5.0 * s) * (env - blur_sh)))
    return jnp.where(es < 0.0, smooth, jnp.where(es > 0.0, sharp, env))


FORMANT_BELL_SIGMAS_HZ = (100.0, 200.0, 350.0, 500.0)


def formant_strength_gain(env_shape_2d, formant_tracks: jnp.ndarray,
                          strengths, sr: int) -> jnp.ndarray:
    """Per-formant Gaussian gain bells (ref: SillySampler.py:791-833).

    ``formant_tracks`` is (4, T); ``strengths`` a static 4-tuple.  Returns a
    (n_bins, T) multiplicative gain.  Frames where a formant is outside
    (50, sr/2) contribute no gain for that formant.
    """
    n_bins, _ = env_shape_2d
    freqs = jnp.linspace(0.0, sr / 2.0, n_bins, dtype=jnp.float32)
    gain = None
    for k in range(4):
        s_val = float(strengths[k])
        if abs(s_val) < 1e-6:
            continue
        fk = formant_tracks[k]
        ok = jnp.isfinite(fk) & (fk > 50.0) & (fk < sr * 0.5)
        sigma = FORMANT_BELL_SIGMAS_HZ[k]
        w = jnp.exp(-0.5 * ((freqs[:, None] - fk[None, :]) / sigma) ** 2)
        factor = 1.0 + s_val * w * ok[None, :].astype(jnp.float32)
        gain = factor if gain is None else gain * factor
    if gain is None:
        return jnp.ones((1, 1), dtype=jnp.float32)
    return gain


def match_env_frames(env: jnp.ndarray, target_frames: int) -> jnp.ndarray:
    """Truncate or edge-pad the frame axis (ref: GOOFER.py:629-635)."""
    t = env.shape[1]
    if t > target_frames:
        return env[:, :target_frames]
    if t < target_frames:
        return jnp.pad(env, ((0, 0), (0, target_frames - t)), mode="edge")
    return env


def banded_gather_lerp_columns(env: jnp.ndarray, pos: jnp.ndarray,
                               k_lo: int, k_hi: int) -> jnp.ndarray:
    """gather_lerp_columns for positions whose offset from the identity
    (pos[j] - j) is STATICALLY bounded to [k_lo, k_hi]: the per-element
    gather becomes k_hi-k_lo+1 shifted dense selects.  Whether that still
    beats a plain gather on the GPU is not measured (ROADMAP.md).

    Exactly equivalent to gather_lerp_columns when the bound holds;
    offsets outside the band would read the wrong rows — callers derive
    the band conservatively on the host."""
    n_bins = env.shape[0]
    pos = jnp.clip(pos, 0.0, n_bins - 1.0)
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, max(n_bins - 2, 0))
    frac = (pos - lo).astype(env.dtype)
    d = lo - jnp.arange(n_bins, dtype=jnp.int32)[:, None]
    k_lo = min(k_lo, -1)               # lo clamps to n_bins-2 at the top
    # pad below by |k_lo| and above so every shifted slice is in-range
    bot = jnp.broadcast_to(env[:1, :], (-k_lo,) + env.shape[1:])
    top = jnp.broadcast_to(env[-1:, :], (k_hi + 2,) + env.shape[1:])
    env_p = jnp.concatenate([bot, env, top], axis=0)
    base = -k_lo
    a = jnp.zeros_like(env)
    b = jnp.zeros_like(env)
    for k in range(k_lo, k_hi + 1):
        sel = (d == k).astype(env.dtype)
        a = a + env_p[base + k:base + k + n_bins] * sel
        b = b + env_p[base + k + 1:base + k + 1 + n_bins] * sel
    return a * (1.0 - frac) + b * frac


def fry_env_shift(env: jnp.ndarray, fry_weight_frames: jnp.ndarray,
                  shift: float = 0.92) -> jnp.ndarray:
    """Per-frame envelope compression toward low frequencies under the fry
    mask (ref: SillySampler.py:967-996): scale s = 1 - w*(1 - shift),
    column resampled at bin/s.

    Banded formulation: s >= shift (STATIC), so the source offset
    d = bin/s - bin is bounded by n_bins*(1/shift - 1) (~45 rows at
    0.92) — the gather becomes K shifted dense selects instead of a
    (bin, frame)-indexed take_along_axis."""
    n_bins = env.shape[0]
    s = 1.0 - fry_weight_frames * (1.0 - shift)  # (T,) in [shift, 1]
    bins = jnp.arange(n_bins, dtype=jnp.float32)[:, None]
    pos = jnp.clip(bins / s[None, :], 0.0, n_bins - 1.0)
    k_max = int(np.ceil(n_bins * (1.0 / shift - 1.0))) + 1
    warped = banded_gather_lerp_columns(env, pos, -1, k_max)
    keep = jnp.abs(s - 1.0) < 1e-6
    return jnp.where(keep[None, :], env, warped)
