"""Stochastic texture modulators: volume/F0 jitter, vibrato, roughness.

RNG discipline: the reference uses the global unseeded NumPy RNG for noise
(ref: GOOFER.py:638-670, 894-899); here every stochastic op takes an explicit
``jax.random`` key.  Parity with the reference is spectral (LSD), not
sample-exact, so differing noise realizations are acceptable by design.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from goofer_tpu.ops.filters import gaussian_blur1d
from goofer_tpu.ops.scan_iir import one_pole_highpass


def smoothed_unit_noise(key, length: int, sigma: float) -> jnp.ndarray:
    """Gaussian noise blurred then peak-normalized, the common core of the
    jitter generators (ref: GOOFER.py:653-655, 666-668).

    For large sigma the process is generated on a ds-decimated grid
    (white noise + sigma/ds blur) and linearly upsampled: the blur's
    bandwidth (~0.6/sigma cycles/sample) sits far below the coarse
    Nyquist (0.5/ds at sigma/ds >= 8), so the normalized spectrum is
    unchanged to measurement accuracy (pinned in tests/test_ops.py)
    while the full-rate PRNG + O(n log n) blur shrink by ds.  Parity
    with the reference is spectral by design (module docstring), and
    the upsample is a dense reshape/broadcast — positions form a
    uniform ramp — not a per-element gather."""
    ds = 1
    while sigma / (2 * ds) >= 8.0 and ds < 64:
        ds *= 2
    if ds == 1:
        noise = jax.random.normal(key, (length,), dtype=jnp.float32)
        noise = gaussian_blur1d(noise, sigma)
        return noise / jnp.max(jnp.abs(noise) + 1e-6)
    m = length // ds + 2
    c = jax.random.normal(key, (m,), dtype=jnp.float32)
    c = gaussian_blur1d(c, sigma / ds)
    frac = jnp.arange(ds, dtype=jnp.float32) / ds               # (ds,)
    seg = c[:-1, None] * (1.0 - frac) + c[1:, None] * frac      # (m-1, ds)
    noise = seg.reshape(-1)[:length]
    return noise / jnp.max(jnp.abs(noise) + 1e-6)


def volume_jitter(key, length: int, sr: float, speed: float = 6.0,
                  strength: float = 0.1, vibrato: bool = False) -> jnp.ndarray:
    """Multiplicative volume envelope (ref: GOOFER.py:638-660).

    vibrato=True: zero-phase sinusoid at ``speed`` Hz with a 0.1 s fade-in,
    clipped to [0.5, 1.5].  Otherwise smoothed unit noise, unclipped.
    """
    t = jnp.arange(length, dtype=jnp.float32) / sr
    if vibrato:
        noise = jnp.sin(2.0 * jnp.pi * speed * t)
        fade_samples = int(0.1 * sr)
        if 0 < fade_samples < length:
            fade = jnp.concatenate([
                jnp.linspace(0.0, 1.0, fade_samples),
                jnp.ones((length - fade_samples,), dtype=jnp.float32),
            ])
            noise = noise * fade
        env = 1.0 + noise * strength
        return jnp.clip(env, 0.5, 1.5)
    noise = smoothed_unit_noise(key, length, sr / (speed * 6.0))
    return 1.0 + noise * strength


def f0_jitter(key, length: int, sr: float, speed: float = 40.0,
              strength: float = 0.04) -> jnp.ndarray:
    """Multiplicative pitch wobble 1 + noise*strength (ref: GOOFER.py:662-670)."""
    noise = smoothed_unit_noise(key, length, sr / (speed * 6.0))
    return 1.0 + noise * strength


def subharm_vibrato(f0: jnp.ndarray, sr: float, rate: float = 6.0,
                    depth: float = 0.1, delay: float = 0.1) -> jnp.ndarray:
    """Sinusoidal vibrato on the subharmonic f0 track, voiced samples only,
    with a linear fade-in over ``delay`` seconds (ref: GOOFER.py:748-766).
    Phase is zero, matching the reference's unseeded call sites."""
    n = f0.shape[0]
    t = jnp.arange(n, dtype=jnp.float32) / sr
    vib = jnp.sin(2.0 * jnp.pi * rate * t)
    fade_samples = int(delay * sr)
    if 0 < fade_samples < n:
        fade = jnp.concatenate([
            jnp.linspace(0.0, 1.0, fade_samples),
            jnp.ones((n - fade_samples,), dtype=jnp.float32),
        ])
        vib = vib * fade
    voiced = f0 > 0
    return jnp.where(voiced, f0 * (1.0 + vib * depth), f0)


def smooth_noise(key, length: int, sr: float,
                 smooth_ms: float = 120.0) -> jnp.ndarray:
    """Gaussian-blurred noise, not normalized (ref: GOOFER.py:894-899)."""
    n = jax.random.normal(key, (length,), dtype=jnp.float32)
    sigma = max(1.0, (smooth_ms * 1e-3 * sr) / 6.0)
    return gaussian_blur1d(n, sigma)


def vocal_roughness(key, y: jnp.ndarray, f0: jnp.ndarray, mask: jnp.ndarray,
                    sr: float, k_list=(2, 3, 4), h_list=None,
                    alpha: float = 0.6, hp_fc: float = 300.0,
                    noise_amp: float = 0.6, noise_smooth_ms: float = 120.0,
                    alpha_slew_ms: float = 120.0) -> jnp.ndarray:
    """Amplitude-modulate the harmonic part with noisy sub-multiples of F0
    and mix back only the high-passed modulation residue, gated by a slewed
    voicing-scaled alpha (ref: GOOFER.py:901-938)."""
    y = jnp.asarray(y, dtype=jnp.float32)
    f0 = jnp.asarray(f0, dtype=jnp.float32)
    mask = jnp.asarray(mask, dtype=jnp.float32)
    n = y.shape[0]

    k_list = list(k_list)
    if h_list is None:
        h_list = [0.45, 0.28, 0.18][: len(k_list)]
        while len(h_list) < len(k_list):
            h_list.append(h_list[-1] * 0.6)
    h_list = list(h_list)[: len(k_list)]

    mod_sum = jnp.zeros((n,), dtype=jnp.float32)
    for idx, (k, hk) in enumerate(zip(k_list, h_list)):
        # The reference seeds these noises deterministically (1337 + idx).
        nz = smooth_noise(jax.random.fold_in(key, 1337 + idx), n, sr,
                          noise_smooth_ms)
        f_mod = (f0 / float(k)) * (1.0 + noise_amp * nz)
        f_mod = jnp.maximum(f_mod, 0.0) * mask
        phase = 2.0 * jnp.pi * jnp.cumsum(f_mod) / float(sr)
        mod_sum = mod_sum + hk * jnp.cos(phase)

    y_sub = y * mod_sum  # y*(1+mod) - y
    y_sub_hp = one_pole_highpass(y_sub, sr, hp_fc)

    sigma = max(1.0, (alpha_slew_ms * 1e-3 * sr) / 6.0)
    alpha_slewed = gaussian_blur1d(alpha * mask, sigma)
    return y + alpha_slewed * y_sub_hp
