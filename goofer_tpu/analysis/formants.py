"""Burg-LPC formant tracker, replacing Praat's C++ ``to_formant_burg``
(ref: GOOFER.py:768-792, called with time_step = hop/sr, max 5 formants).

Praat-equivalent pipeline, fully batched over frames:

1. anti-alias lowpass + linear resample to 2 * max_formant_hz (11 kHz for
   the 5.5 kHz default ceiling);
2. pre-emphasis from 50 Hz;
3. Gaussian-windowed frames of 2 * 0.025 s, Burg recursion of order
   2 * max_formants (a lax.fori over the order, vectorized over frames);
4. polynomial roots via batched Durand-Kerner iteration (no batched
   nonsymmetric eigensolver runs on every backend; DK is branch-free and
   converges in ~40 fixed iterations for order-10 LPC polynomials);
5. root angles -> formant frequencies, filtered to [50, nyquist-50] and
   sorted ascending; missing formants are 0.0 like the reference's
   None -> 0.0 mapping (ref: GOOFER.py:778-781).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _lowpass_kernel(cutoff_frac: float, taps: int = 127) -> np.ndarray:
    """Windowed-sinc FIR lowpass; cutoff as a fraction of Nyquist."""
    m = np.arange(taps) - (taps - 1) / 2.0
    h = np.sinc(cutoff_frac * m) * cutoff_frac
    h *= np.hamming(taps)
    return (h / h.sum()).astype(np.float32)


def _formant_decim(sr: float, max_formant_hz: float) -> int:
    """Integer decimation factor for the Burg analysis rate: the largest
    power of two <= sr / (2*max_formant_hz) that divides common hops.
    44.1k -> 4 (11025 Hz), 48k -> 4 (12000 Hz), 22.05k -> 2 (11025 Hz).
    The analysis rate lands slightly ABOVE Praat's exact 2*ceiling
    resample (11025 vs 11000 at 44.1k, <0.3% — far inside the formant
    budgets); in exchange the decimation is an exact strided slice and
    the frame stride hop/decim stays integral, so framing rides the
    slice-based path instead of a per-element row gather."""
    d = 1
    while d * 2 <= 256 and sr / (d * 2) >= 2.0 * max_formant_hz:
        d *= 2
    return d


def _resample_to(y: jnp.ndarray, sr: float, target_sr: float) -> jnp.ndarray:
    """Anti-aliased linear resample (downsample only)."""
    from goofer_tpu.ops.filters import fft_conv_valid

    if target_sr >= sr:
        return y, sr
    kernel = _lowpass_kernel(target_sr / sr)
    pad = (len(kernel) - 1) // 2
    yp = jnp.pad(y, pad, mode="edge")
    # a 127-tap direct conv over a full waveform: the pow2-padded FFT
    # path is far cheaper to compile and run
    filt = fft_conv_valid(yp[None, :], kernel)[0]
    n_out = int(round(y.shape[0] * target_sr / sr))
    pos = jnp.arange(n_out) * (sr / target_sr)
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, y.shape[0] - 2)
    frac = (pos - lo).astype(jnp.float32)
    return filt[lo] * (1 - frac) + filt[lo + 1] * frac, target_sr


def _decimate(y: jnp.ndarray, sr: float, decim: int):
    """Anti-aliased exact decimation: FIR lowpass + [::decim] slice."""
    from goofer_tpu.ops.filters import fft_conv_valid

    if decim <= 1:
        return y, sr
    kernel = _lowpass_kernel(1.0 / decim)
    pad = (len(kernel) - 1) // 2
    yp = jnp.pad(y, pad, mode="edge")
    filt = fft_conv_valid(yp[None, :], kernel)[0]
    return filt[::decim], sr / decim


@functools.partial(jax.jit, static_argnums=(1, 2))
def _burg_coeffs(frames: jnp.ndarray, order: int, wlen: int) -> jnp.ndarray:
    """Batched Burg recursion.  frames: (F, wlen) windowed; returns LPC
    polynomial coefficients a[0..order] with a[0] = 1, shape (F, order+1)."""
    nf = frames.shape[0]
    f = frames
    b = frames
    a = jnp.zeros((nf, order + 1), dtype=jnp.float32).at[:, 0].set(1.0)

    col = jnp.arange(wlen)

    def body(m, carry):
        f, b, a = carry
        # active region: indices m..wlen-1 for f, m-1..wlen-2 for b(shifted)
        mask = (col >= m).astype(jnp.float32)[None, :]
        b_sh = jnp.roll(b, 1, axis=1)  # b[i-1] aligned with f[i]
        num = jnp.sum(f * b_sh * mask, axis=1)
        den = jnp.sum((f * f + b_sh * b_sh) * mask, axis=1)
        k = -2.0 * num / jnp.maximum(den, 1e-20)          # (F,)
        f_new = f + k[:, None] * b_sh
        b_new = b_sh + k[:, None] * f
        f_new = f_new * mask
        b_new = b_new * mask

        # a_new[i] = a[i] + k * a[m - i]
        rev = jnp.flip(a, axis=1)  # rev[j] = a[order - j]
        a_shift = jnp.roll(rev, m - order, axis=1)  # -> a[m - i] at slot i
        idx = jnp.arange(order + 1)
        a_ref = jnp.where((idx <= m)[None, :], a_shift, 0.0)
        a_new = a + k[:, None] * a_ref
        return f_new, b_new, a_new

    f, b, a = jax.lax.fori_loop(1, order + 1, body, (f, b, a))
    return a


@functools.partial(jax.jit, static_argnums=(1, 2))
def _poly_roots_dk(coeffs: jnp.ndarray, order: int,
                   iters: int = 60) -> jnp.ndarray:
    """Batched Durand-Kerner root finder.  coeffs: (F, order+1), monic
    leading coefficient required.  Returns (F, order) complex roots."""
    nf = coeffs.shape[0]
    c = coeffs.astype(jnp.complex64)

    angles = 2.0 * np.pi * (np.arange(order) + 0.25) / order
    z0 = (0.9 * np.exp(1j * angles)).astype(np.complex64)
    z = jnp.broadcast_to(z0, (nf, order))

    def poly_eval(z):
        out = jnp.zeros_like(z) + c[:, 0:1]
        for i in range(1, order + 1):
            out = out * z + c[:, i:i + 1]
        return out

    def step(_, z):
        pz = poly_eval(z)
        diff = z[:, :, None] - z[:, None, :]          # (F, r, r)
        eye = jnp.eye(order, dtype=jnp.complex64)[None]
        diff = diff + eye
        denom = jnp.prod(diff, axis=2)
        upd = pz / jnp.where(jnp.abs(denom) < 1e-20,
                             jnp.complex64(1e-20), denom)
        return z - upd

    return jax.lax.fori_loop(0, iters, step, z)


def formant_frame_grid(n_samples: int, sr: float, dt: float,
                       max_formant_hz: float = 5500.0,
                       window_half_sec: float = 0.025):
    """Host-side Praat-style centered frame grid in the DECIMATED domain
    (the Burg analysis runs at sr / _formant_decim).  Starts are exactly
    regular — clip(s0 + k*hop2) — when the decimated stride is integral
    (every production config), enabling the slice-based device framing
    (see analysis/pitch._frames_praat).  Returns
    (n_frames, starts, wlen, n_resampled)."""
    decim = _formant_decim(sr, max_formant_hz)
    sr2 = sr / decim
    n = -(-int(n_samples) // decim) if decim > 1 else int(n_samples)
    wlen = int(round(2.0 * window_half_sec * sr2))
    wlen = min(wlen, max(32, n))
    duration = n / sr2
    n_frames = max(1, int(np.floor((duration - wlen / sr2) / dt)) + 1)
    t1 = (duration - (n_frames - 1) * dt) / 2.0
    hop_f = dt * sr2
    if abs(hop_f - round(hop_f)) < 1e-6:
        s0 = int(round(t1 * sr2 - wlen / 2.0))
        starts = s0 + int(round(hop_f)) * np.arange(n_frames,
                                                    dtype=np.int64)
    else:
        starts = np.round((t1 + dt * np.arange(n_frames)) * sr2
                          - wlen / 2).astype(np.int64)
    starts = np.clip(starts, 0, max(0, n - wlen))
    return n_frames, starts, wlen, n


def formant_graph(y: jnp.ndarray, sr: float, dt: float,
                  max_formants: int = 5, max_formant_hz: float = 5500.0,
                  window_half_sec: float = 0.025,
                  starts=None, nf=None) -> jnp.ndarray:
    """Pure-JAX formant tracks (max_formants, n_frames), 0.0 where
    missing; traceable into a larger analysis graph.

    ``starts`` (decimated-domain frame starts, possibly bucket-padded by
    repeating the last entry) overrides the internally computed grid —
    the bucketed batch extractor passes the TRUE signal's grid while
    ``y`` carries trailing zero padding; padded frames produce junk rows
    the host discards.  ``nf`` is the true frame count for the strided
    framing's edge fixups (defaults to len(starts))."""
    from goofer_tpu.analysis.pitch import _frames_praat

    y = jnp.asarray(y, dtype=jnp.float32)
    decim = _formant_decim(float(sr), max_formant_hz)
    y_rs, sr2 = _decimate(y, float(sr), decim)
    n = int(y_rs.shape[0])

    # pre-emphasis from 50 Hz
    pre = float(np.exp(-2.0 * np.pi * 50.0 / sr2))
    y_pe = y_rs - pre * jnp.concatenate([y_rs[:1] * 0, y_rs[:-1]])

    wlen = int(round(2.0 * window_half_sec * sr2))
    wlen = min(wlen, max(32, n))
    if starts is None:
        _, starts, wlen, _ = formant_frame_grid(
            y.shape[0], sr, dt, max_formant_hz, window_half_sec)
    if nf is None:
        nf = np.shape(starts)[0]

    hop_f = dt * sr2
    hop2 = int(round(hop_f)) if abs(hop_f - round(hop_f)) < 1e-6 else 0
    if hop2 > 0:
        frames = _frames_praat(y_pe, jnp.asarray(starts), nf, wlen, hop2)
    else:
        idx = jnp.asarray(starts)[:, None] + jnp.arange(wlen)[None, :]
        frames = y_pe[idx]
    frames = frames - jnp.mean(frames, axis=1, keepdims=True)
    # Praat's Gaussian analysis window
    tgrid = (np.arange(wlen) - (wlen - 1) / 2.0) / ((wlen - 1) / 2.0)
    gwin = ((np.exp(-12.0 * tgrid ** 2) - np.exp(-12.0))
            / (1.0 - np.exp(-12.0))).astype(np.float32)
    frames = frames * jnp.asarray(gwin)[None, :]

    order = 2 * max_formants
    a = _burg_coeffs(frames, order, wlen)
    roots = _poly_roots_dk(a, order)

    # convergence guard (fixed DK iteration budget): a root whose
    # polynomial residual stayed large is junk — drop it so the frame
    # reports 0.0 for that formant, matching the reference's None->0.0
    # semantics (ref: GOOFER.py:777-781) instead of shipping noise.
    c = a.astype(jnp.complex64)
    pz = jnp.zeros_like(roots) + c[:, 0:1]
    for i in range(1, order + 1):
        pz = pz * roots + c[:, i:i + 1]
    coeff_scale = jnp.sum(jnp.abs(a), axis=1, keepdims=True) + 1e-12
    converged = jnp.abs(pz) <= 1e-3 * coeff_scale

    freqs = jnp.angle(roots) * sr2 / (2.0 * np.pi)      # (F, order)
    nyq = sr2 / 2.0
    ok = (freqs > 50.0) & (freqs < nyq - 50.0) & converged
    freqs = jnp.where(ok, freqs, jnp.inf)
    freqs = jnp.sort(freqs, axis=1)[:, :max_formants]
    freqs = jnp.where(jnp.isfinite(freqs), freqs, 0.0)
    return freqs.T                                      # (max_formants, F)


def track_formants(y, sr: float, dt: float, max_formants: int = 5,
                   max_formant_hz: float = 5500.0,
                   window_half_sec: float = 0.025,
                   target_frames: int | None = None) -> np.ndarray:
    """Formant tracks, shape (max_formants, n_frames); 0.0 where missing."""
    tracks = np.asarray(formant_graph(
        jnp.asarray(y, dtype=jnp.float32), sr, dt, max_formants,
        max_formant_hz, window_half_sec))
    if target_frames is not None:
        cur = tracks.shape[1]
        if cur < target_frames:
            tracks = np.pad(tracks, ((0, 0), (0, target_frames - cur)))
        else:
            tracks = tracks[:, :target_frames]
    return tracks
