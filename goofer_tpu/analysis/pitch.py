"""Autocorrelation pitch tracker (Boersma-style), replacing Praat's C++
``to_pitch`` AC method (ref: GOOFER.py:341-353, called with floor 75 Hz /
ceiling 950 Hz / time_step = hop/sr).

Algorithm: Hann-windowed frames of 3/f0_min seconds, autocorrelation via
rfft normalized by the window's own autocorrelation, parabolic peak
refinement, top-K voiced candidates with Boersma's octave-cost corrected
strengths plus an unvoiced candidate, then a Viterbi path over frames with
octave-jump and voiced/unvoiced transition costs.  Praat internals are not
bit-reproducible; the parity budget is F0 RMSE on the driver configs, and
frame counts may differ — downstream interpolates tracks over a shared
[0, duration] axis exactly like the reference does (ref: GOOFER.py:960-963).

Everything is fixed-shape and jit-compatible; the Viterbi is a lax.scan over
frames with K+1 states.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class PitchConfig:
    f0_min: float = 75.0
    f0_max: float = 950.0
    periods_per_window: float = 3.0
    max_candidates: int = 6           # voiced candidates kept per frame
    silence_threshold: float = 0.03   # Praat defaults
    voicing_threshold: float = 0.45
    octave_cost: float = 0.01
    octave_jump_cost: float = 0.35
    voiced_unvoiced_cost: float = 0.14


def _frame_grid(n_samples: int, sr: float, dt: float, wlen: int):
    """Praat-style centered frame grid: as many frames of length wlen as fit,
    centered in the signal.

    When the stride dt*sr is an integer (every production config: dt =
    hop/sr), starts are EXACTLY regular — clip(s0 + k*hop) — instead of
    per-frame rounding of float centers, whose last-bit wobble made
    interior starts jitter by ±1 sample.  The regularity is what lets
    the device build frames from hop-block slices instead of a row
    gather (_frames_praat); the ≤1-sample window shift is far below the
    tracker's parity budgets."""
    duration = n_samples / sr
    wdur = wlen / sr
    n_frames = max(1, int(np.floor((duration - wdur) / dt)) + 1)
    t1 = (duration - (n_frames - 1) * dt) / 2.0
    centers = t1 + dt * np.arange(n_frames)
    hop_f = dt * sr
    if abs(hop_f - round(hop_f)) < 1e-6:
        s0 = int(round(t1 * sr - wlen / 2.0))
        starts = s0 + int(round(hop_f)) * np.arange(n_frames, dtype=np.int64)
    else:
        starts = np.round(centers * sr - wlen / 2.0).astype(np.int64)
    starts = np.clip(starts, 0, max(0, n_samples - wlen))
    return n_frames, starts, centers


def _frames_strided(y, shift, f_pad: int, wlen: int, hop: int):
    """frames[k] = ypad[shift + k*hop : +wlen] built from hop-block
    reshape + static slices instead of a general per-element row
    gather.  ``shift`` is a traced scalar (one dynamic_slice);
    everything after is static."""
    cols = -(-wlen // hop)
    wpad = cols * hop
    sz = f_pad * hop + wpad
    padl = wlen + 2 * hop
    padr = max(0, sz - int(y.shape[0])) + hop
    ypad = jnp.pad(y, (padl, padr))
    off = jnp.clip(padl + shift, 0, ypad.shape[0] - sz).astype(jnp.int32)
    y2 = jax.lax.dynamic_slice(ypad, (off,), (sz,))
    blocks = y2.reshape(f_pad + cols, hop)
    segs = [jax.lax.slice_in_dim(blocks, j, j + f_pad, axis=0)
            for j in range(cols)]
    return jnp.concatenate(segs, axis=1)[:, :wlen]


def _frames_praat(y, starts, nf, wlen: int, hop: int):
    """Frames on a Praat-style grid: starts[k] = clip(s0 + k*hop,
    0, n-wlen) (+ repeated-last padding past ``nf``).  The regular
    interior rides the strided-block path; the <=FIX clamped head/tail
    rows (and everything, for tiny signals) are overwritten with exact
    per-row slices.  Bit-identical to gathering every row."""
    f_pad = int(starts.shape[0])
    fix = min(int(np.ceil((wlen / 2 + hop) / hop)) + 2, f_pad)
    nf = jnp.asarray(nf, dtype=jnp.int32)
    starts = jnp.asarray(starts, dtype=jnp.int32)
    k_star = jnp.minimum(jnp.int32(fix), nf - 1)
    s0 = starts[k_star] - k_star * hop
    frames = _frames_strided(y, s0, f_pad, wlen, hop)

    def row(start):
        return jax.lax.dynamic_slice(
            y, (jnp.clip(start, 0, y.shape[0] - wlen),), (wlen,))

    head = jnp.stack([row(starts[k]) for k in range(fix)])
    frames = jax.lax.dynamic_update_slice(frames, head, (0, 0))
    for j in range(fix):
        kt = jnp.clip(nf - 1 - j, 0, f_pad - 1)
        frames = jax.lax.dynamic_update_slice(
            frames, row(starts[kt])[None], (kt, 0))
    return frames


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 6))
def _candidates(y, sr: float, wlen: int, nfft: int, cfg: PitchConfig,
                starts, hop: int, nf=None):
    """Per-frame voiced candidates (freq, strength) + local intensity."""
    lag_min = max(2, int(np.floor(sr / cfg.f0_max)))
    lag_max = int(np.ceil(sr / cfg.f0_min))
    lag_max = min(lag_max, wlen - 2)

    if nf is None:
        nf = starts.shape[0]
    if hop > 0:
        frames = _frames_praat(y, starts, nf, wlen, hop)  # (F, wlen)
    else:
        # non-integer frame stride: general (slow) row gather
        idx = starts[:, None] + jnp.arange(wlen)[None, :]
        frames = y[idx]
    frames = frames - jnp.mean(frames, axis=1, keepdims=True)
    local_peak = jnp.max(jnp.abs(frames), axis=1)

    window = jnp.asarray(np.hanning(wlen).astype(np.float32))
    xw = frames * window[None, :]

    spec = jnp.fft.rfft(xw, n=nfft, axis=1)
    ac = jnp.fft.irfft(spec * jnp.conj(spec), n=nfft, axis=1)
    r0 = jnp.maximum(ac[:, 0:1], 1e-12)

    # window autocorrelation (static)
    w = np.hanning(wlen).astype(np.float64)
    wac = np.fft.irfft(np.abs(np.fft.rfft(w, n=nfft)) ** 2, n=nfft)
    wac = (wac / wac[0]).astype(np.float32)
    wac = np.where(np.abs(wac) > 1e-6, wac, 1e-6)

    # Restrict normalization + peak/refinement/top-k math to the
    # candidate lag band [lag_min, lag_max] (f0 range -> ~13% of the
    # nfft lags): the elementwise chain over all nfft lags was the
    # analysis graph's heaviest memory traffic (a 16-file batch touched
    # ~90 MB per intermediate).
    band = slice(lag_min - 1, lag_max + 2)
    seg = (ac[:, band] / r0) / jnp.asarray(wac[band])[None, :]  # (F, L+2)
    rm1 = seg[:, :-2]
    rc = seg[:, 1:-1]
    rp1 = seg[:, 2:]
    lags = jnp.arange(lag_min, lag_max + 1)
    is_peak = (rc > rm1) & (rc >= rp1)

    # parabolic refinement around each lag
    denom = rm1 - 2.0 * rc + rp1
    dlag = jnp.where(jnp.abs(denom) > 1e-12,
                     0.5 * (rm1 - rp1) / denom, 0.0)
    dlag = jnp.clip(dlag, -0.5, 0.5)
    r_ref = rc - 0.25 * (rm1 - rp1) * dlag
    lag_ref = lags[None, :] + dlag

    freq = sr / jnp.maximum(lag_ref, 1e-6)
    # Boersma's octave-cost corrected local strength
    strength = r_ref - cfg.octave_cost * jnp.log2(
        jnp.maximum(cfg.f0_min * lag_ref / sr, 1e-12))
    strength = jnp.where(is_peak, strength, -1e9)

    top_s, top_i = jax.lax.top_k(strength, cfg.max_candidates)
    top_f = jnp.take_along_axis(freq, top_i, axis=1)
    top_f = jnp.clip(top_f, cfg.f0_min * 0.5, cfg.f0_max)
    return top_f, top_s, local_peak


@functools.partial(jax.jit, static_argnums=(3,))
def _viterbi(freqs, strengths, unvoiced_strength, cfg: PitchConfig,
             dt_ratio, valid=None):
    """Max-sum path over (K voiced + 1 unvoiced) states per frame,
    solved by PARALLEL PREFIX instead of a sequential scan.

    The classic Viterbi lax.scan costs one sequential device step per
    frame for these tiny (K+1)-state updates, so the two scans (forward
    + backtrace) would dominate the whole analysis graph.  Max-plus
    matrix products are associative,
    so the forward deltas are an inclusive jax.lax.associative_scan of
    the per-step (K+1)x(K+1) score matrices (log2(F) parallel levels),
    the backward "best suffix" betas are the same scan reversed, and the
    optimal state at frame t is argmax(delta_t + beta_t) — the
    backtrace falls out of the marginals, no second sequential pass.
    Identical path to the sequential solve away from exact score ties
    (tests/test_analysis.py::test_viterbi_parallel_matches_sequential).

    ``valid`` (F,) bool marks true frames when the arrays carry trailing
    bucket padding: invalid steps contribute max-plus IDENTITY matrices
    (pass-through), so the path over the true frames equals the
    unpadded solve exactly."""
    k = freqs.shape[1]
    # state arrays: index 0..k-1 voiced, k = unvoiced
    s_all = jnp.concatenate([strengths, unvoiced_strength[:, None]], axis=1)
    f_all = jnp.concatenate([freqs, jnp.zeros_like(freqs[:, :1])], axis=1)
    n_frames = s_all.shape[0]
    if valid is None:
        valid = jnp.ones((n_frames,), dtype=bool)

    vu_cost = cfg.voiced_unvoiced_cost * dt_ratio
    oj_cost = cfg.octave_jump_cost * dt_ratio

    # per-step score matrices M[t, i, j] = s[t+1, j] - cost(f[t,i], f[t+1,j])
    f_prev = f_all[:-1, :, None]
    f_next = f_all[1:, None, :]
    pv = f_prev > 0
    nv = f_next > 0
    jump = oj_cost * jnp.abs(
        jnp.log2(jnp.maximum(f_prev, 1e-6) / jnp.maximum(f_next, 1e-6)))
    cost = jnp.where(pv & nv, jump, jnp.where(pv ^ nv, vu_cost, 0.0))
    m = s_all[1:, None, :] - cost                      # (F-1, K+1, K+1)
    ident_m = jnp.where(jnp.eye(k + 1, dtype=bool), 0.0, -1e9)
    m = jnp.where(valid[1:, None, None], m, ident_m[None])

    def combine(a, b):
        # max-plus matmul: out[i, j] = max_k a[i, k] + b[k, j]
        return jnp.max(a[..., :, :, None] + b[..., None, :, :], axis=-2)

    delta0 = s_all[0]
    prefix = jax.lax.associative_scan(combine, m, axis=0)
    delta = jnp.concatenate([
        delta0[None],
        jnp.max(delta0[None, :, None] + prefix, axis=1)], axis=0)  # (F, K+1)

    # reverse associative_scan composes in REVERSED operand order
    # (scan-of-reversed-sequence), which matters for the non-commutative
    # max-plus product: feed TRANSPOSED matrices so the reversed-order
    # product of transposes equals the transpose of the wanted suffix
    # S[t] = m[t] (x) ... (x) m[F-2]; beta[t][i] = max_j S[t][i, j] is
    # then the max over the transposed result's axis -2.
    suffix_t = jax.lax.associative_scan(
        combine, jnp.swapaxes(m, -1, -2), axis=0, reverse=True)
    beta = jnp.concatenate([
        jnp.max(suffix_t, axis=-2),
        jnp.zeros((1, k + 1), dtype=s_all.dtype)], axis=0)         # (F, K+1)

    path = jnp.argmax(delta + beta, axis=1)
    f0 = jnp.take_along_axis(f_all, path[:, None], axis=1)[:, 0]
    return jnp.where(valid, f0, 0.0)


def pitch_graph(y: jnp.ndarray, sr: float, dt: float,
                cfg: PitchConfig = PitchConfig()) -> jnp.ndarray:
    """Pure-JAX frame-rate F0 track (traceable into a larger graph)."""
    y = jnp.asarray(y, dtype=jnp.float32)
    n = y.shape[0]
    wlen = int(round(cfg.periods_per_window / cfg.f0_min * sr))
    wlen = min(wlen, max(16, n))
    nfft = 1
    while nfft < 2 * wlen:
        nfft *= 2
    n_frames, starts, _ = _frame_grid(n, sr, dt, wlen)

    hop_f = dt * sr
    hop_i = int(round(hop_f)) if abs(hop_f - round(hop_f)) < 1e-6 else 0
    freqs, strengths, local_peak = _candidates(
        y, float(sr), wlen, nfft, cfg, jnp.asarray(starts), hop_i)

    global_peak = jnp.maximum(jnp.max(jnp.abs(y)), 1e-12)
    intensity = local_peak / global_peak
    unvoiced_strength = cfg.voicing_threshold + jnp.maximum(
        0.0, 2.0 - (intensity * (1.0 + cfg.voicing_threshold)
                    / cfg.silence_threshold))

    if n_frames == 1:
        best = jnp.argmax(jnp.concatenate(
            [strengths[0], unvoiced_strength[:1]]))
        f_all = jnp.concatenate([freqs[0], jnp.zeros((1,))])
        return f_all[best].reshape(1)

    dt_ratio = dt / 0.01
    return _viterbi(freqs, strengths, unvoiced_strength, cfg,
                    jnp.float32(dt_ratio))


def pitch_window_len(sr: float, cfg: PitchConfig = PitchConfig()) -> int:
    """Static analysis window length for this sr/config."""
    return int(round(cfg.periods_per_window / cfg.f0_min * sr))


def pitch_graph_bucketed(y_pad: jnp.ndarray, sr: float, dt: float,
                         starts, nf_true, cfg: PitchConfig = PitchConfig()
                         ) -> jnp.ndarray:
    """Bucket-padded pitch track: ``y_pad`` is a zero-padded waveform,
    ``starts`` the host-computed frame grid of the TRUE signal padded (by
    repeating its last entry) to a static frame bucket, ``nf_true`` the
    traced true frame count.  Returns (F_pad,) f0 with zeros past
    nf_true; values on the true frames equal the unpadded pitch_graph
    (the host grid clamps windows inside the true signal, and the Viterbi
    passes through padded steps untouched)."""
    y = jnp.asarray(y_pad, dtype=jnp.float32)
    n = y.shape[0]
    wlen = min(pitch_window_len(sr, cfg), max(16, n))
    nfft = 1
    while nfft < 2 * wlen:
        nfft *= 2
    starts = jnp.asarray(starts)
    f_pad = starts.shape[0]

    hop_f = dt * sr
    hop_i = int(round(hop_f)) if abs(hop_f - round(hop_f)) < 1e-6 else 0
    freqs, strengths, local_peak = _candidates(
        y, float(sr), wlen, nfft, cfg, starts, hop_i, nf_true)

    global_peak = jnp.maximum(jnp.max(jnp.abs(y)), 1e-12)
    intensity = local_peak / global_peak
    unvoiced_strength = cfg.voicing_threshold + jnp.maximum(
        0.0, 2.0 - (intensity * (1.0 + cfg.voicing_threshold)
                    / cfg.silence_threshold))

    valid = jnp.arange(f_pad) < nf_true
    dt_ratio = dt / 0.01
    return _viterbi(freqs, strengths, unvoiced_strength, cfg,
                    jnp.float32(dt_ratio), valid)


def track_pitch(y, sr: float, dt: float,
                cfg: PitchConfig = PitchConfig()) -> np.ndarray:
    """Frame-rate F0 track in Hz, 0 where unvoiced."""
    return np.asarray(pitch_graph(jnp.asarray(y, dtype=jnp.float32),
                                  sr, dt, cfg))


def fix_f0_gaps(f0: jnp.ndarray, max_gap: int = 4) -> jnp.ndarray:
    """Bridge interior zero-runs of length <= max_gap by linear interpolation
    (ref: GOOFER.py:415-435), vectorized via two-sided nearest-valid scans."""
    from goofer_tpu.ops.pulse import forward_fill

    f0 = jnp.asarray(f0, dtype=jnp.float32)
    n = f0.shape[0]
    valid = f0 != 0.0
    i = jnp.arange(n, dtype=jnp.float32)

    left_idx = jax.lax.cummax(jnp.where(valid, i, -1.0), axis=0)
    right_idx = -jax.lax.cummax(
        jnp.where(valid, -i, -(2.0 * n)), axis=0, reverse=True)

    left_ok = left_idx >= 0
    right_ok = right_idx < n
    gap_len = right_idx - left_idx - 1.0
    fillable = (~valid) & left_ok & right_ok & (gap_len <= max_gap)

    left_val = forward_fill(f0, valid, 0.0)
    right_val = forward_fill(f0[::-1], valid[::-1], 0.0)[::-1]
    ratio = (i - left_idx) / jnp.maximum(right_idx - left_idx, 1.0)
    bridged = left_val * (1.0 - ratio) + right_val * ratio
    return jnp.where(fillable, bridged, f0)
