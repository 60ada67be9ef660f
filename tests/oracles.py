"""Plain-NumPy oracles restating the reference engine's semantics.

The mounted reference cannot be imported in this image (numba / parselmouth /
soundfile are absent), so these little sequential implementations serve as
the ground truth for the vectorized device kernels.  Each function cites the
reference behavior it models (see /root/reference file:line in docstrings);
they are deliberately written loop-style so the equivalence being tested is
between "obvious sequential semantics" and the scan/gather formulations.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter1d as _scipy_g1d


def o_gaussian1d(x, sigma, axis=-1, truncate=4.0):
    """GOOFER.py:241-261 — numpy-'reflect' pad == scipy mode='mirror'."""
    x = np.asarray(x, dtype=np.float64)
    if x.size == 0 or sigma <= 0:
        return x.copy()
    radius = int(truncate * sigma + 0.5)
    if radius <= 0:
        return x.copy()
    return _scipy_g1d(x, sigma, axis=axis, mode="mirror", truncate=truncate)


def o_stft(x, n_fft, hop, window):
    """GOOFER.py:355-370."""
    x = np.asarray(x, dtype=np.float32)
    pad = n_fft // 2
    mode = "reflect" if len(x) >= 2 else "edge"
    xp = np.pad(x, pad, mode=mode)
    if len(xp) < n_fft:
        xp = np.pad(xp, (0, n_fft - len(xp)), mode="edge")
    t = max(1, 1 + (len(xp) - n_fft) // hop)
    frames = np.stack([xp[i * hop: i * hop + n_fft] for i in range(t)], axis=1)
    frames = frames * window[:, None]
    return np.fft.rfft(frames, axis=0)


def o_istft(S, hop, window, length=None):
    """GOOFER.py:372-413."""
    n_fft = (S.shape[0] - 1) * 2
    frames = np.fft.irfft(np.asarray(S, dtype=np.complex64),
                          axis=0, n=n_fft).astype(np.float32)
    t = frames.shape[1]
    pad = n_fft // 2
    expected = n_fft + hop * (t - 1)
    y = np.zeros(expected, dtype=np.float32)
    wsum = np.zeros(expected, dtype=np.float32)
    for i in range(t):
        y[i * hop: i * hop + n_fft] += frames[:, i] * window
        wsum[i * hop: i * hop + n_fft] += window * window
    nz = wsum > 1e-9
    y[nz] /= wsum[nz]
    y = y[pad: expected - pad]
    if length is not None:
        if len(y) < length:
            y = np.pad(y, (0, length - len(y)))
        else:
            y = y[:length]
    return y


def _lf_shape(u, T, Ra, Rg, Rk, guard):
    """LF pulse as a function of normalized position u = t/T."""
    uc = Ra + Rk * (1.0 - Ra)
    if u < 0 or u >= 1.0:
        return 0.0
    if u < Ra:
        if guard:
            return np.sin(np.pi * u * T / (2.0 * Ra * T + 1e-12)) ** 2
        return np.sin(np.pi * u / (2.0 * Ra)) ** 2
    if u < uc:
        if guard:
            tau = (u - Ra) * T / ((uc - Ra) * T + 1e-12)
        else:
            tau = (u - Ra) / (uc - Ra)
        return np.exp(-Rg * tau) * np.cos(np.pi * tau / 2.0)
    return 0.0


def o_pulse_buf(T0, T, Ra, Rg, Rk, guard):
    buf = np.array([_lf_shape(j / T0, T, Ra, Rg, Rk, guard)
                    for j in range(T0)], dtype=np.float64)
    peak = np.max(np.abs(buf))
    if peak > 0:
        buf = buf / peak
    return buf


# Phase-accumulator dtype for o_pulse_train.  float64 matches the REAL
# (numba-compiled) reference: numba promotes float32/int64 to float64,
# so pulse_train_numba's `total_phase += f0i / sr` runs in f64
# (GOOFER.py:479-491).  tests/test_ref_upstream.py flips this to
# float32 while certifying against the STUBBED upstream execution,
# where NumPy's weak scalar promotion keeps that same accumulator in
# f32 — both sides then place onsets identically and the comparison is
# float-exact with no exclusion windows.
PULSE_PHASE_DTYPE = np.float64


def o_pulse_train(f0, sr, Ra=0.02, Rg=1.7, Rk=0.8):
    """GOOFER.py:473-554 — sequential phase accumulator + scatter.

    See PULSE_PHASE_DTYPE for the f64/f32 accumulator split."""
    if PULSE_PHASE_DTYPE == np.float32:
        return _o_pulse_train_f32(f0, sr, Ra, Rg, Rk)
    f0 = np.asarray(f0, dtype=np.float64)
    n = len(f0)
    out = np.zeros(n, dtype=np.float64)
    phase = 0.0
    next_k = 1.0
    last_f0 = 160.0
    for i in range(n):
        if f0[i] > 1e-6:
            last_f0 = f0[i]
        phase += f0[i] / sr
        while phase >= next_k:
            T = 1.0 / max(last_f0, 1e-6)
            T0 = int(round(sr * T))
            T0 = min(max(T0, 3), 8192)
            buf = o_pulse_buf(T0, T, Ra, Rg, Rk, guard=True)
            end = min(n, i + T0)
            out[i:end] += buf[: end - i]
            next_k += 1.0
    return out


def _o_pulse_train_f32(f0, sr, Ra, Rg, Rk):
    """The stubbed-upstream numerics: f32 f0 (the reference casts before
    the kernel, GOOFER.py:1074), f32 running phase, f32 reciprocal for
    T/T0.  Pulse SHAPES stay the f64 o_pulse_buf — they are
    scale-invariant in T up to epsilon guards (~1e-7, far below the
    certification atol)."""
    fq = np.asarray(f0, dtype=np.float32)
    n = len(fq)
    out = np.zeros(n, dtype=np.float64)
    terms = fq / np.float32(sr)
    phase = np.float32(0.0)
    next_k = 1.0
    last_f0 = np.float32(160.0)
    for i in range(n):
        if fq[i] > 1e-6:
            last_f0 = fq[i]
        phase = np.float32(phase + terms[i])
        while phase >= next_k:
            T = float(np.float32(1.0) / np.float32(max(float(last_f0),
                                                       1e-6)))
            T0 = int(round(float(np.float32(sr) * np.float32(T))))
            T0 = min(max(T0, 3), 8192)
            buf = o_pulse_buf(T0, T, Ra, Rg, Rk, guard=True)
            end = min(n, i + T0)
            out[i:end] += buf[: end - i]
            next_k += 1.0
    return out


def o_subharm_pulses(f0, sr, mask, semitones, weight):
    """GOOFER.py:672-736 — per-ratio event trackers, voiced-gated."""
    f0 = np.asarray(f0, dtype=np.float64)
    mask = np.asarray(mask, dtype=np.float64)
    n = len(f0)
    if not isinstance(semitones, (list, tuple, np.ndarray)):
        semitones = [semitones]
    ratios = [2.0 ** (s / 12.0) for s in semitones]
    trackers = [0.0] * len(ratios)
    last_f0 = 160.0
    out = np.zeros(n, dtype=np.float64)
    for i in range(n):
        if mask[i] <= 0 or f0[i] <= 0:
            continue
        last_f0 = f0[i]
        for j, r in enumerate(ratios):
            sub = last_f0 * r
            if sub < 1e-2:
                continue
            trackers[j] += sub / sr
            if trackers[j] >= 1.0:
                trackers[j] -= 1.0
                T = 1.0 / sub
                T0 = int(round(sr * T))
                if T0 <= 3:
                    T0 = 3
                buf = o_pulse_buf(T0, T, 0.02, 1.7, 1.0, guard=False)
                end = min(n, i + T0)
                out[i:end] += buf[: end - i]
    out = out * mask
    peak = np.max(np.abs(out))
    if peak > 1e-6:
        out = out / peak
    return out * weight


def o_one_pole_hp(x, sr, fc):
    """GOOFER.py:877-892."""
    if fc <= 0:
        return np.zeros_like(x)
    rc = 1.0 / (2.0 * np.pi * fc)
    a = rc / (rc + 1.0 / sr)
    y = np.zeros(len(x))
    px = 0.0
    py = 0.0
    for i in range(len(x)):
        xn = float(x[i])
        yn = a * (py + xn - px)
        y[i] = yn
        px, py = xn, yn
    return y


def o_dynamic_butter(x, f0, sr, factor, order, btype):
    """SillySampler.py:95-174."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    f0 = np.asarray(f0, dtype=np.float64)
    if f0.size != n:
        pos = np.linspace(0, f0.size - 1, n)
        f0 = np.interp(pos, np.arange(f0.size), f0)
    if np.any(f0 > 0):
        pad = 2
        padv = np.pad(f0, (pad, pad), mode="edge")
        f0 = np.convolve(padv, np.ones(5) / 5.0, mode="valid")
    fc = np.where(f0 > 0, f0 * factor, factor)
    floor = 60.0 if btype == "lowpass" else 20.0
    fc = np.clip(fc, floor, 0.45 * sr)
    two_pi = 2 * np.pi
    if btype == "lowpass":
        alpha = two_pi * fc / (two_pi * fc + sr)
    else:
        alpha = sr / (two_pi * fc + sr)
    y = x.copy()
    for _ in range(max(1, int(order))):
        if btype == "lowpass":
            yp = 0.0
            for i in range(n):
                yp = yp + alpha[i] * (y[i] - yp)
                y[i] = yp
        else:
            yp = 0.0
            px = y[0]
            for i in range(n):
                xi = y[i]
                yp = alpha[i] * (yp + xi - px)
                y[i] = yp
                px = xi
    return y


def o_interp_extrap(x, y, x_new):
    """GOOFER.py:204-237."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    out = np.interp(x_new, x, y)
    sl = (y[1] - y[0]) / (x[1] - x[0] + 1e-10)
    sr_ = (y[-1] - y[-2]) / (x[-1] - x[-2] + 1e-10)
    lo = x_new < x[0]
    hi = x_new > x[-1]
    out = np.where(lo, y[0] + sl * (x_new - x[0]), out)
    out = np.where(hi, y[-1] + sr_ * (x_new - x[-1]), out)
    return out


def o_warp_env_by_formants(env, orig_f, shift_f, sr):
    """GOOFER.py:840-875 — per-frame anchor warp."""
    n_bins, t = env.shape
    freqs = np.linspace(0.0, sr / 2.0, n_bins)
    out = np.zeros_like(env)
    for j in range(t):
        src = [0.0]
        dst = [0.0]
        for i in range(4):
            fo, fs = orig_f[i, j], shift_f[i, j]
            if fo > 50.0 and fo < sr / 2.0 and fs > 50.0:
                src.append(fo)
                dst.append(fs)
        src.append(sr / 2.0)
        dst.append(sr / 2.0)
        warped = o_interp_extrap(np.array(dst), np.array(src), freqs)
        out[:, j] = o_interp_extrap(freqs, env[:, j], warped)
    return out


def o_brightness_curve(n_bins, sr, start_hz, end_hz, gain_db):
    """GOOFER.py:585-595."""
    freqs = np.linspace(0, sr / 2, n_bins)
    gain = np.ones_like(freqs)
    i0 = np.searchsorted(freqs, start_hz)
    i1 = np.searchsorted(freqs, end_hz)
    rise = np.linspace(0, 1, i1 - i0)
    g = 10 ** (gain_db / 20.0)
    gain[i0:i1] = 1 + rise * (g - 1)
    gain[i1:] = g
    return gain[:, None]


def o_smooth_mask(mask, sigma=100, ds=4):
    """GOOFER.py:556-569."""
    short = mask[::ds].astype(np.float64)
    short_s = o_gaussian1d(short, max(1.0, sigma / ds))
    return np.interp(np.linspace(0, 1, len(mask)),
                     np.linspace(0, 1, len(short_s)), short_s)


def o_shift_formants(env, shift_ratio, sr):
    """GOOFER.py:618-627 — global spectral-envelope frequency warp."""
    n_bins, t = env.shape
    freqs = np.linspace(0.0, sr / 2.0, n_bins)
    warped = np.clip(freqs / shift_ratio, 0.0, sr / 2.0)
    out = np.zeros_like(env)
    for j in range(t):
        out[:, j] = o_interp_extrap(freqs, env[:, j], warped)
    return out


def o_subharm_vibrato(f0, sr, rate, depth, delay):
    """GOOFER.py:748-766 — zero-phase sinusoidal vibrato, voiced only,
    linear fade-in over ``delay`` seconds (the reference's unseeded call
    sites leave phase at 0)."""
    f0 = np.asarray(f0, dtype=np.float64)
    n = len(f0)
    t = np.arange(n) / sr
    vib = np.sin(2 * np.pi * rate * t)
    fade_n = int(delay * sr)
    if fade_n < n:
        vib[:fade_n] *= np.linspace(0, 1, fade_n)
    voiced = f0 > 0
    out = f0.copy()
    out[voiced] = out[voiced] * (1 + vib[voiced] * depth)
    return out


def o_volume_jitter_vibrato(length, sr, speed, strength):
    """GOOFER.py:638-660, vibrato=True path — zero-phase sinusoid at
    ``speed`` Hz, 0.1 s fade-in, 1 + s*sin clipped to [0.5, 1.5]."""
    t = np.arange(length) / sr
    noise = np.sin(2 * np.pi * speed * t)
    fade_n = int(0.1 * sr)
    if fade_n < length:
        noise[:fade_n] *= np.linspace(0, 1, fade_n)
    return np.clip(1.0 + noise * strength, 0.5, 1.5)


def o_synthesize(env, f0, mask, n, sr, n_fft, hop,
                 uv_strength=0.75, breath_strength=0.1, normalize=1.0,
                 cut_below_f0=True, apply_brightness=True,
                 noise_smoothness=100, rng=None,
                 formants=None, f_shifts=(1.0, 1.0, 1.0, 1.0),
                 formant_shift=1.0,
                 add_subharm=False, subharm_weight=0.5,
                 subharm_semitones=12, subharm_vibrato=False,
                 subharm_vibrato_rate=6.0, subharm_vibrato_depth=0.1,
                 subharm_vibrato_delay=0.1,
                 volume_jitter=False, volume_jitter_strength=50.0,
                 volume_jitter_speed=150.0,
                 f0_jitter=False, f0_jitter_strength=1.5,
                 f0_jitter_speed=100.0, jitter_rng=None):
    """GOOFER.py:971-1220 (no roughness; that path is validated
    spectrally elsewhere).

    Returns (mix, harmonic, aper_uv, aper_bre).  Noise phases come from
    ``rng`` (or are zero when rng is None, making the noise branch
    deterministic for testing).  ``formants`` is a (4, T) array of F1..F4
    tracks; per-band warps and the global formant shift apply to the
    harmonic envelope only — the breath envelope is blurred BEFORE the
    warps, a reference quirk (GOOFER.py:993 precedes :1004-1017)."""
    win = np.hanning(n_fft) ** 0.5
    env = np.asarray(env, dtype=np.float64)
    env4b = o_gaussian1d(env, 1.75, axis=0)

    if formants is not None and any(s != 1.0 for s in f_shifts):
        fa = np.asarray(formants, dtype=np.float64)
        shifted = fa * np.asarray(f_shifts, dtype=np.float64)[:, None]
        env = o_warp_env_by_formants(env, fa, shifted, sr)
    if formant_shift != 1.0:
        env = o_shift_formants(env, formant_shift, sr)

    if f0_jitter and jitter_rng is not None:
        # GOOFER.py:662-670,1069-1071
        jn = jitter_rng.standard_normal(len(f0))
        jn = o_gaussian1d(jn, sr / (f0_jitter_speed * 6.0))
        jn = jn / np.max(np.abs(jn) + 1e-6)
        f0 = np.asarray(f0, dtype=np.float64) * (
            1.0 + ((1.0 + jn * f0_jitter_strength) - 1.0)
            * np.asarray(mask, dtype=np.float64))

    pulse = o_pulse_train(f0, sr)
    if add_subharm:
        f0_sub = np.asarray(f0, dtype=np.float64)
        if subharm_vibrato:
            f0_sub = o_subharm_vibrato(f0_sub, sr, subharm_vibrato_rate,
                                       subharm_vibrato_depth,
                                       subharm_vibrato_delay)
        pulse = pulse + o_subharm_pulses(f0_sub, sr, mask,
                                         subharm_semitones, subharm_weight)
    S_harm = o_stft(pulse.astype(np.float32), n_fft, hop, win)
    t = S_harm.shape[1]

    freqs = np.fft.rfftfreq(n_fft, 1 / sr)[:, None]
    f0f = f0[::hop]
    if len(f0f) < t:
        f0f = np.pad(f0f, (0, t - len(f0f)), mode="edge")
    f0f = f0f[:t]
    hp = 1.0 / (1.0 + np.exp(-np.clip((freqs - f0f[None, :].reshape(1, -1))
                                      / 5.0, -60, 60)))
    if cut_below_f0:
        S_harm = S_harm * hp
    if env.shape[1] > t:
        env = env[:, :t]
    elif env.shape[1] < t:
        env = np.pad(env, ((0, 0), (0, t - env.shape[1])), mode="edge")
    mag = np.max(np.abs(S_harm) + 1e-8)
    n_bins = S_harm.shape[0]
    boost = np.linspace(1, 100, n_bins)[:, None]
    S_harm = (S_harm / mag) * env * boost

    bh = o_brightness_curve(n_bins, sr, 2000, 3500, 3.0)
    bb = o_brightness_curve(n_bins, sr, 3500, 5000, 20.0)
    vf = mask[::hop]
    if len(vf) < t:
        vf = np.pad(vf, (0, t - len(vf)), mode="edge")
    vf = vf[:t]
    cols = np.nonzero(vf > 0)[0]
    if apply_brightness and len(cols):
        block = S_harm[:, cols] * bh
        S_harm[:, cols] = o_gaussian1d(block.real, 0.5, axis=0) \
            + 1j * o_gaussian1d(block.imag, 0.5, axis=0)
    harmonic = o_istft(S_harm, hop, win, length=n).astype(np.float64)

    envn = env4b
    if envn.shape[1] > t:
        envn = envn[:, :t]
    elif envn.shape[1] < t:
        envn = np.pad(envn, ((0, 0), (0, t - envn.shape[1])), mode="edge")
    if rng is None:
        phi = np.zeros((n_bins, t))
    else:
        phi = rng.uniform(0, 2 * np.pi, size=(n_bins, t))
    U = np.cos(phi) + 1j * np.sin(phi)
    S_uv = U * envn
    S_breath = S_uv * hp
    if apply_brightness and len(cols):
        block = S_breath[:, cols] * bb
        S_breath[:, cols] = o_gaussian1d(block.real, 0.5, axis=0) \
            + 1j * o_gaussian1d(block.imag, 0.5, axis=0)
    aper_breath = o_istft(S_breath, hop, win, length=n).astype(np.float64)
    aper_uv_raw = o_istft(S_uv, hop, win, length=n).astype(np.float64)

    ms = o_smooth_mask(mask, noise_smoothness, 4)
    aper_bre = aper_breath * ms * breath_strength
    aper_uv = aper_uv_raw * (1 - ms) * uv_strength

    if volume_jitter and jitter_rng is not None:
        # GOOFER.py:1185-1191 (vibrato=False path: smoothed unit noise)
        def vj(length, strength):
            noise = jitter_rng.standard_normal(length)
            noise = o_gaussian1d(noise, sr / (volume_jitter_speed * 6.0))
            noise = noise / np.max(np.abs(noise) + 1e-6)
            return 1.0 + noise * strength
        vjm = o_gaussian1d(np.asarray(mask, dtype=np.float64), 20.0)
        harmonic = harmonic * (1.0 + (vj(len(harmonic),
                                         volume_jitter_strength) - 1.0) * vjm)
        aper_bre = aper_bre * (1.0 + (vj(len(aper_bre),
                                         volume_jitter_strength * 2) - 1.0)
                               * vjm)

    combined = harmonic + aper_uv + aper_bre
    peak = float(np.max(np.abs(combined)) + 1e-12)
    gain = (1.0 / peak) ** float(np.clip(normalize, 0, 1))
    return (combined * gain, harmonic * gain, aper_uv * gain,
            aper_bre * gain)


def o_loop_env(env_tail, desired, mode):
    """SillySampler.py:625-696 — sustain looping of the envelope tail,
    including the concat mode's seam-crossfade construction (whose output
    is intentionally longer than `desired`, a reference quirk downstream
    match_env_frames absorbs)."""
    tail = env_tail.shape[1]
    if tail >= desired:
        return env_tail[:, :desired]
    reps = desired // tail
    rem = desired % tail
    if mode == "stretch":
        if tail == 0:
            return np.zeros((env_tail.shape[0], desired), dtype=np.float32)
        factor = desired / tail
        target = int(tail * factor)
        pos = np.linspace(0, tail - 1, target)
        lo = np.clip(np.floor(pos).astype(int), 0, tail - 2 if tail > 1 else 0)
        frac = pos - lo
        return (env_tail[:, lo] * (1 - frac)
                + env_tail[:, np.minimum(lo + 1, tail - 1)] * frac)
    if mode == "avg":
        tile = (env_tail + env_tail[:, ::-1]) / 2.0
        parts = [tile] * reps
        if rem:
            parts.append(tile[:, :rem])
        return np.concatenate(parts, axis=1)
    # concat
    full = [env_tail.copy()]
    for _ in range(reps - 1):
        prev = full[-1]
        f = min(8, tail // 2)
        fi = np.linspace(0, 1, f)[None, :]
        fo = np.linspace(1, 0, f)[None, :]
        cross = prev[:, -f:] * fo + env_tail[:, :f] * fi
        full[-1] = np.concatenate([prev[:, :-f], cross, env_tail[:, f:]],
                                  axis=1)
        full.append(env_tail.copy())
    if rem:
        last = env_tail[:, :rem]
        prev = full[-1]
        f = min(8, rem // 2)
        if f > 0:
            fi = np.linspace(0, 1, f)[None, :]
            fo = np.linspace(1, 0, f)[None, :]
            cross = prev[:, -f:] * fo + last[:, :f] * fi
            chunk = np.concatenate([prev[:, :-f], cross, last[:, f:]], axis=1)
        else:
            chunk = np.concatenate([prev, last], axis=1)
        full[-1] = chunk
    return np.concatenate(full, axis=1)


def o_loop_track(track, desired, mode):
    """SillySampler.py:717-744 — formant-track looping."""
    track = np.asarray(track, dtype=np.float32)
    if mode == "stretch":
        if track.size == 0:
            return np.zeros(desired, dtype=np.float32)
        factor = desired / float(track.size)
        target = int(track.size * factor)
        pos = np.linspace(0, track.size - 1, target)
        return np.interp(pos, np.arange(track.size), track).astype(np.float32)
    if track.size == 0:
        return np.zeros(desired, dtype=np.float32)
    reps = desired // track.size
    rem = desired % track.size
    if mode == "avg":
        tile = (track + track[::-1]) * 0.5
        base = np.tile(tile, reps)
        if rem:
            base = np.concatenate([base, tile[:rem]])
        return base.astype(np.float32)
    base = np.tile(track, reps)
    if rem:
        base = np.concatenate([base, track[:rem]])
    return base.astype(np.float32)


def o_loop_samples(x, desired):
    """SillySampler.py:698-712 — f0/mask always concat-tile."""
    n = len(x)
    if n >= desired:
        return x[:desired]
    reps = desired // n
    rem = desired % n
    parts = [x] * reps
    if rem:
        parts.append(x[:rem])
    return np.concatenate(parts)


def o_stretch_prefix_1d(x, pre_len, factor):
    """SillySampler.py:176-187."""
    n = len(x)
    if pre_len <= 1 or n <= 1 or abs(factor - 1.0) < 1e-6:
        return x
    pre_new = max(1, int(round(pre_len * factor)))
    n_new = pre_new + (n - pre_len)
    idx = np.arange(n_new, dtype=np.float64)
    pos = np.where(idx < pre_new, idx / factor, (idx - pre_new) + pre_len)
    return o_interp_extrap(np.arange(n, dtype=np.float64), x, pos)


# ======================================================================
# Full resampler-chain oracle (ref: SillySampler.py:286-411 decode +
# 449-1185 resample).  Sequential NumPy, composed from the per-op
# oracles above; the device pipeline's render_note must match it to float
# accuracy on deterministic paths (tests/test_resample_oracle.py).
# ======================================================================

import re as _re

_O_NOTES = {"C": 0, "C#": 1, "D": 2, "D#": 3, "E": 4, "F": 5,
            "F#": 6, "G": 7, "G#": 8, "A": 9, "A#": 10, "B": 11}


def o_parse_flags(s):
    """SillySampler.py:48-54."""
    flags = {}
    for key, val in _re.findall(r"([A-Za-z]{1,4})([+-]?\d+)?",
                                s.replace("/", "")):
        flags[key] = int(val) if val else None
    return flags


def o_note_to_midi(n):
    """SillySampler.py:46-47,86-90."""
    m = _re.match(r"([A-G]#?)(-?\d+)", n)
    nm, octv = m.groups()
    return (int(octv) + 1) * 12 + _O_NOTES[nm]


def _o_uint6(c):
    o = ord(c)
    if o >= 97:
        return o - 71
    if o >= 65:
        return o - 65
    if o >= 48:
        return o + 4
    if o == 43:
        return 62
    if o == 47:
        return 63
    raise ValueError(c)


def o_pitch_string_to_cents(x):
    """SillySampler.py:56-84 — base64 int12 stream with #run# RLE."""
    parts = x.split("#")
    out = []

    def stream(s):
        return [(lambda v: v - 4096 if (v & 0x800) else v)(
            (_o_uint6(s[i]) << 6) | _o_uint6(s[i + 1]))
            for i in range(0, len(s), 2)]

    for i in range(0, len(parts), 2):
        chunk = parts[i:i + 2]
        if len(chunk) == 2:
            ps, run = chunk
            out += stream(ps)
            out += [out[-1]] * int(run)
        else:
            out += stream(chunk[0])
    arr = np.array(out, dtype=np.float32)
    return arr if arr.size else np.array([0.0], dtype=np.float32)


def o_sanitize_formant(track, T, sr, min_hz=120.0, max_hz=None,
                       sigma_frames=3):
    """SillySampler.py:264-283."""
    max_hz = max_hz or (sr * 0.48)
    x = np.asarray(track, dtype=np.float32).copy()
    if len(x) < T:
        x = np.pad(x, (0, T - len(x)), mode="edge")
    elif len(x) > T:
        x = x[:T]
    bad = (~np.isfinite(x)) | (x < min_hz) | (x > max_hz)
    if np.any(bad):
        good = np.where(~bad)[0]
        if good.size:
            x[bad] = o_interp_extrap(
                good.astype(np.float64), x[~bad].astype(np.float64),
                np.where(bad)[0].astype(np.float64)).astype(np.float32)
        else:
            x = np.full_like(x, 300.0)
    if sigma_frames > 0:
        x = o_gaussian1d(x.astype(np.float64), sigma_frames)
    return x.astype(np.float32)


def o_stretch_prefix_2d(M, pre_len, factor):
    """SillySampler.py:189-204."""
    n = M.shape[1]
    if pre_len <= 1 or n <= 1 or abs(factor - 1.0) < 1e-6:
        return M
    pre_new = max(1, int(round(pre_len * factor)))
    n_new = pre_new + (n - pre_len)
    idx = np.arange(n_new, dtype=np.float64)
    pos = np.where(idx < pre_new, idx / factor, (idx - pre_new) + pre_len)
    xs = np.arange(n, dtype=np.float64)
    return np.stack([o_interp_extrap(xs, row, pos) for row in M], axis=0)


def _o_fit_1d(x, T):
    x = np.asarray(x)
    if len(x) < T:
        return np.pad(x, (0, T - len(x)), mode="edge")
    return x[:T]


def o_env_shape(block, amount):
    """SillySampler.py:517-551 — es envelope smooth/sharpen."""
    if not block.size or amount == 0.0:
        return block
    s = abs(amount)
    block = np.asarray(block, dtype=np.float64)

    def match_frame_means(orig, mod):
        m0 = np.mean(orig, axis=0, keepdims=True)
        m1 = np.mean(mod, axis=0, keepdims=True)
        return mod * (m0 / (m1 + 1e-12))

    if amount < 0:
        blur = o_gaussian1d(block, 1.0 + 6.0 * s, axis=0)
        return np.maximum(0.0, match_frame_means(block, blur))
    blur = o_gaussian1d(block, 0.8 + 4.0 * s, axis=0)
    out = np.maximum(0.0, block + 5 * s * (block - blur))
    return match_frame_means(block, out)


def o_fw_warp(block, amount):
    """SillySampler.py:553-574 — formant width bin warp."""
    if not block.size:
        return block
    n_bins = block.shape[0]
    bins = np.arange(n_bins, dtype=np.float64)
    center = n_bins / 2.0
    warped = np.clip((bins - center) * (1.0 + amount) + center,
                     0, n_bins - 1)
    lo = np.floor(warped).astype(int)
    hi = np.minimum(lo + 1, n_bins - 1)
    frac = warped - lo
    out = np.empty_like(block)
    for i in range(block.shape[1]):
        col = block[:, i]
        out[:, i] = (1 - frac) * col[lo] + frac * col[hi]
    return out


def o_decode_params(pitch, velocity, flags, offset, length,
                    consonant, cutoff, volume, modulation, tempo,
                    pitch_string):
    """Restated flag/arg decode (SillySampler.py:286-411); returns
    every derived parameter as a dict (tests fuzz it against the
    production sampler.flags.NoteParams decode)."""
    fl = o_parse_flags(flags)
    pitch_m = o_note_to_midi(pitch)
    velocity = float(velocity)
    offset = float(offset) / 1000.0
    length = float(length) / 1000.0
    consonant = float(consonant) / 1000.0
    cutoff = float(cutoff) / 1000.0
    volume = float(volume) / 100.0
    tempo = float(str(tempo).lstrip("!"))
    bend = o_pitch_string_to_cents(pitch_string)

    formant_shift = 1.0 + (fl.get("g", 0) or 0) / 200.0
    brightness_env = ((fl.get("br", 0) or 0) + 100) / 100.0
    f_shifts = [1.0 + (fl.get(k, 0) or 0) / 100.0
                for k in ("fa", "fb", "fc", "fd")]
    sh_val = fl.get("sh", None)
    f0_jitter_on = sh_val is not None and sh_val > 0
    f0_jitter_strength = (sh_val or 0) / 50.0
    sr_val = fl.get("sr", None)
    volume_jitter_on = sr_val is not None and sr_val > 0
    volume_jitter_strength = (sr_val or 0) / 50.0
    sd_strength = float(fl.get("sd", 0) or 0)
    breathiness_mix = ((fl.get("B", 0) or 0) + 100) / 100.0
    unvoiced_mix = ((fl.get("U", 0) or 0) + 100) / 100.0
    harmonic_mix = np.clip(fl.get("V", 100) if fl.get("V") is not None
                           else 100, 0, 100) / 100.0
    loop_flag = next((k for k in fl if k.lower() == "l"), None)
    loop_mode = {0: "concat", 1: "avg", 2: "stretch"}.get(
        fl[loop_flag] if loop_flag else None, "concat")
    tension = (fl.get("st", 0) or 0) / 100.0
    sg_val = fl.get("sg", 0) or 0
    subharm_weight = (sg_val / 100.0) * 1.5
    add_subharm = sg_val > 0
    reverse = fl.get("R", 0) == 1
    growl_mix = np.clip(fl.get("sj", 0) or 0, 0, 100) / 100.0
    aperiodic_mix = np.clip(fl.get("sa", 0) or 0, 0, 100) / 100.0
    subharm_gain = np.clip(fl.get("su", 0) or 0, 0, 100) / 100.0
    normalize = (np.clip(fl["P"], 0, 100) / 100.0) if "P" in fl \
        and fl["P"] is not None else 1.0
    es_raw = next((v for k, v in fl.items() if k.lower() == "es"), 0) or 0
    env_shape_amt = float(np.clip(es_raw, -100, 100)) / 100.0
    force_voiced = fl.get("FV", 0) == 1
    pd_raw = next((v for k, v in fl.items() if k.lower() == "pd"), 0) or 0
    pitch_dyn = float(int(np.clip(pd_raw, -100, 100))) / 100.0
    formant_width = ((fl.get("fw", 0) or 0) / 100.0) * 0.1
    fst = next((v for k, v in fl.items() if k.lower() == "fst"), 0) or 0
    fst_g = float(np.clip(fst, -100, 100)) / 100.0
    strengths = [
        float(np.clip(fst_g + ((next((v for k, v in fl.items()
                                      if k.lower() == key), 0) or 0)
                               / 100.0), -1.0, 1.0))
        for key in ("fsta", "fstb", "fstc", "fstd")]
    t_cents = fl.get("t", 0) or 0
    vf = float(fl.get("vf", 0) or 0)
    vh_val = max(1.0, float(fl.get("vh", 50) if fl.get("vh") is not None
                            else 50))
    vl = float(np.clip(float(fl.get("vl", 15) if fl.get("vl") is not None
                             else 15), 0.0, 100.0))
    return dict(
        pitch_m=pitch_m, velocity=velocity, offset=offset,
        length=length, consonant=consonant, cutoff=cutoff,
        volume=volume, tempo=tempo, bend=bend,
        formant_shift=formant_shift, brightness_env=brightness_env,
        f_shifts=f_shifts, f0_jitter_on=f0_jitter_on,
        f0_jitter_strength=f0_jitter_strength,
        volume_jitter_on=volume_jitter_on,
        volume_jitter_strength=volume_jitter_strength,
        sd_strength=sd_strength, breathiness_mix=breathiness_mix,
        unvoiced_mix=unvoiced_mix, harmonic_mix=harmonic_mix,
        loop_mode=loop_mode, tension=tension,
        subharm_weight=subharm_weight, add_subharm=add_subharm,
        reverse=reverse, growl_mix=growl_mix,
        aperiodic_mix=aperiodic_mix, subharm_gain=subharm_gain,
        normalize=normalize, env_shape_amt=env_shape_amt,
        force_voiced=force_voiced, pitch_dyn=pitch_dyn,
        formant_width=formant_width, strengths=strengths,
        t_cents=t_cents, vf=vf, vh_val=vh_val, vl=vl,
        use_editor=next((v for k, v in fl.items()
                         if k.lower() == 'se'), 0) == 1,
    )


def o_resample(features, pitch, velocity, flags="", offset=0, length=1000,
               consonant=0, cutoff=0, volume=100, modulation=0,
               tempo="!120", pitch_string="AA", *,
               uv_strength=0.75, breath_strength=0.1,
               rng=None, hop=256, n_fft=1024, collect=None):
    """The ENTIRE reference note chain, SillySampler.py:449-1185 (with the
    286-411 flag decode), sequential NumPy.  ``features`` is the
    (env_dense, f0_interp, voicing_mask, formants{1..4}, sr, ylen) tuple
    BEFORE the R-flag reverse (applied here, like ref render():438-444).

    ``rng=None`` zeroes every noise phase (and is only valid for flag
    sets without sh/sr/sj — those require noise); pass uv_strength=0,
    breath_strength=0 and a P0 flag for bit-deterministic output.
    Returns the final waveform (post volume/dyn-gain)."""
    env_spec, f0_interp, voicing_mask, forms, sr, ylen = features
    env_spec = np.asarray(env_spec, dtype=np.float64).copy()
    f0_interp = np.asarray(f0_interp, dtype=np.float64)
    voicing_mask = np.asarray(voicing_mask, dtype=np.float64)
    forms = {k: np.asarray(v, dtype=np.float64) for k, v in forms.items()}

    # ---- decode (SillySampler.py:294-411) ----------------------------
    _d = o_decode_params(pitch, velocity, flags, offset, length,
                         consonant, cutoff, volume, modulation,
                         tempo, pitch_string)
    (pitch_m, velocity, offset, length, consonant, cutoff, volume,
     tempo, bend) = (_d['pitch_m'], _d['velocity'], _d['offset'],
                     _d['length'], _d['consonant'], _d['cutoff'],
                     _d['volume'], _d['tempo'], _d['bend'])
    formant_shift = _d['formant_shift']
    brightness_env = _d['brightness_env']
    f_shifts = _d['f_shifts']
    f0_jitter_on = _d['f0_jitter_on']
    f0_jitter_strength = _d['f0_jitter_strength']
    volume_jitter_on = _d['volume_jitter_on']
    volume_jitter_strength = _d['volume_jitter_strength']
    sd_strength = _d['sd_strength']
    breathiness_mix = _d['breathiness_mix']
    unvoiced_mix = _d['unvoiced_mix']
    harmonic_mix = _d['harmonic_mix']
    loop_mode = _d['loop_mode']
    tension = _d['tension']
    subharm_weight = _d['subharm_weight']
    add_subharm = _d['add_subharm']
    reverse = _d['reverse']
    growl_mix = _d['growl_mix']
    aperiodic_mix = _d['aperiodic_mix']
    subharm_gain = _d['subharm_gain']
    normalize = _d['normalize']
    env_shape_amt = _d['env_shape_amt']
    force_voiced = _d['force_voiced']
    pitch_dyn = _d['pitch_dyn']
    formant_width = _d['formant_width']
    strengths = _d['strengths']
    t_cents = _d['t_cents']
    vf, vh_val, vl = _d['vf'], _d['vh_val'], _d['vl']

    # ---- reverse (ref render():438-444) ------------------------------
    if reverse:
        env_spec = env_spec[:, ::-1]
        f0_interp = f0_interp[::-1]
        voicing_mask = voicing_mask[::-1]
        forms = {k: forms[k][::-1] for k in forms}

    # ---- cut math (449-500) ------------------------------------------
    sample_length_sec = ylen / sr
    start_sec_base = offset
    if cutoff < 0:
        end_sec_base = offset - cutoff
    else:
        end_sec_base = sample_length_sec - cutoff
    if reverse:
        L = end_sec_base - start_sec_base
        offset_used = sample_length_sec - end_sec_base
        cutoff_used = sample_length_sec - (offset_used + L)
    else:
        offset_used, cutoff_used = offset, cutoff
    start_sample = int(offset_used * sr)
    consonant_sample = start_sample + int(consonant * sr)
    if cutoff_used < 0:
        end_sec = offset_used - cutoff_used
    else:
        end_sec = sample_length_sec - cutoff_used
    end_sample = int(end_sec * sr)

    start_frame = start_sample // hop
    consonant_frame = consonant_sample // hop
    end_frame = end_sample // hop

    env_pre = env_spec[:, start_frame:consonant_frame].copy()
    f0_pre = f0_interp[start_sample:consonant_sample].copy()
    mask_pre = voicing_mask[start_sample:consonant_sample].copy()
    env_tail = env_spec[:, consonant_frame:end_frame].copy()
    f0_tail = f0_interp[consonant_sample:end_sample].copy()
    mask_tail = voicing_mask[consonant_sample:end_sample].copy()

    # ---- br tilt (502-515) -------------------------------------------
    if brightness_env != 1.0 and (env_pre.size or env_tail.size):
        n_bins = (env_pre if env_pre.size else env_tail).shape[0]
        freqs = np.linspace(1e-6, sr * 0.5, n_bins, dtype=np.float32)
        norm_f = np.clip(freqs / (sr * 0.5), 0.02, 1.0)
        alpha = np.clip(brightness_env - 1.0, -0.9, 1.0)
        tilt = norm_f ** alpha
        tilt = tilt / (tilt.mean() + 1e-12)
        if env_pre.size:
            env_pre *= tilt[:, None]
        if env_tail.size:
            env_tail *= tilt[:, None]

    # ---- es shape (517-551) ------------------------------------------
    if env_shape_amt != 0.0:
        env_pre = o_env_shape(env_pre, env_shape_amt)
        env_tail = o_env_shape(env_tail, env_shape_amt)

    # ---- fw width (553-574) ------------------------------------------
    if formant_width != 0.0:
        env_pre = o_fw_warp(env_pre, formant_width)
        env_tail = o_fw_warp(env_tail, formant_width)

    # (SE editor skipped: oracle is headless, ref 576-616)

    # ---- FV (618-623) ------------------------------------------------
    if force_voiced:
        mask_pre[:] = 1.0
        mask_tail[:] = 1.0

    # ---- loops (625-754) ---------------------------------------------
    desired_tail_samples = int(length * sr)
    desired_tail_frames = int(np.ceil(length * sr / hop))

    env_tail_looped = o_loop_env(env_tail, desired_tail_frames, loop_mode)
    tail_len = len(f0_tail)
    if tail_len >= desired_tail_samples:
        f0_tail_looped = f0_tail[:desired_tail_samples]
        mask_tail_looped = mask_tail[:desired_tail_samples]
    else:
        f0_tail_looped = o_loop_samples(f0_tail, desired_tail_samples)
        mask_tail_looped = o_loop_samples(mask_tail, desired_tail_samples)

    formants_pre = {k: v[start_frame:consonant_frame]
                    for k, v in forms.items()}
    formants_tail = {k: v[consonant_frame:end_frame]
                     for k, v in forms.items()}
    formants_new = {
        k: np.concatenate([formants_pre[k],
                           o_loop_track(formants_tail[k],
                                        desired_tail_frames, loop_mode)])
        for k in forms}

    env_new = np.concatenate([env_pre, env_tail_looped], axis=1)
    f0_new = np.concatenate([f0_pre, f0_tail_looped])
    mask_new = np.concatenate([mask_pre, mask_tail_looped])

    target_frames = env_new.shape[1]
    for k in formants_new:
        formants_new[k] = _o_fit_1d(formants_new[k], target_frames)

    # ---- velocity (765-789) ------------------------------------------
    vel_factor = float(2.0 ** (1.0 - (velocity / 100.0)))
    pre_frames = env_pre.shape[1]
    pre_samples = len(f0_pre)
    if abs(vel_factor - 1.0) > 1e-6 and pre_frames > 1 and pre_samples > 1:
        env_new = o_stretch_prefix_2d(env_new, pre_frames, vel_factor)
        new_t = env_new.shape[1]
        formants_new = {
            k: _o_fit_1d(o_stretch_prefix_1d(track, pre_frames, vel_factor),
                         new_t)
            for k, track in formants_new.items()}
        f0_new = o_stretch_prefix_1d(f0_new, pre_samples, vel_factor)
        mask_new = o_stretch_prefix_1d(mask_new, pre_samples, vel_factor)

    # ---- formant strength bells (791-833) ----------------------------
    # reference quirk: canon re-fits to the PRE-velocity target_frames,
    # sanitize then edge-pads back out to T (SillySampler.py:756,792)
    formants_canon = {f"F{k}": _o_fit_1d(np.asarray(v, dtype=np.float32),
                                         target_frames)
                      for k, v in formants_new.items()}
    T = env_new.shape[1]
    min_hz = (120.0, 300.0, 1500.0, 2000.0)
    Fs = [o_sanitize_formant(
        formants_canon.get(f"F{i+1}", np.zeros(T)), T, sr,
        min_hz=min_hz[i], sigma_frames=4) for i in range(4)]

    # UPSTREAM SIDE EFFECT (SillySampler.py:264-283 via 802-805):
    # sanitize_smooth_formant's `x = np.asarray(track, np.float32)`
    # ALIASES the float32 track in formants_new, so its gap-fill
    # `x[bad] = interp(...)` writes the interpolated/extrapolated values
    # back into the dict that later feeds gf.synthesize's formant warp
    # (line 1015) — invalid anchors (zeros in the unvoiced head, frames
    # below the per-formant min_hz floor) arrive at the warp FILLED, not
    # dropped.  The smoothing and the all-bad fallback rebind x, so only
    # the fill leaks; pad/slice breaks aliasing when the track length
    # differs from T (the post-velocity frame count).
    for i in range(4):
        tr = formants_canon.get(f"F{i+1}")
        if tr is None or len(tr) != T:
            continue
        bad = (~np.isfinite(tr)) | (tr < min_hz[i]) | (tr > sr * 0.48)
        if bad.any() and (~bad).any():
            good = np.where(~bad)[0]
            tr[bad] = o_interp_extrap(
                good.astype(np.float64), tr[good].astype(np.float64),
                np.where(bad)[0].astype(np.float64)).astype(np.float32)

    if any(abs(s) > 1e-6 for s in strengths):
        n_bins = env_new.shape[0]
        freqs = np.linspace(0.0, sr / 2.0, n_bins, dtype=np.float32)
        sigma_hz = (100.0, 200.0, 350.0, 500.0)
        gain_env = np.ones_like(env_new)
        for t in range(T):
            for k in range(4):
                if abs(strengths[k]) < 1e-6:
                    continue
                fv = float(Fs[k][t])
                if not np.isfinite(fv) or fv <= 50.0 or fv >= sr * 0.5:
                    continue
                w = np.exp(-0.5 * ((freqs - fv) / sigma_hz[k]) ** 2)
                gain_env[:, t] *= 1.0 + strengths[k] * w
        env_new = env_new * gain_env

    # ---- pitch curve (835-855) ---------------------------------------
    n_total = len(f0_new)
    t_samples = np.arange(n_total) / sr
    pitch_semi = bend.astype(np.float64) / 100.0 + pitch_m
    if t_cents:
        pitch_semi = pitch_semi + t_cents / 100.0
    tick_dt = 60.0 / (tempo * 96.0)
    t_pitch = np.arange(len(pitch_semi)) * tick_dt
    t_clamped = np.clip(t_samples, t_pitch[0], t_pitch[-1])
    if len(pitch_semi) == 1:
        midi_curve = np.full(n_total, float(pitch_semi[0]))
    else:
        midi_curve = o_interp_extrap(t_pitch, pitch_semi, t_clamped)
    f0_new = mask_new * (440.0 * 2.0 ** ((midi_curve - 69.0) / 12.0))

    # ---- pd dynamics (857-881) ---------------------------------------
    dyn_gain = None
    if pitch_dyn != 0.0:
        baseline_midi = pitch_m + (t_cents / 100.0)
        bend_semi = (midi_curve - baseline_midi).astype(np.float64)
        bend_s = o_gaussian1d(bend_semi, max(1, int(0.010 * sr)))
        ref95 = float(np.percentile(np.abs(bend_s), 95)) + 1e-8
        v = np.clip(bend_s / ref95, -1.0, 1.0)
        signed = v if pitch_dyn > 0 else -v
        gain_db = 12.0 * abs(pitch_dyn) * signed
        dyn_gain = np.clip(np.power(10.0, gain_db / 20.0), 1e-3, 1e3)
        vmask_s = o_gaussian1d(mask_new, int(0.01 * sr))
        dyn_gain = 1.0 + (dyn_gain - 1.0) * vmask_s

    # ---- fry (883-996) -----------------------------------------------
    fry_mask = None
    if vf != 0:
        vf = float(np.clip(vf, -100.0, 100.0))
        n = n_total
        if vf > 0:
            L = int(round(n * (vf / 100.0)))
            if L > 0:
                glide_len = int(np.clip(int(round(L * (vl / 100.0))), 0, L))
                const_len = L - glide_len
                if const_len > 0:
                    f0_new[:const_len] = vh_val * (mask_new[:const_len] > 0)
                if glide_len > 0:
                    s = slice(const_len, L)
                    w = np.linspace(0.0, 1.0, glide_len, endpoint=True)
                    base = vh_val * (mask_new[s] > 0)
                    f0_new[s] = (1.0 - w) * base + w * f0_new[s]
        else:
            L = int(round(n * (abs(vf) / 100.0)))
            if L > 0:
                glide_len = int(np.clip(int(round(L * (vl / 100.0))), 0, L))
                const_len = L - glide_len
                start = n - L
                if glide_len > 0:
                    s = slice(start, start + glide_len)
                    w = np.linspace(1.0, 0.0, glide_len, endpoint=True)
                    base = vh_val * (mask_new[s] > 0)
                    f0_new[s] = (1.0 - w) * base + w * f0_new[s]
                if const_len > 0:
                    s = slice(start + glide_len, n)
                    f0_new[s] = vh_val * (mask_new[s] > 0)

        # fry region mask (936-965)
        mid = n // 2
        if vf > 0:
            L2 = int(round(mid * (vf / 100.0)))
            s_i, e_i = 0, max(0, min(n, L2))
        else:
            L2 = int(round((n - mid) * (abs(vf) / 100.0)))
            s_i, e_i = max(0, n - L2), n
        if e_i > s_i:
            fry_mask = np.zeros(n)
            fry_mask[s_i:e_i] = 1.0
            fade = int(0.01 * sr)
            if fade > 0:
                a1 = min(e_i, s_i + fade)
                if a1 > s_i:
                    fry_mask[s_i:a1] *= np.linspace(0, 1, a1 - s_i,
                                                    endpoint=True)
                b0 = max(s_i, e_i - fade)
                if e_i > b0:
                    fry_mask[b0:e_i] *= np.linspace(1, 0, e_i - b0,
                                                    endpoint=True)

        # fry formant shift (967-996)
        if fry_mask is not None and env_new.size:
            n_bins, n_frames = env_new.shape
            centers = np.minimum(len(fry_mask) - 1,
                                 (np.arange(n_frames) * hop
                                  + hop // 2)).astype(int)
            frame_w = fry_mask[centers]
            bin_idx = np.arange(n_bins, dtype=np.float64)
            for j in np.nonzero(frame_w > 1e-6)[0]:
                s = 1.0 - float(frame_w[j]) * (1.0 - 0.92)
                if abs(s - 1.0) < 1e-6:
                    continue
                src = np.clip(bin_idx / s, 0.0, n_bins - 1.0)
                lo = np.floor(src).astype(np.int32)
                hi = np.minimum(lo + 1, n_bins - 1)
                frac = src - lo
                col = env_new[:, j]
                env_new[:, j] = (1.0 - frac) * col[lo] + frac * col[hi]

    # ---- main synthesis (1003-1035) ----------------------------------
    formants_arr = np.stack([
        _o_fit_1d(formants_canon.get(f"F{i+1}", np.zeros(1)),
                  env_new.shape[1]) for i in range(4)])
    synth_common = dict(
        formants=formants_arr, f_shifts=f_shifts,
        formant_shift=formant_shift, normalize=normalize)
    _, harmonic, aper_uv, aper_bre = o_synthesize(
        env_new, f0_new, mask_new, n_total, sr, n_fft, hop,
        uv_strength=uv_strength, breath_strength=breath_strength,
        rng=rng,
        add_subharm=add_subharm, subharm_weight=subharm_weight,
        subharm_semitones=12, subharm_vibrato=True,
        subharm_vibrato_rate=75, subharm_vibrato_depth=3,
        subharm_vibrato_delay=0.01,
        volume_jitter=volume_jitter_on,
        volume_jitter_strength=volume_jitter_strength,
        f0_jitter=f0_jitter_on, f0_jitter_strength=f0_jitter_strength,
        jitter_rng=rng, **synth_common)

    # ---- su sub-octave layer (1037-1059) -----------------------------
    if subharm_gain > 0.0:
        _, harm_sub, _, _ = o_synthesize(
            env_new, f0_new * 0.5, mask_new, n_total, sr, n_fft, hop,
            rng=rng, **synth_common)
        f0_cut = np.maximum(f0_new, 120.0)
        for _ in range(2):
            harm_sub = o_dynamic_butter(harm_sub, f0_cut, sr, 1.0, 6,
                                        "highpass")
        harmonic = harmonic + harm_sub * subharm_gain

    # ---- sj growl layer (1061-1081) ----------------------------------
    if growl_mix > 0.0:
        noise = (rng.normal(0.0, growl_mix ** 2, n_total)
                 if rng is not None else np.zeros(n_total))
        _, harm_gw, _, _ = o_synthesize(
            env_new, f0_new * (0.5 * 2.0 ** noise), mask_new, n_total,
            sr, n_fft, hop, rng=rng, **synth_common)
        f0_hp = np.maximum(f0_new, 120.0)
        for _ in range(2):
            harm_gw = o_dynamic_butter(harm_gw, f0_hp, sr, 1.0, 6,
                                       "highpass")
        harmonic = (1.0 - growl_mix) * harmonic + growl_mix * harm_gw

    # ---- fry highpass blend (1083-1099) ------------------------------
    if fry_mask is not None:
        ones = np.ones_like(f0_new)
        harm_hp = o_dynamic_butter(harmonic, ones, sr, 200.0, 6,
                                   "highpass")
        bre_hp = o_dynamic_butter(aper_bre, ones, sr, 200.0, 6,
                                  "highpass")
        harmonic = harmonic * (1.0 - fry_mask) + harm_hp * fry_mask
        aper_bre = aper_bre * (1.0 - fry_mask) + bre_hp * fry_mask

    # ---- sd dryness (1101-1112) --------------------------------------
    if sd_strength > 0:
        breath_j = o_volume_jitter_vibrato(len(aper_bre), sr, 150.0,
                                           sd_strength / 200.0)
        vmask_smooth = o_gaussian1d(mask_new, 20.0)
        aper_bre = aper_bre * (1.0 + (breath_j - 1.0) * vmask_smooth)
        aper_bre = aper_bre * (1.0 + (sd_strength / 100.0) * 10)

    # ---- st tension (1114-1140) --------------------------------------
    if tension != 0:
        rms_before = np.sqrt(np.mean((harmonic + aper_bre) ** 2))
        abs_ten = abs(tension)
        if tension < 0:
            order = int(np.clip(int(np.round(1 + abs_ten * 4)), 1, 6))
            harmonic = o_dynamic_butter(harmonic, f0_new, sr,
                                        2.0 - abs_ten * 0.75, order,
                                        "lowpass")
            aper_bre = o_dynamic_butter(aper_bre, f0_new, sr, abs_ten, 4,
                                        "highpass")
        else:
            hp = o_dynamic_butter(harmonic, f0_new, sr, abs_ten * 4, 4,
                                  "highpass")
            harmonic = harmonic + hp * (1.0 + abs_ten * 20.0)
            aper_bre = o_dynamic_butter(aper_bre, f0_new, sr,
                                        (2.0 - abs_ten) / 0.5, 6,
                                        "lowpass")
            aper_bre = aper_bre * (1.0 - abs_ten)
        rms_after = np.sqrt(np.mean((harmonic + aper_bre) ** 2))
        if rms_after > 0:
            g = rms_before / rms_after
            harmonic *= g
            aper_bre *= g

    # ---- mix + sa + dyn gain (1142-1182) -----------------------------
    out = (harmonic * harmonic_mix + aper_bre * breathiness_mix
           + aper_uv * unvoiced_mix) * volume

    if aperiodic_mix > 0.0:
        _, _, uv_u, bre_u = o_synthesize(
            env_new, f0_new, np.ones_like(mask_new), n_total, sr, n_fft,
            hop, uv_strength=1.0, breath_strength=1.0,
            noise_smoothness=1, rng=rng, **synth_common)
        out = out * (1.0 - aperiodic_mix) \
            + (uv_u + bre_u) * volume * aperiodic_mix

    if dyn_gain is not None:
        out = out * dyn_gain
    if collect is not None:
        collect.update(f0_new=f0_new, mask_new=mask_new, env_new=env_new,
                       su_on=subharm_gain > 0.0, sg_on=add_subharm,
                       harmonic=harmonic, aper_uv=aper_uv,
                       aper_bre=aper_bre)
    return out
