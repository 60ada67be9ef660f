"""LF glottal pulse train, vectorized.

The reference generates pulses with a sequential per-sample phase accumulator
(``pulse_train_numba``, ref: GOOFER.py:473-554) and a per-ratio event tracker
for subharmonics (ref: GOOFER.py:672-746).  A sequential per-sample loop
leaves an accelerator idle, so this module reformulates both exactly:

* phase accumulation -> ``cumsum(f0/sr)``; a pulse onset is a sample where
  ``floor(phase)`` increases (the reference fires when the running phase
  crosses the next integer, and f0 < sr guarantees at most one crossing per
  sample);
* the ``last_valid_f0`` carry -> a forward-fill computed with ``cummax`` over
  masked indices;
* the variable-length pulse scatter -> a bounded-overlap gather-sum: the LF
  pulse evaluated on the grid ``t_j = j*T/T0`` is a closed-form function of
  ``u = j/T0`` alone (the open/return phase knees scale with T), so sample n
  receives ``sum_k p((n - onset_k)/T0_k)`` over the last K onsets.  K bounds
  simultaneous pulse overlap; the reference allows unbounded overlap but
  anything beyond K generations back contributes only the low-amplitude tail
  of a pulse (and exactly zero once u > Ra + Rk*(1-Ra)).
* per-pulse peak normalization -> closed form: the LF shape rises
  monotonically for u < Ra and decays monotonically after, so the grid
  maximum is attained at one of the two grid points straddling u = Ra.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from goofer_tpu import config


def _last_valid_index(valid: jnp.ndarray) -> jnp.ndarray:
    """Index of the most recent valid sample <= i, or -1.  A cummax over
    masked indices — one native cumulative-op HLO (associative_scan would
    unroll into log(N) slice/concat layers and blow up compile time)."""
    n = valid.shape[0]
    idx = jnp.where(valid, jnp.arange(n, dtype=jnp.int32), jnp.int32(-1))
    return jax.lax.cummax(idx, axis=0)


def forward_fill(values: jnp.ndarray, valid: jnp.ndarray,
                 init: float) -> jnp.ndarray:
    """values[i] from the most recent valid index <= i, else ``init``."""
    ff = _last_valid_index(valid)
    filled = jnp.take(values, jnp.maximum(ff, 0))
    return jnp.where(ff >= 0, filled, jnp.asarray(init, values.dtype))


def lf_pulse_value(u: jnp.ndarray, T: jnp.ndarray, Ra: float, Rg: float,
                   Rk: float, guard: bool) -> jnp.ndarray:
    """LF pulse evaluated at normalized position u = t/T in [0, 1).

    ``guard=True`` reproduces the tiny epsilon guards of the Numba kernel
    (ref: GOOFER.py:514-517) which are scaled by the period T;
    ``guard=False`` matches ``lf_model_pulse`` (ref: GOOFER.py:437-462).
    """
    uc = Ra + Rk * (1.0 - Ra)
    if guard:
        rise = jnp.sin(jnp.pi * u * T / (2.0 * Ra * T + 1e-12)) ** 2
        tau = (u - Ra) * T / ((uc - Ra) * T + 1e-12)
    else:
        rise = jnp.sin(jnp.pi * u / (2.0 * Ra)) ** 2
        tau = (u - Ra) / (uc - Ra)
    decay = jnp.exp(-Rg * tau) * jnp.cos(jnp.pi * tau / 2.0)
    out = jnp.where(u < Ra, rise, jnp.where(u < uc, decay, 0.0))
    return jnp.where((u >= 0.0) & (u < 1.0), out, 0.0)


def _grid_peak(T0: jnp.ndarray, T: jnp.ndarray, Ra: float, Rg: float,
               Rk: float, guard: bool) -> jnp.ndarray:
    """max_j |p(j/T0)| in closed form (monotone rise then monotone decay)."""
    j_lo = jnp.floor(Ra * T0)
    j_hi = jnp.minimum(j_lo + 1.0, T0 - 1.0)
    p_lo = lf_pulse_value(j_lo / T0, T, Ra, Rg, Rk, guard)
    p_hi = lf_pulse_value(j_hi / T0, T, Ra, Rg, Rk, guard)
    peak = jnp.maximum(p_lo, p_hi)
    return jnp.maximum(peak, 1e-12)


def _onsets_from_phase(phase: jnp.ndarray) -> jnp.ndarray:
    """True at samples where floor(phase) increased (integer crossing)."""
    k = jnp.floor(phase)
    k_prev = jnp.concatenate([jnp.zeros((1,), k.dtype), k[:-1]])
    return k > k_prev


def _two_sum(a, b):
    """Knuth error-free transform: a + b = s + err exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _df_combine(x, y):
    xh, xl = x
    yh, yl = y
    s, e = _two_sum(xh, yh)
    e = e + xl + yl
    hi = s + e
    lo = e - (hi - s)
    return hi, lo


def _phase_cumsum(df: jnp.ndarray) -> jnp.ndarray:
    """Drift-free running phase: double-float (TwoSum-compensated)
    associative scan, ~2^-45-relative accumulated error vs ~1e-3 cycles
    for a plain f32 cumsum by the end of a 0.5 s note.  The reference
    accumulates its phase in float64 (GOOFER.py:504-506); without this,
    integer-crossing (pulse onset) decisions near sample boundaries
    flip between the f32 and f64 accumulations and single onsets land
    one sample off (tests/test_resample_oracle.py caught exactly that
    on an exact-220 Hz note)."""
    hi, lo = jax.lax.associative_scan(
        _df_combine, (df, jnp.zeros_like(df)))
    return hi + lo


def _accumulate_pulses(n_samples: int, onset: jnp.ndarray,
                       T0_track: jnp.ndarray, T_track: jnp.ndarray,
                       Ra: float, Rg: float, Rk: float, guard: bool,
                       max_overlap: int) -> jnp.ndarray:
    """Sum LF pulses started at onset samples, K-bounded overlap.

    ``T0_track``/``T_track`` give, per sample, the period (samples /
    seconds) a pulse would use if it started there; they are only read at
    onsets.

    Formulation: let P_0[n] be the position of the most recent onset <= n
    (a cummax over masked indices) and P_k the onset k generations back —
    obtained by, at each onset, adopting P_{k-1} from the previous sample
    and cummax-propagating forward.  Each level costs one cummax (a single
    native cumulative HLO) plus ONE gather of the period track at the
    onset positions; period/eps-guard/normalization are then recomputed
    elementwise.  This replaces the naive four-table-gathers-per-level
    lowering without the compile-time blowup of explicit associative-scan
    forward fills.
    """
    n = n_samples
    sample_idx = jnp.arange(n, dtype=jnp.float32)
    T0f = T0_track.astype(jnp.float32)
    Tf = T_track.astype(jnp.float32)

    out = jnp.zeros((n,), dtype=jnp.float32)
    p_idx = _last_valid_index(onset)                    # int32, -1 if none
    for k in range(max_overlap):
        ok = p_idx >= 0
        pos = jnp.maximum(p_idx, 0)
        T0_g = jnp.take(T0f, pos)
        T_g = jnp.take(Tf, pos)
        nrm = _grid_peak(T0_g, T_g, Ra, Rg, Rk, guard)
        offs = sample_idx - pos.astype(jnp.float32)
        u = offs / T0_g
        val = lf_pulse_value(u, T_g, Ra, Rg, Rk, guard) / nrm
        out = out + jnp.where(ok & (offs >= 0) & (offs < T0_g), val, 0.0)
        if k + 1 < max_overlap:
            # position of the onset one generation further back: at each
            # onset sample, adopt the previous sample's current level
            prev = jnp.concatenate(
                [jnp.full((1,), -1, jnp.int32), p_idx[:-1]])
            p_idx = jax.lax.cummax(
                jnp.where(onset, prev, jnp.int32(-1)), axis=0)
    return out


def _compact_onset_tables(n: int, onset, f0, valid_f0, fallback_f0, sr,
                          Ra, Rg, Rk, guard, min_spacing: int):
    """Compact per-generation onset tables, scatter- and gather-light.

    ``gen = cumsum(onset)`` is nondecreasing, so the sample index of the
    (r+1)-th onset is ``searchsorted(gen, r+1)`` — a batched binary
    search instead of a scatter (the scatter formulation routed every
    non-onset sample into one dump row, a pattern that serializes on
    colliding writes).

    The period at each onset is the reference's ``last_valid_f0`` carry
    (ref: GOOFER.py:487-500) evaluated LAZILY: the forward-fill index is
    a native cummax, and f0 is gathered only at the M table rows — a
    full-length forward-filled track would cost an n-element gather
    just to be read back at M << n positions.

    Returns (row_of_latest_onset_per_sample, pos_tab, t0_tab, t_tab,
    norm_tab) with M = n // min_spacing + 2; rows past the last true
    onset hold (4 * n, 1, 1, 1): a position no sample reaches.
    """
    m = n // min_spacing + 2
    gen = jnp.cumsum(onset.astype(jnp.int32))
    row = gen - 1                                  # 0-based, -1 before first
    queries = jnp.arange(1, m + 1, dtype=gen.dtype)
    pos = jnp.searchsorted(gen, queries, side="left")
    valid = pos < n
    pos_c = jnp.minimum(pos, n - 1)

    ff = _last_valid_index(valid_f0)               # native cummax, no gather
    src = jnp.take(ff, pos_c)                      # M-sized gathers only
    f0_at = jnp.where(src >= 0,
                      jnp.take(f0.astype(jnp.float32),
                               jnp.maximum(src, 0)),
                      jnp.float32(fallback_f0))
    t_g = 1.0 / jnp.maximum(f0_at, 1e-6)
    t0_g = jnp.clip(jnp.round(sr * t_g),
                    config.PULSE_T0_MIN, config.PULSE_T0_MAX)

    pos_tab = jnp.where(valid, pos.astype(jnp.float32), float(4 * n))
    t0_tab = jnp.where(valid, t0_g, 1.0)
    t_tab = jnp.where(valid, t_g, 1.0)
    norm_tab = jnp.where(valid, _grid_peak(t0_g, t_g, Ra, Rg, Rk, guard),
                         1.0)
    return row, pos_tab, t0_tab, t_tab, norm_tab


def _accumulate_pulses_blocked(n_samples: int, onset: jnp.ndarray,
                               f0: jnp.ndarray, valid_f0: jnp.ndarray,
                               fallback_f0: float, sr: float,
                               Ra: float, Rg: float, Rk: float, guard: bool,
                               max_overlap: int, min_spacing: int = 16,
                               blk: int = 128) -> jnp.ndarray:
    """Block-local pulse accumulation — the production path.

    Per 128-sample block, gather a slab of consecutive onset rows covering
    [gen(block_start) - K + 1, gen(block_end)] from compact tables, then
    evaluate every (row, sample) pair densely and reduce.  Gathers drop
    from N*K elements (per-sample lookups) to n_blocks*slab (~500x
    fewer); the extra masked evaluations are cheap elementwise work.
    ``blk`` = 128 was tuned for another accelerator and is not yet
    measured on the GPU (ROADMAP.md).  ``min_spacing`` (assumed minimum
    onset distance in samples) sizes the slab; onsets denser than that
    can overflow it and drop pulses, mirroring the K-overlap
    approximation on the other end.
    """
    n = n_samples
    row, pos_tab, t0_tab, t_tab, norm_tab = _compact_onset_tables(
        n, onset, f0, valid_f0, fallback_f0, sr, Ra, Rg, Rk, guard,
        min_spacing)
    m = pos_tab.shape[0]

    n_blocks = -(-n // blk)
    starts = jnp.arange(n_blocks, dtype=jnp.int32) * blk
    g0 = jnp.take(row, jnp.minimum(starts, n - 1))
    slab = min(m, max_overlap + blk // min_spacing + 2)
    base = jnp.clip(g0 - (max_overlap - 1), 0, m - slab)
    idx = base[:, None] + jnp.arange(slab, dtype=jnp.int32)[None, :]

    pos = jnp.take(pos_tab, idx)[:, :, None]       # (n_blocks, slab, 1)
    t0 = jnp.take(t0_tab, idx)[:, :, None]
    ts = jnp.take(t_tab, idx)[:, :, None]
    nrm = jnp.take(norm_tab, idx)[:, :, None]

    t_grid = (starts[:, None, None]
              + jnp.arange(blk, dtype=jnp.int32)[None, None, :]
              ).astype(jnp.float32)                # (n_blocks, 1, blk)
    offs = t_grid - pos
    u = offs / t0
    val = lf_pulse_value(u, ts, Ra, Rg, Rk, guard) / nrm
    contrib = jnp.where((offs >= 0.0) & (offs < t0), val, 0.0)
    return contrib.sum(axis=1).reshape(-1)[:n]


def pulse_train(f0: jnp.ndarray, sr: float,
                Ra: float = config.PULSE_RA,
                Rg: float = config.PULSE_RG,
                Rk: float = config.PULSE_RK,
                fallback_f0: float = config.PULSE_FALLBACK_F0,
                max_overlap: int = config.PULSE_MAX_OVERLAP,
                min_spacing: int = config.PULSE_MIN_SPACING) -> jnp.ndarray:
    """ARX-LF pulse train from a per-sample f0 track.

    Vectorized equivalent of ``pulse_train_numba`` (ref: GOOFER.py:473-554):
    phase accumulates f0/sr every sample (voiced or not); each integer
    crossing starts one peak-normalized LF pulse whose period comes from the
    most recent f0 > 1e-6 (initially ``fallback_f0``), clamped to
    [3, 8192] samples.

    The block-local formulation (see _accumulate_pulses_blocked) is the
    default; very short inputs fall back to the per-sample cummax path.
    """
    f0 = jnp.asarray(f0, dtype=jnp.float32)
    n = f0.shape[0]
    valid = f0 > 1e-6
    phase = _phase_cumsum(f0 / sr)
    onset = _onsets_from_phase(phase)
    if n >= 256:
        return _accumulate_pulses_blocked(n, onset, f0, valid, fallback_f0,
                                          sr, Ra, Rg, Rk, guard=True,
                                          max_overlap=max_overlap,
                                          min_spacing=min_spacing)
    f0v = forward_fill(f0, valid, fallback_f0)
    T = 1.0 / jnp.maximum(f0v, 1e-6)
    T0 = jnp.clip(jnp.round(sr * T), config.PULSE_T0_MIN, config.PULSE_T0_MAX)
    return _accumulate_pulses(n, onset, T0, T, Ra, Rg, Rk, guard=True,
                              max_overlap=max_overlap)


def subharm_pulse_train(f0: jnp.ndarray, sr: float, mask: jnp.ndarray,
                        semitones, weight: float,
                        fallback_f0: float = config.PULSE_FALLBACK_F0,
                        max_overlap: int = 8,
                        min_spacing: int = 8) -> jnp.ndarray:
    """Subharmonic pulse layer (ref: GOOFER.py:672-746).

    Per semitone ratio, a phase tracker accumulates ``sub_f0/sr`` on voiced
    samples only (sub_f0 = ratio * forward-filled f0) and fires an LF pulse
    (Ra=0.02, Rg=1.7, Rk=1) at each integer crossing.  The summed pulse is
    gated by the voicing mask, peak-normalized globally, then scaled by
    ``weight``.
    """
    f0 = jnp.asarray(f0, dtype=jnp.float32)
    mask = jnp.asarray(mask, dtype=jnp.float32)
    n = f0.shape[0]
    if not isinstance(semitones, (list, tuple, np.ndarray)):
        semitones = [semitones]

    active = (mask > 0) & (f0 > 0)

    total = jnp.zeros((n,), dtype=jnp.float32)
    for semi in semitones:
        ratio = 2.0 ** (float(semi) / 12.0)
        # at active samples the reference's forward-filled last_f0 equals
        # the current f0, and the phase only advances (and onsets only
        # fire) at active samples — so the filled track is never read
        # where it differs from f0 * ratio (ref: GOOFER.py:672-698)
        sub_f0 = f0 * ratio
        accumulating = active & (sub_f0 >= 1e-2)
        phase = _phase_cumsum(jnp.where(accumulating, sub_f0 / sr, 0.0))
        onset = _onsets_from_phase(phase) & accumulating
        if n >= 256:
            total = total + _accumulate_pulses_blocked(
                n, onset, sub_f0, accumulating, fallback_f0 * ratio, sr,
                Ra=0.02, Rg=1.7, Rk=1.0, guard=False,
                max_overlap=max_overlap, min_spacing=min_spacing)
        else:
            last_f0 = forward_fill(f0, active, fallback_f0)
            sub_full = last_f0 * ratio
            T = 1.0 / jnp.maximum(sub_full, 1e-6)
            T0 = jnp.clip(jnp.round(sr * T), config.PULSE_T0_MIN,
                          config.PULSE_T0_MAX)
            total = total + _accumulate_pulses(
                n, onset, T0, T, Ra=0.02, Rg=1.7, Rk=1.0, guard=False,
                max_overlap=max_overlap)

    total = total * mask
    peak = jnp.max(jnp.abs(total))
    total = jnp.where(peak > 1e-6, total / peak, total)
    return total * weight
