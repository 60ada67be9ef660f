"""The fused note-render graph.

Everything between "features are cut" and "final waveform" — envelope
effects, loop/velocity plan materialization, formant strength bells, the
pitch curve, pitch-driven dynamics, vocal fry, the main synthesis plus the
su/sj/sa layers, fry highpass blending, dryness, tension and the V/B/U
mix — traces into ONE jitted XLA program (the BASELINE.json north star:
"all flags compiled into one jit-traced render graph").

Parameter split follows the engine's convention:

* ``RenderStatic`` — hashable: shapes (cut/loop/velocity plan lengths are
  part of the array shapes), branch toggles, and the few values that pick
  kernel sizes or loop structure (env-shape amount, tension order/sign).
* ``scalars`` — traced f32 leaves (mix levels, shift ratios, strengths…):
  changing them re-uses the compiled graph, and vmapping over them batches
  whole notes.

One dispatch per note; ``jax.vmap`` over the array/scalar arguments gives
the phrase renderer its bucket batching.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from goofer_tpu import config
from goofer_tpu.engine.synth import SynthStatic, default_knobs, synth_core_impl
from goofer_tpu.ops.envelope import (
    env_shape,
    env_shape_traced,
    fry_env_shift,
)
from goofer_tpu.ops.filters import gaussian_blur1d
from goofer_tpu.ops.interp import gather_lerp
from goofer_tpu.ops.jitter import volume_jitter
from goofer_tpu.ops.scan_iir import dynamic_butter_filter


@dataclass(frozen=True)
class RenderStatic:
    """Compile-time configuration of the fused note render."""
    sr: int
    n_fft: int
    hop: int
    n: int                       # output samples (post-velocity)
    t_env: int                   # envelope frames (post-velocity)
    # envelope effects (pre-loop)
    tilt_on: bool = False
    shape_amt: float = 0.0       # es value; picks blur kernel sizes
    fw_on: bool = False
    # feature assembly
    vel_on: bool = False
    strengths_on: bool = False
    # pitch / dynamics / fry
    pd_on: bool = False
    fry_on: bool = False
    # main synth toggles
    f0_jitter: bool = False
    volume_jitter: bool = False
    add_subharm: bool = False
    warp_formants: bool = False
    # host-derived bound (bins) on the formant warp's offset; 0 keeps
    # the unbounded gather (ops/envelope.banded_gather_lerp_columns)
    warp_band: int = 0
    formant_shift_on: bool = False
    # layers / post-fx
    su_on: bool = False
    sj_on: bool = False
    sd_on: bool = False
    tension_sign: int = 0        # -1 / 0 / +1
    tension_order: int = 4       # LP order for tension < 0 (host-derived)
    sa_on: bool = False
    # pulse-overlap bounds, host-derived from the note's possible f0 range
    # (K ~= ceil(0.804 * f0_max / f0_min) + 2): the pulse kernel sums the
    # last K pulse generations per sample, so K follows pitch range
    # instead of paying the worst case everywhere
    max_overlap: int = config.PULSE_MAX_OVERLAP
    growl_max_overlap: int = config.PULSE_MAX_OVERLAP
    # assumed minimum pulse-onset spacing, host-derived from the pitch
    # curve's f0 ceiling (the growl layer's f0 spread gets its own);
    # sizes the pulse kernel's compact tables — see ops/pulse.py
    min_spacing: int = config.PULSE_MIN_SPACING
    growl_min_spacing: int = config.PULSE_MIN_SPACING
    subharm_min_spacing: int = 8
    # su layer runs at f0/2: onsets are 2x sparser, so its pulse-kernel
    # tables can be half the rows of the main layer's
    su_min_spacing: int = config.PULSE_MIN_SPACING
    # pre-velocity sample count (the loop-materialized length the
    # velocity warp reads; == n when vel_on is False).  Static so the
    # on-device loop-position closed form has a fixed shape.
    n_loop: int = 0
    # bucketed geometry: n / t_env are padded buckets; the true note
    # length arrives as the traced scalar ``n_true`` and padding is
    # masked out of every normalization and the final output
    masked: bool = False
    # Universal fallback graph (VERDICT r2 item 2): every branch toggle
    # is ON and the remaining compile-time values (env-shape amount,
    # tension sign/order) move into the traced scalars, so ONE compiled
    # graph per geometry bucket renders ANY flag combination — unused
    # features are exactly neutral at their default scalar values
    # (strength 0 / ratio 1 / identity positions).  Used to bound
    # time-to-first-note while the specialized graph compiles in the
    # background (resampler.render_note_auto).
    universal: bool = False


def default_scalars() -> dict:
    return {
        "brightness_env": 1.0,
        "fw_amount": 0.0,
        "formant_shift": 1.0,
        "formant_band_shifts": np.ones(4, dtype=np.float32),
        "formant_strengths": np.zeros(4, dtype=np.float32),
        "f0_jitter_strength": 0.0,
        "volume_jitter_strength": 0.0,
        "subharm_weight": 0.0,
        "normalize": 1.0,
        "pitch_dyn": 0.0,
        "pd_baseline": 0.0,
        "pd_ref": 1.0,
        "tick_dt_samp": 1.0,
        "n_ticks": 1.0,
        "n_true": 0.0,
        "fry_vh": 50.0,
        "subharm_gain": 0.0,
        "growl_mix": 0.0,
        "sd_strength": 0.0,
        "tension": 0.0,
        "harmonic_mix": 1.0,
        "breathiness_mix": 1.0,
        "unvoiced_mix": 1.0,
        "volume": 1.0,
        "aperiodic_mix": 0.0,
        # engine noise-strength knobs (ref synthesize defaults,
        # GOOFER.py:975).  Exposed as traced scalars so tests can zero
        # the noise stems and compare the deterministic chain against
        # the NumPy reference oracle to float accuracy (o_resample).
        "uv_strength": 0.75,
        "breath_strength": 0.1,
        # loop/velocity geometry: the f0/mask sample positions are
        # closed-form (identity prefix + tail tiling; velocity's
        # two-slope warp), so the device rebuilds them from these
        # scalars instead of shipping b x n position arrays host to
        # device
        "loop_pre": 0.0,
        "loop_tail": 1.0,
        "vel_pre_new": 1.0,
        "vel_pre_len": 1.0,
        "vel_factor": 1.0,
        # fry curve bounds/slopes (resampler._fry_scalars); the
        # weight/mask ramps are materialized on device (fry_curves)
        "fry_c0": 0.0, "fry_c1": 0.0, "fry_g0": 0.0, "fry_g1": 0.0,
        "fry_r0": 0.0, "fry_rs": 0.0, "fry_s": 0.0, "fry_e": 0.0,
        "fry_a1": 0.0, "fry_rin": 0.0, "fry_b0": 0.0, "fry_rout": 0.0,
        # universal graph only: env-shape amount (es flag), a static
        # kernel-size picker on the specialized path (RenderStatic
        # .shape_amt) but traced through env_shape_traced here
        "env_shape": 0.0,
    }


FORMANT_BELL_SIGMAS = (100.0, 200.0, 350.0, 500.0)


def _strength_gain(n_bins, tracks, strengths, sr):
    """Traced-strength variant of the formant bells
    (ref: SillySampler.py:791-833); zero strength is exactly unity gain."""
    freqs = jnp.linspace(0.0, sr / 2.0, n_bins, dtype=jnp.float32)
    gain = jnp.ones((n_bins, tracks.shape[1]), dtype=jnp.float32)
    for k in range(4):
        fk = tracks[k]
        ok = jnp.isfinite(fk) & (fk > 50.0) & (fk < sr * 0.5)
        w = jnp.exp(-0.5 * ((freqs[:, None] - fk[None, :])
                            / FORMANT_BELL_SIGMAS[k]) ** 2)
        gain = gain * (1.0 + strengths[k] * w * ok[None, :])
    return gain


def _tilt(env, brightness_env, sr):
    """Traced-alpha brightness tilt (ref: SillySampler.py:503-515)."""
    n_bins = env.shape[0]
    freqs = np.linspace(1e-6, sr * 0.5, n_bins, dtype=np.float32)
    norm_f = jnp.asarray(np.clip(freqs / (sr * 0.5), 0.02, 1.0))
    alpha = jnp.clip(brightness_env - 1.0, -0.9, 1.0)
    tilt = norm_f ** alpha
    tilt = tilt / (jnp.mean(tilt) + 1e-12)
    return env * tilt[:, None]


def _fw_warp(env, amount):
    """Traced-amount formant width warp (ref: SillySampler.py:554-574).

    The warp positions depend only on the bin, never the frame, so this
    is a SHARED row gather (the shift_formants_global formulation) —
    not a per-(bin, frame) column gather; both clamp identically
    (tests/test_ops.py)."""
    n_bins = env.shape[0]
    bins = jnp.arange(n_bins, dtype=jnp.float32)
    center = n_bins / 2.0
    pos = jnp.clip((bins - center) * (1.0 + amount) + center,
                   0.0, n_bins - 1.0)
    return gather_lerp(env, pos, axis=0)


def _apply_plan(src, pos0, pos1, w, axis=-1):
    a = gather_lerp(src, pos0, axis=axis)
    b = gather_lerp(src, pos1, axis=axis)
    if src.ndim == 2 and axis in (1, -1):
        w = w[None, :]
    return a * (1.0 - w) + b * w


def loop_positions(rs: RenderStatic, scalars) -> jnp.ndarray:
    """Integer sample positions of the sustain loop, rebuilt on device
    from two scalars (identity prefix + tail tiling, exactly
    plan.plan_sample_loop / ref SillySampler.py:698-712).  Shipping
    these as arrays cost b x n x 4 bytes of h2d per dispatch."""
    n_loop = rs.n_loop or rs.n
    j = jnp.arange(n_loop, dtype=jnp.int32)
    pre = jnp.round(scalars["loop_pre"]).astype(jnp.int32)
    tail = jnp.maximum(jnp.round(scalars["loop_tail"]).astype(jnp.int32),
                       1)
    return jnp.where(j < pre, j, pre + jax.lax.rem(j - pre, tail))


def velocity_positions(rs: RenderStatic, scalars) -> jnp.ndarray:
    """Fractional source positions of the consonant-velocity warp
    (plan.plan_prefix_stretch / ref SillySampler.py:176-187):
    pos = i/factor below pre_new, (i - pre_new) + pre_len above."""
    i = jnp.arange(rs.n, dtype=jnp.float32)
    pre_new = scalars["vel_pre_new"]
    return jnp.where(i < pre_new, i / scalars["vel_factor"],
                     (i - pre_new) + scalars["vel_pre_len"])


def _fry_mask_at(sc, pos):
    """Evaluate the faded fry-region mask at (float) sample positions
    (ref: SillySampler.py:937-965; bounds from resampler._fry_scalars)."""
    inside = ((pos >= sc["fry_s"]) & (pos < sc["fry_e"])
              ).astype(jnp.float32)
    ramp_in = jnp.where(pos < sc["fry_a1"],
                        (pos - sc["fry_s"]) * sc["fry_rin"], 1.0)
    ramp_out = jnp.where(pos >= sc["fry_b0"],
                         1.0 - (pos - sc["fry_b0"]) * sc["fry_rout"], 1.0)
    return inside * ramp_in * ramp_out


def fry_curves(rs: RenderStatic, sc):
    """Materialize the fry base-pitch weight, region mask and per-frame
    weight from the 12 host-derived scalars (the reference builds these
    as n-length arrays, SillySampler.py:883-996 — shipping them cost
    2 x n x 4 bytes per note of h2d)."""
    j = jnp.arange(rs.n, dtype=jnp.float32)
    base_w = (((j >= sc["fry_c0"]) & (j < sc["fry_c1"])
               ).astype(jnp.float32)
              + jnp.where((j >= sc["fry_g0"]) & (j < sc["fry_g1"]),
                          sc["fry_r0"] + sc["fry_rs"] * (j - sc["fry_g0"]),
                          0.0))
    fry_mask = _fry_mask_at(sc, j)
    centers = jnp.clip(
        jnp.arange(rs.t_env, dtype=jnp.float32) * rs.hop + rs.hop // 2,
        0.0, jnp.maximum(sc["n_true"], 1.0) - 1.0)
    fry_frame_w = _fry_mask_at(sc, centers)
    return base_w, fry_mask, fry_frame_w


def assemble_f0_mask(rs: RenderStatic, f0_cut, mask_cut,
                     fry_base_w, pitch_ticks, scalars):
    """The f0/voicing half of the render front: tick-curve interpolation,
    loop/velocity resampling (positions rebuilt on device from scalars),
    Hz conversion gated by voicing, fry override
    (ref: SillySampler.py:835-855, 883-935).  Factored out so tests can
    fetch the EXACT per-sample f0 the pulse kernel will integrate (pulse
    onset positions are decided at f32-quantization scale, so a host
    restatement is not bit-faithful).  Returns (midi_curve, f0_new,
    mask_new)."""
    sc = scalars
    n = rs.n
    tick_pos = jnp.clip(
        jnp.arange(n, dtype=jnp.float32) / sc["tick_dt_samp"],
        0.0, sc["n_ticks"] - 1.0)
    midi_curve = gather_lerp(pitch_ticks.astype(jnp.float32), tick_pos,
                             axis=0)
    lp = jnp.clip(loop_positions(rs, sc), 0,
                  max(int(f0_cut.shape[0]) - 1, 0))
    f0_new = jnp.take(f0_cut.astype(jnp.float32), lp, axis=0)
    mask_new = jnp.take(mask_cut.astype(jnp.float32), lp, axis=0)
    if rs.vel_on:
        vpos = velocity_positions(rs, sc)
        f0_new = gather_lerp(f0_new, vpos, axis=0)
        mask_new = gather_lerp(mask_new, vpos, axis=0)

    # pitch curve -> Hz, gated by voicing (ref: SillySampler.py:848-855)
    hz_curve = 440.0 * 2.0 ** ((midi_curve - 69.0) / 12.0)
    f0_new = mask_new * hz_curve

    if rs.fry_on:
        fry_base = sc["fry_vh"] * (mask_new > 0).astype(jnp.float32)
        f0_new = (1.0 - fry_base_w) * f0_new + fry_base_w * fry_base
    return midi_curve, f0_new, mask_new


def render_note_core(rs: RenderStatic,
                     env_cut, f0_cut, mask_cut,
                     env_pos0, env_pos1, env_w,
                     vel_env_pos,
                     tracks, tracks_raw, pitch_ticks,
                     scalars, key):
    """One fused note render; see module docstring.  All array args are
    device arrays shaped per RenderStatic; returns the final waveform.

    ``tracks`` are the sanitized+smoothed F1..F4 tracks (formant-strength
    bells, ref SillySampler.py:802-806); ``tracks_raw`` the warp-anchor
    tracks the per-band envelope warps read.  Upstream's
    sanitize_smooth_formant aliases the canon'd float32 tracks, so its
    gap-fill writes back into the ``formants_new`` dict gf.synthesize
    warps by (SillySampler.py:264-283 via 802-805, 1015): invalid frames
    arrive FILLED (interp/extrapolated, unsmoothed) unless velocity
    changed the frame count or the track had no valid frame at all —
    the host builds exactly that variant (resampler.build_tracks;
    certified by tests/test_ref_upstream.py).

    ``pitch_ticks`` is the UTAU tick-rate pitch curve in MIDI semitones
    (edge-padded; true tick count in ``scalars["n_ticks"]``); the
    per-sample curve is interpolated on device — shipping it per-sample
    costs ~100 kB/note of host->device bandwidth for redundant data."""
    sr, n_fft, hop, n = rs.sr, rs.n_fft, rs.hop, rs.n
    sc = scalars
    k_main, k_su, k_sj, k_sa, k_sd, k_noise = jax.random.split(key, 6)

    fry_base_w = fry_mask = fry_frame_w = None
    if rs.fry_on:
        fry_base_w, fry_mask, fry_frame_w = fry_curves(rs, sc)

    # f0/voicing half (tick curve, loop/velocity resampling, Hz gate,
    # fry override) — per-sample positions rebuilt on device
    midi_curve, f0_new, mask_new = assemble_f0_mask(
        rs, f0_cut, mask_cut, fry_base_w, pitch_ticks, sc)

    env = env_cut.astype(jnp.float32)
    if rs.tilt_on:
        env = _tilt(env, sc["brightness_env"], sr)
    if rs.universal:
        env = env_shape_traced(env, sc["env_shape"])
    elif rs.shape_amt != 0.0:
        env = env_shape(env, rs.shape_amt)
    if rs.fw_on:
        env = _fw_warp(env, sc["fw_amount"])

    env_new = _apply_plan(env, env_pos0, env_pos1, env_w, axis=-1)
    if rs.vel_on:
        env_new = gather_lerp(env_new, vel_env_pos, axis=-1)

    if rs.strengths_on:
        env_new = env_new * _strength_gain(env_new.shape[0], tracks,
                                           sc["formant_strengths"], sr)

    # pd: pitch-driven dynamics (ref: SillySampler.py:857-881).  The
    # bend curve is blurred ON DEVICE from the midi curve (the blur is
    # an FFT conv); only its 95th-percentile scale (``pd_ref``) comes
    # from the host, sparing the graph an on-device sort
    # (jnp.percentile).
    dyn_gain = None
    if rs.pd_on:
        pd_bend = gaussian_blur1d(midi_curve - sc["pd_baseline"],
                                  float(max(1, int(0.010 * sr))))
        v = jnp.clip(pd_bend / sc["pd_ref"], -1.0, 1.0)
        signed = jnp.where(sc["pitch_dyn"] > 0, v, -v)
        gain_db = 12.0 * jnp.abs(sc["pitch_dyn"]) * signed
        dyn_gain = jnp.clip(10.0 ** (gain_db / 20.0), 1e-3, 1e3)
        vmask_s = gaussian_blur1d(mask_new, float(int(0.01 * sr)))
        dyn_gain = 1.0 + (dyn_gain - 1.0) * vmask_s

    # vocal fry envelope shift (f0 override already applied in
    # assemble_f0_mask; ref: SillySampler.py:883-996)
    if rs.fry_on:
        env_new = fry_env_shift(env_new, fry_frame_w, 0.92)

    # ---- main synthesis ----------------------------------------------
    st_main = SynthStatic(
        sr=sr, n_fft=n_fft, hop=hop, n=n,
        f0_jitter=rs.f0_jitter,
        volume_jitter=rs.volume_jitter,
        add_subharm=rs.add_subharm,
        subharm_semitones=(12.0,),
        subharm_vibrato=True,
        subharm_vibrato_delay=0.01,
        cut_subharm_below_f0=True,
        warp_formants=rs.warp_formants,
        warp_band=rs.warp_band,
        formant_shift_on=rs.formant_shift_on,
        max_overlap=rs.max_overlap,
        pulse_min_spacing=rs.min_spacing,
        subharm_min_spacing=rs.subharm_min_spacing,
        masked=rs.masked,
    )
    knobs = default_knobs()
    knobs.update({
        "uv_strength": sc["uv_strength"],
        "breath_strength": sc["breath_strength"],
        "formant_shift": sc["formant_shift"],
        "formant_band_shifts": sc["formant_band_shifts"],
        "f0_jitter_strength": sc["f0_jitter_strength"],
        "volume_jitter_strength_harm": sc["volume_jitter_strength"],
        "volume_jitter_strength_breath": sc["volume_jitter_strength"] * 2,
        "subharm_weight": sc["subharm_weight"],
        "subharm_vibrato_rate": 75.0,
        "subharm_vibrato_depth": 3.0,
        "normalize": sc["normalize"],
    })
    if rs.masked:
        knobs["n_true"] = sc["n_true"]
    knobs = {k: jnp.asarray(v, dtype=jnp.float32) for k, v in knobs.items()}
    _, harmonic, aper_uv, aper_bre = synth_core_impl(
        st_main, env_new, f0_new, mask_new, tracks_raw, knobs, k_main)

    st_layer = SynthStatic(
        sr=sr, n_fft=n_fft, hop=hop, n=n,
        warp_formants=rs.warp_formants,
        warp_band=rs.warp_band,
        formant_shift_on=rs.formant_shift_on,
        max_overlap=rs.max_overlap,
        pulse_min_spacing=rs.su_min_spacing,   # su runs at f0/2
        masked=rs.masked,
        # only harm_sub is consumed (SillySampler.py:1040-1059): skip
        # the layer's aperiodic branch (see SynthStatic.need_noise)
        need_noise=False,
    )
    layer_knobs = dict(knobs)
    for k in ("f0_jitter_strength", "volume_jitter_strength_harm",
              "volume_jitter_strength_breath", "subharm_weight"):
        layer_knobs[k] = jnp.float32(default_knobs()[k])

    # su: sub-octave layer (ref: SillySampler.py:1037-1059)
    if rs.su_on:
        _, harm_sub, _, _ = synth_core_impl(
            st_layer, env_new, f0_new * 0.5, mask_new, tracks_raw,
            layer_knobs, k_su)
        f0_hp = jnp.maximum(f0_new, 120.0)
        for _ in range(2):
            harm_sub = dynamic_butter_filter(harm_sub, f0_hp, sr, 1.0,
                                             order=6, btype="highpass")
        harmonic = harmonic + harm_sub * sc["subharm_gain"]

    # sj: growl layer (ref: SillySampler.py:1061-1081)
    if rs.sj_on:
        noise = sc["growl_mix"] ** 2 * jax.random.normal(
            k_noise, (n,), dtype=jnp.float32)
        st_growl = SynthStatic(
            sr=sr, n_fft=n_fft, hop=hop, n=n,
            warp_formants=rs.warp_formants,
            warp_band=rs.warp_band,
            formant_shift_on=rs.formant_shift_on,
            max_overlap=rs.growl_max_overlap,
            pulse_min_spacing=rs.growl_min_spacing,
            masked=rs.masked,
            # only harm_gw is consumed (SillySampler.py:1061-1081)
            need_noise=False,
        )
        _, harm_gw, _, _ = synth_core_impl(
            st_growl, env_new, f0_new * (0.5 * 2.0 ** noise), mask_new,
            tracks_raw, layer_knobs, k_sj)
        f0_hp = jnp.maximum(f0_new, 120.0)
        for _ in range(2):
            harm_gw = dynamic_butter_filter(harm_gw, f0_hp, sr, 1.0,
                                            order=6, btype="highpass")
        harmonic = (1.0 - sc["growl_mix"]) * harmonic \
            + sc["growl_mix"] * harm_gw

    # fry: highpass blend under the fry mask (ref: SillySampler.py:1083-1099)
    if rs.fry_on:
        ones = jnp.ones_like(f0_new)
        harm_hp = dynamic_butter_filter(harmonic, ones, sr, 200.0,
                                        order=6, btype="highpass")
        bre_hp = dynamic_butter_filter(aper_bre, ones, sr, 200.0,
                                       order=6, btype="highpass")
        harmonic = harmonic * (1.0 - fry_mask) + harm_hp * fry_mask
        aper_bre = aper_bre * (1.0 - fry_mask) + bre_hp * fry_mask

    # sd: dryness (ref: SillySampler.py:1101-1112)
    if rs.sd_on:
        breath_j = volume_jitter(k_sd, n, sr, speed=150.0,
                                 strength=sc["sd_strength"] / 200.0,
                                 vibrato=True)
        vmask_smooth = gaussian_blur1d(mask_new, 20.0)
        aper_bre = aper_bre * (1.0 + (breath_j - 1.0) * vmask_smooth)
        aper_bre = aper_bre * (1.0 + (sc["sd_strength"] / 100.0) * 10)

    # st: tension (ref: SillySampler.py:1114-1140).  Universal graph:
    # both signed branches run and the traced sign/order select — the
    # host's order derivation round(1 + |t|*4) is recomputed in-graph
    # (numpy and jnp both round half-even) and tension == 0 selects the
    # untouched pair, making the whole block exactly neutral.
    if rs.tension_sign != 0 or rs.universal:
        rms_before = jnp.sqrt(jnp.mean((harmonic + aper_bre) ** 2) + 1e-12)
        abs_ten = jnp.abs(sc["tension"])
        if rs.universal:
            order_t = jnp.clip(jnp.round(1.0 + abs_ten * 4.0), 1.0, 6.0)
            h_neg = dynamic_butter_filter(
                harmonic, f0_new, sr, 2.0 - abs_ten * 0.75,
                order=6, btype="lowpass", n_active=order_t)
            b_neg = dynamic_butter_filter(
                aper_bre, f0_new, sr, abs_ten, order=4, btype="highpass")
            highpassed = dynamic_butter_filter(
                harmonic, f0_new, sr, abs_ten * 4, order=4,
                btype="highpass")
            h_pos = harmonic + highpassed * (1.0 + abs_ten * 20.0)
            b_pos = dynamic_butter_filter(
                aper_bre, f0_new, sr, (2.0 - abs_ten) / 0.5, order=6,
                btype="lowpass") * (1.0 - abs_ten)
            ten = sc["tension"]
            harmonic = jnp.where(ten < 0.0, h_neg,
                                 jnp.where(ten > 0.0, h_pos, harmonic))
            aper_bre = jnp.where(ten < 0.0, b_neg,
                                 jnp.where(ten > 0.0, b_pos, aper_bre))
        elif rs.tension_sign < 0:
            harmonic = dynamic_butter_filter(
                harmonic, f0_new, sr, 2.0 - abs_ten * 0.75,
                order=rs.tension_order, btype="lowpass")
            aper_bre = dynamic_butter_filter(
                aper_bre, f0_new, sr, abs_ten, order=4, btype="highpass")
        else:
            highpassed = dynamic_butter_filter(
                harmonic, f0_new, sr, abs_ten * 4, order=4,
                btype="highpass")
            harmonic = harmonic + highpassed * (1.0 + abs_ten * 20.0)
            aper_bre = dynamic_butter_filter(
                aper_bre, f0_new, sr, (2.0 - abs_ten) / 0.5, order=6,
                btype="lowpass")
            aper_bre = aper_bre * (1.0 - abs_ten)
        rms_after = jnp.sqrt(jnp.mean((harmonic + aper_bre) ** 2) + 1e-12)
        gain = jnp.where(rms_after > 0, rms_before / rms_after, 1.0)
        harmonic = harmonic * gain
        aper_bre = aper_bre * gain

    out = (harmonic * sc["harmonic_mix"] + aper_bre * sc["breathiness_mix"]
           + aper_uv * sc["unvoiced_mix"]) * sc["volume"]

    # sa: uncorrelated aperiodic blend (ref: SillySampler.py:1153-1172)
    if rs.sa_on:
        st_ap = SynthStatic(
            sr=sr, n_fft=n_fft, hop=hop, n=n,
            warp_formants=rs.warp_formants,
            warp_band=rs.warp_band,
            formant_shift_on=rs.formant_shift_on,
            noise_transition_smoothness=1.0,
            max_overlap=rs.max_overlap,
            pulse_min_spacing=rs.min_spacing,
            masked=rs.masked,
            # all-ones mask ⇒ the uv stem is gated to zero upstream
            # (GOOFER.py:1179-1183); skip its iSTFT (SynthStatic.need_uv)
            need_uv=False,
        )
        ap_knobs = dict(layer_knobs)
        ap_knobs["uv_strength"] = jnp.float32(1.0)
        ap_knobs["breath_strength"] = jnp.float32(1.0)
        _, _, uv_u, bre_u = synth_core_impl(
            st_ap, env_new, f0_new, jnp.ones_like(mask_new), tracks_raw,
            ap_knobs, k_sa)
        mix = sc["aperiodic_mix"]
        out = out * (1.0 - mix) + (uv_u + bre_u) * sc["volume"] * mix

    if rs.pd_on:
        out = out * dyn_gain

    if rs.masked:
        out = out * (jnp.arange(n, dtype=jnp.float32)
                     < sc["n_true"]).astype(jnp.float32)

    return out


# per-RenderStatic AOT-wrapped dispatches (utils/aot.py): fresh
# processes deserialize the exported StableHLO instead of re-tracing
# the note graph.  Bounded by the same budget sweep as the executables.
_note_fn_cache: dict = {}
_note_fn_lock = threading.Lock()


def _note_fn(rs: RenderStatic):
    with _note_fn_lock:
        fn = _note_fn_cache.get(rs)
    if fn is None:
        from goofer_tpu.utils import aot

        fn = aot.wrap("note", repr(rs),
                      jax.jit(partial(render_note_core, rs)))
        with _note_fn_lock:
            fn = _note_fn_cache.setdefault(rs, fn)
    return fn


def clear_compiled_render_graphs() -> None:
    """Drop every compiled single-note executable (specialized AND
    universal) pinned by the jit wrappers.  Used by the server's
    graph-budget sweep (resampler._sweep_graph_budget): jax keeps one
    executable per (static, shapes) signature with no eviction of its
    own, so a long session's working set is bounded by periodically
    clearing and re-warming the universal ladder."""
    with _note_fn_lock:
        _note_fn_cache.clear()


# ---------------------------------------------------------------------------
# Universal fallback graph (VERDICT r2 item 2: bounded time-to-first-note).
# One compiled graph per geometry bucket renders ANY flag combination;
# disabled features are exactly neutral at their default scalar values.
# Conservative static pulse bounds below cover f0 ceilings to ~2.75 kHz
# (beyond any vocal range the YAML expressions can reach); notes whose
# host-derived bounds exceed them return None and take the specialized
# path.  growl/subharm spacings sit at the bucket floor (8), which covers
# every reachable spread.

_UNIVERSAL_MIN_SPACING = 16
_UNIVERSAL_FLOOR_SPACING = 8


def universal_static(rs: RenderStatic) -> RenderStatic | None:
    """The all-features-on variant of a bucketed RenderStatic (see
    RenderStatic.universal).  None when the note's pulse bounds exceed
    the universal graph's coverage."""
    from dataclasses import replace

    if not rs.masked:
        raise ValueError("universal graphs require bucketed geometry")
    if (rs.min_spacing < _UNIVERSAL_MIN_SPACING
            or rs.su_min_spacing < _UNIVERSAL_MIN_SPACING):
        return None
    return replace(
        rs, universal=True, tilt_on=True, shape_amt=0.0, fw_on=True,
        vel_on=True, strengths_on=True, pd_on=True, fry_on=True,
        f0_jitter=True, volume_jitter=True, add_subharm=True,
        warp_formants=True, warp_band=0, formant_shift_on=True,
        su_on=True, sj_on=True, sd_on=True, tension_sign=0,
        tension_order=6, sa_on=True,
        max_overlap=config.PULSE_OVERLAP_BUCKETS[-1],
        growl_max_overlap=config.PULSE_OVERLAP_BUCKETS[-1],
        min_spacing=_UNIVERSAL_MIN_SPACING,
        growl_min_spacing=_UNIVERSAL_FLOOR_SPACING,
        su_min_spacing=_UNIVERSAL_MIN_SPACING,
        subharm_min_spacing=_UNIVERSAL_FLOOR_SPACING)


def universalize_inputs(rs: RenderStatic, arrays: dict, scalars: dict,
                        p) -> tuple[dict, dict]:
    """Adapt a note's (bucketed) arrays/scalars for the universal graph.

    The scalar dict already carries exactly-neutral values for disabled
    features (strength 0 / ratio 1 / zero fry bounds) EXCEPT the three
    knobs whose flag decode can leave a nonzero value behind a False
    toggle (negative sh/sr/sg, sampler/flags.py:142-155) — those gate on
    the bool here.  Non-velocity notes get identity warp positions."""
    a, s = dict(arrays), dict(scalars)
    if not p.f0_jitter:
        s["f0_jitter_strength"] = 0.0
    if not p.volume_jitter:
        s["volume_jitter_strength"] = 0.0
    if not p.add_subharm:
        s["subharm_weight"] = 0.0
    if not rs.vel_on:
        # identity consonant-velocity: env warp positions are the frame
        # index, sample warp is the closed form at factor 1 (the
        # vel_* scalar defaults) — velocity_positions(i) == i exactly
        a["vel_env_pos"] = np.arange(rs.t_env, dtype=np.float32)
    return a, s


def render_note(rs: RenderStatic, arrays: dict, scalars: dict, key):
    """Jitted single-note dispatch.  ``arrays`` carries the device inputs
    keyed like render_note_core's signature."""
    full = default_scalars()
    full.update(scalars)
    sc = {k: jnp.asarray(v, dtype=jnp.float32) for k, v in full.items()}
    return _note_fn(rs)(
        arrays["env_cut"], arrays["f0_cut"], arrays["mask_cut"],
        arrays["env_pos0"], arrays["env_pos1"], arrays["env_w"],
        arrays["vel_env_pos"],
        arrays["tracks"], arrays["tracks_raw"], arrays["pitch_ticks"],
        sc, key)
