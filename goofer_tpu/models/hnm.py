"""Harmonic-plus-noise voice model: GOOFER-compatible library facade.

This is the flagship "model" of the framework: analysis + resynthesis of a
singing voice as a harmonic/noise decomposition.  The function surface
mirrors the reference engine module (``extract_features``/``synthesize``
with the same kwargs, ref: GOOFER.py:940-1220) so reference users can port
call sites unchanged, while everything underneath dispatches to the jitted
graph.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from goofer_tpu import config as config_mod

from goofer_tpu.engine.synth import SynthStatic, synthesize as _synth
from goofer_tpu.io.goofy import formants_to_int_keys, pad_trim_to_len
from goofer_tpu.ops.envelope import decode_env_from_knots
from goofer_tpu.ops.filters import gaussian_blur1d
from goofer_tpu.ops.interp import resample_1d, resample_2d

from goofer_tpu.analysis.features import extract_features  # noqa: F401


_stack4 = jax.jit(lambda a, b, c, d: jnp.stack([a, b, c, d]))


def _stretch_all(env, env4b_placeholder, f0, mask, stretch, start_sec,
                 end_sec, sr, hop):
    """Whole-signal or span time stretch of features
    (ref: GOOFER.py:1019-1067).  env4breath is recomputed downstream from
    the stretched envelope by the engine, matching a blur/stretch
    commutation (both are linear; LSD impact nil)."""
    if start_sec is not None and end_sec is not None:
        s = int(start_sec * sr)
        e = int(end_sec * sr)
        seg_len = int((e - s) * stretch)
        f0 = jnp.concatenate([
            f0[:s], resample_1d(f0[s:e], seg_len), f0[e:]])
        mask = jnp.concatenate([
            mask[:s], resample_1d(mask[s:e], seg_len), mask[e:]])
        sf = int((start_sec * sr) / hop)
        ef = int((end_sec * sr) / hop)
        seg_frames = int((ef - sf) * stretch)
        env = jnp.concatenate([
            env[:, :sf], resample_2d(env[:, sf:ef], seg_frames),
            env[:, ef:]], axis=1)
    else:
        f0 = resample_1d(f0, int(f0.shape[0] * stretch))
        mask = resample_1d(mask, int(mask.shape[0] * stretch))
        env = resample_2d(env, int(env.shape[1] * stretch))
    return env, f0, mask


def synthesize(env_spec, f0_interp, voicing_mask, y, sr,
               n_fft=1024, hop_length=256, glottal_smoothing=False,
               stretch_factor=1.0, start_sec=None, end_sec=None,
               apply_brightness=True, normalize=1.0,
               uv_strength=0.75, breath_strength=0.1,
               noise_transition_smoothness=100,
               pitch_shift=1.0, formant_shift=1.0,
               f0_jitter=False, f0_jitter_speed=100,
               f0_jitter_strength=1.5,
               volume_jitter=False, volume_vibrato=False,
               volume_jitter_speed=150, volume_jitter_strength_harm=50,
               volume_jitter_strength_breath=100,
               add_subharm=False, subharm_semitones=-12,
               subharm_weight=0.5, subharm_vibrato=False,
               cut_subharm_below_f0=True, subharm_vibrato_rate=6.0,
               subharm_vibrato_depth=0.1, subharm_f0_jitter=0,
               subharm_vibrato_delay=0.1,
               F1_shift=1.0, F2_shift=1.0, F3_shift=1.0, F4_shift=1.0,
               formants=None,
               roughness_on=False, rough_k_list=(2, 3, 4),
               rough_h_list=None, rough_alpha=0.6, rough_hp_fc=320.0,
               rough_noise_amp=0.6, rough_noise_smooth_ms=120.0,
               rough_alpha_slew_ms=120.0,
               seed=0):
    """Drop-in equivalent of the reference synthesize
    (ref: GOOFER.py:971-1220).  ``y`` contributes only its length.
    Returns numpy (reconstruct, harmonic, aper_uv, aper_bre)."""
    if isinstance(env_spec, dict) and env_spec.get("mode") == "knots":
        env_spec = decode_env_from_knots(
            jnp.asarray(env_spec["knot_vals_log"], dtype=jnp.float32),
            env_spec["sr"], env_spec["n_fft"], env_spec["n_bins"])
    env = jnp.asarray(np.asarray(env_spec), dtype=jnp.float32)
    f0 = jnp.asarray(np.asarray(f0_interp), dtype=jnp.float32)
    mask = jnp.asarray(np.asarray(voicing_mask), dtype=jnp.float32)

    n_frames = env.shape[1]
    forms = formants_to_int_keys(formants)
    tracks = np.stack([pad_trim_to_len(forms[i], n_frames)
                       for i in (1, 2, 3, 4)]).astype(np.float32)

    if stretch_factor != 1.0:
        env, f0, mask = _stretch_all(env, None, f0, mask, stretch_factor,
                                     start_sec, end_sec, sr, hop_length)
    out_len = int(f0.shape[0])

    if not isinstance(subharm_semitones, (list, tuple, np.ndarray)):
        subharm_semitones = (float(subharm_semitones),)

    # pulse-overlap bound from the actual f0 data (pulses are zero past
    # u ~= Ra + Rk*(1-Ra) = 0.804 of their period)
    f0_host = np.asarray(f0_interp, dtype=np.float64) * float(pitch_shift)
    pos = f0_host[f0_host > 1e-6]
    if pos.size:
        jit_hi = 1.0 + (f0_jitter_strength if f0_jitter else 0.0)
        jit_lo = max(0.25, 1.0 - (f0_jitter_strength if f0_jitter else 0.0))
        f0_ceil = max(pos.max() * jit_hi, 160.0)
        ratio = f0_ceil / max(1.0, min(pos.min() * jit_lo, 160.0))
    else:
        f0_ceil, ratio = 160.0, 1.0
    max_overlap = config_mod.bucket_overlap(
        int(np.clip(np.ceil(0.804 * ratio) + 2, 3, 32)))
    # onset-spacing floor from the same ceiling (sizes the pulse tables);
    # the subharmonic layer runs ratio x (1 + vibrato depth) x
    # (1 + jitter) denser — all host-known here
    min_spacing = config_mod.bucket_min_spacing(
        int(sr / max(f0_ceil, 1.0)))
    if add_subharm:
        sub_ratio = max(2.0 ** (float(s_) / 12.0)
                        for s_ in subharm_semitones)
        sub_ceil = f0_ceil * max(sub_ratio, 1e-6)
        if subharm_vibrato:
            sub_ceil *= 1.0 + abs(float(subharm_vibrato_depth))
        if float(subharm_f0_jitter) > 0.0:
            sub_ceil *= 1.0 + abs(float(subharm_f0_jitter))
        subharm_min_spacing = config_mod.bucket_min_spacing(
            int(sr / max(sub_ceil, 1.0)))
    else:
        subharm_min_spacing = 8

    st = SynthStatic(
        sr=int(sr), n_fft=n_fft, hop=hop_length, n=out_len,
        f0_jitter=bool(f0_jitter),
        f0_jitter_speed=float(f0_jitter_speed),
        volume_jitter=bool(volume_jitter),
        volume_vibrato=bool(volume_vibrato),
        volume_jitter_speed=float(volume_jitter_speed),
        add_subharm=bool(add_subharm),
        subharm_semitones=tuple(float(s) for s in subharm_semitones),
        subharm_vibrato=bool(subharm_vibrato),
        subharm_vibrato_delay=float(subharm_vibrato_delay),
        subharm_f0_jitter_on=float(subharm_f0_jitter) > 0.0,
        cut_subharm_below_f0=bool(cut_subharm_below_f0),
        warp_formants=any(s != 1.0 for s in
                          (F1_shift, F2_shift, F3_shift, F4_shift)),
        formant_shift_on=formant_shift != 1.0,
        apply_brightness=bool(apply_brightness),
        noise_transition_smoothness=float(noise_transition_smoothness),
        roughness_on=bool(roughness_on),
        rough_k_list=tuple(rough_k_list),
        rough_h_list=tuple(rough_h_list) if rough_h_list else None,
        rough_alpha=float(rough_alpha),
        rough_hp_fc=float(rough_hp_fc),
        rough_noise_amp=float(rough_noise_amp),
        rough_noise_smooth_ms=float(rough_noise_smooth_ms),
        rough_alpha_slew_ms=float(rough_alpha_slew_ms),
        max_overlap=max_overlap,
        pulse_min_spacing=min_spacing,
        subharm_min_spacing=subharm_min_spacing,
    )
    knobs = {
        "pitch_shift": pitch_shift,
        "formant_shift": formant_shift,
        "formant_band_shifts": np.asarray(
            [F1_shift, F2_shift, F3_shift, F4_shift], dtype=np.float32),
        "uv_strength": uv_strength,
        "breath_strength": breath_strength,
        "normalize": normalize,
        "f0_jitter_strength": f0_jitter_strength,
        "volume_jitter_strength_harm": volume_jitter_strength_harm,
        "volume_jitter_strength_breath": volume_jitter_strength_breath,
        "subharm_weight": subharm_weight,
        "subharm_vibrato_rate": subharm_vibrato_rate,
        "subharm_vibrato_depth": subharm_vibrato_depth,
        "subharm_f0_jitter_strength": subharm_f0_jitter,
    }
    mix, harm, uv, bre = _synth(st, env, f0, mask, jnp.asarray(tracks),
                                knobs, key=jax.random.PRNGKey(seed))
    # stack on device and fetch ONCE: one device-to-host copy, not four
    stems = np.asarray(_stack4(mix, harm, uv, bre))
    return (stems[0], stems[1], stems[2], stems[3])
