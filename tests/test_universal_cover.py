"""Coverage invariant of the universal warm ladder (VERDICT r3 item 1).

The round-3 universal bridge only covered short 44.1 kHz notes: a 4 s
sustain or any 48 kHz voicebank missed every warmed graph and paid the
full specialized compile (minutes for the 11-flag stack).  The
ladder (resampler.WARM_NOTE_SECONDS x WARM_SAMPLE_RATES, with warm
arrays inflated along the axes real notes outgrow the synthetic warm
note: pitch-tick tables, velocity pre-warp plans) must dominate every
realistic note geometry.

These tests assert the invariant WITHOUT compiling: plan_warm_entries
is pure host planning, so the warm shapes are registered directly and
checked against real note preparations across note length, sample rate,
velocity, tempo, pitch-string length and flag stacks.  The actual
promote-and-render path is exercised by
test_universal.py::test_render_note_auto_promotes.
"""
import numpy as np
import pytest

from goofer_tpu import config
from goofer_tpu.sampler.render_core import (
    universal_static,
    universalize_inputs,
)
from goofer_tpu.sampler.resampler import (
    WARM_NOTE_SECONDS,
    WARM_SAMPLE_RATES,
    GooferResampler,
    _find_covering_universal,
    _universal_ready,
    plan_warm_entries,
)

N_FFT = config.SAMPLER_N_FFT
HOP = config.SAMPLER_HOP


@pytest.fixture(scope="module", autouse=True)
def _warm_shapes_registered():
    """Register the ladder's cover shapes (no compiles), restore after."""
    saved = dict(_universal_ready)
    _universal_ready.clear()
    for rate in WARM_SAMPLE_RATES:
        for ru, a_u, s_u, r in plan_warm_entries(sr=rate):
            _universal_ready[ru] = {
                k: tuple(np.asarray(v).shape) for k, v in a_u.items()}
    yield
    _universal_ready.clear()
    _universal_ready.update(saved)


def _synth_features(sr: int, src_sec: float, seed: int = 1):
    """Synthetic extracted features of a ``src_sec``-long source."""
    rng = np.random.default_rng(seed)
    ylen = int(src_sec * sr)
    t_src = 1 + ylen // HOP
    env = np.exp(rng.normal(-4.0, 1.0,
                            (N_FFT // 2 + 1, t_src))).astype(np.float32)
    f0i = np.full(ylen, 220.0, dtype=np.float32)
    vmask = np.ones(ylen, dtype=np.float32)
    forms = {i: np.full(t_src, 500.0 * (i + 1), dtype=np.float32)
             for i in range(4)}
    return env, f0i, vmask, forms, ylen


def _cover_for(sr, length_ms, velocity=100, tempo="!120",
               pitch_string="AA", flags="", consonant=60, src_sec=None):
    if src_sec is None:
        # oto-typical source: the cut brackets the note with margin
        src_sec = min(max(0.6, length_ms / 1000.0 * 1.3 + 0.3), 16.0)
    env, f0i, vmask, forms, ylen = _synth_features(sr, src_sec)
    r = GooferResampler(
        "_t.wav", "_t_out.wav", "C4", velocity, flags, 0, length_ms,
        consonant, 0, 100, 0, tempo, pitch_string, autorender=False)
    rs_b, a_b, s_b = r.prepare(env, f0i, vmask, forms, sr, ylen,
                               bucket=True)
    ru = universal_static(rs_b)
    assert ru is not None, "note fell outside universal-graph support"
    a_u, s_u = universalize_inputs(rs_b, a_b, s_b, r.params)
    return _find_covering_universal(
        ru, {k: np.asarray(v).shape for k, v in a_u.items()})


HEAVY = "sh30sr30sg40su40sj20st-30vf40es30pd40fw20fsta50"


@pytest.mark.parametrize("sr", WARM_SAMPLE_RATES)
@pytest.mark.parametrize("length_ms", [300, 750, 1500, 3000, 5000, 7500])
def test_ladder_covers_lengths_and_rates(sr, length_ms):
    """The headline invariant: any note up to the ladder's top rung, at
    any warmed sample rate, finds a dominating universal graph — with
    the 11-flag stack on (the flag set does not affect coverage, but
    this is the exact geometry class BENCH_r03 measured at 167 s
    first-sight)."""
    assert _cover_for(sr, length_ms, flags=HEAVY) is not None


@pytest.mark.parametrize("velocity", [30, 50, 100, 150, 200])
def test_ladder_covers_velocity_stretch(velocity):
    """Velocity warps the pre-loop frame plan up to 2x the post-warp
    frame count; the warm rungs' inflated env_pos arrays must dominate
    the whole factor range [0.5, 2]."""
    assert _cover_for(44100, 1200, velocity=velocity) is not None


@pytest.mark.parametrize("sr", WARM_SAMPLE_RATES)
def test_ladder_covers_consonant_heavy_compress(sr):
    """Worst case for the pre-warp plan length: the consonant IS most of
    the note and velocity 200 halves it post-warp, so the pre-warp
    env_pos arrays run ~2x the post-warp frame count."""
    assert _cover_for(sr, 900, velocity=200, consonant=700) is not None


@pytest.mark.parametrize("sr", WARM_SAMPLE_RATES)
@pytest.mark.parametrize("length_ms,tempo", [
    (750, "!240"), (3000, "!240"), (7500, "!300")])
def test_ladder_covers_dense_pitch_strings(sr, length_ms, tempo):
    """High-tempo tick curves: a 7.5 s note at tempo 300 carries ~3600
    ticks (pow2-padded to 4096); the warm pitch_ticks tables must be at
    least that tall."""
    tick_dt = 60.0 / (float(tempo[1:]) * 96.0)
    n_ticks = int(length_ms / 1000.0 / tick_dt) + 8
    ps = f"AB#{n_ticks - 1}#"
    assert _cover_for(sr, length_ms, tempo=tempo,
                      pitch_string=ps) is not None


def test_ladder_covers_velocity_plus_pitch_plus_flags():
    """The compound worst case: stretched velocity, dense bends, full
    flag stack, 48 kHz, 4 s."""
    assert _cover_for(48000, 4000, velocity=40, tempo="!240",
                      pitch_string=f"AB#{3000}#", flags=HEAVY) is not None


def test_miss_past_ladder_top_is_expected():
    """Geometry past the top rung misses (falls back to the specialized
    compile + background ladder warm) — documents the boundary rather
    than pretending unbounded cover."""
    assert _cover_for(44100, 14000) is None


def test_unwarmed_rate_misses():
    """A 22.05 kHz note misses the default ladder (it warms lazily via
    render_note_auto's background ladder warm)."""
    assert _cover_for(22050, 750) is None


def test_tightest_rung_is_chosen():
    """A short note promotes into the SMALLEST dominating rung, not an
    arbitrary one — padded compute on the fallback path stays bounded."""
    cover = _cover_for(44100, 400)
    assert cover is not None
    target, _ = cover
    smallest = min(
        (ru for ru in _universal_ready if ru.sr == 44100),
        key=lambda ru: ru.n)
    assert target.n == smallest.n
