"""Note renderer: the full UTAU resample pipeline.

Equivalent of ``GooferResampler.render``/``resample``
(ref: SillySampler.py:415-1185).  The host computes index plans, formant
sanitization, the pitch curve and fry weights (all tiny NumPy work); the
entire device side — envelope effects, loop/velocity materialization, the
four synthesis layers and every post-filter — is ONE fused jitted graph
(sampler/render_core.py), so a note render is a single device dispatch.
"""
from __future__ import annotations

import math

import logging
import os
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from goofer_tpu import config
from goofer_tpu.io.goofy import (
    formants_to_int_keys,
    load_features,
    save_features,
)
from goofer_tpu.ops.envelope import decode_env_from_knots
from goofer_tpu.ops.filters import gaussian_kernel1d
from goofer_tpu.sampler.flags import NoteParams
from goofer_tpu.sampler.plan import (
    FramePlan,
    plan_cut,
    plan_env_loop,
    plan_prefix_stretch,
    plan_track_loop,
)
from goofer_tpu.sampler.render_core import (
    RenderStatic,
    render_note,
    universal_static,
    universalize_inputs,
)
from goofer_tpu.utils.audio_io import read_wav_mono, write_wav

log = logging.getLogger("goofer_tpu")

SANITIZE_MIN_HZ = (120.0, 300.0, 1500.0, 2000.0)


def _np_lerp_at(src: np.ndarray, pos: np.ndarray) -> np.ndarray:
    n = len(src)
    pos = np.clip(np.asarray(pos, dtype=np.float64), 0.0, n - 1.0)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, max(n - 2, 0))
    frac = pos - lo
    hi = np.minimum(lo + 1, n - 1)
    return src[lo] * (1.0 - frac) + src[hi] * frac


def _np_apply_plan(src: np.ndarray, plan: FramePlan) -> np.ndarray:
    """Host materialization of a 1-D frame plan (for tiny formant tracks)."""
    a = _np_lerp_at(src, plan.pos0)
    b = _np_lerp_at(src, plan.pos1)
    return (a * (1.0 - plan.w) + b * plan.w).astype(np.float32)


def _np_fit(x: np.ndarray, t: int) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    if len(x) < t:
        return np.pad(x, (0, t - len(x)), mode="edge")
    return x[:t]


def _np_gaussian1d(x: np.ndarray, sigma: float) -> np.ndarray:
    """Reference-style Gaussian smoothing on host (reflect pad); switches
    to an FFT convolution for large taps*length products."""
    if sigma <= 0 or x.size == 0:
        return x.copy()
    k = gaussian_kernel1d(float(sigma)).astype(np.float64)
    radius = (len(k) - 1) // 2
    if radius <= 0:
        return x.copy()
    padded = np.pad(x.astype(np.float64), radius, mode="reflect")
    if len(k) * len(padded) > 4_000_000:
        n = len(padded)
        nfft = 1 << (n + len(k) - 2).bit_length()
        full = np.fft.irfft(np.fft.rfft(padded, nfft)
                            * np.fft.rfft(k, nfft), nfft)
        return full[len(k) - 1: len(k) - 1 + n - len(k) + 1]
    return np.convolve(padded, k, mode="valid")


def sanitize_formant_track(track: np.ndarray, t: int, sr: int,
                           min_hz: float, max_hz: float | None = None,
                           sigma_frames: float = 3) -> np.ndarray:
    """Repair out-of-range/NaN formant frames by interpolating from good
    ones, then smooth (ref: SillySampler.py:264-283)."""
    max_hz = max_hz or (sr * 0.48)
    x = np.array(track, dtype=np.float32, copy=True)
    if len(x) < t:
        x = np.pad(x, (0, t - len(x)), mode="edge")
    elif len(x) > t:
        x = x[:t]
    bad = (~np.isfinite(x)) | (x < min_hz) | (x > max_hz)
    if np.any(bad):
        good = np.where(~bad)[0]
        if good.size >= 2:
            gx = good.astype(np.float64)
            gy = x[~bad].astype(np.float64)
            pos = np.where(bad)[0].astype(np.float64)
            vals = np.interp(pos, gx, gy)
            sl = (gy[1] - gy[0]) / (gx[1] - gx[0] + 1e-10)
            sr_ = (gy[-1] - gy[-2]) / (gx[-1] - gx[-2] + 1e-10)
            vals = np.where(pos < gx[0], gy[0] + sl * (pos - gx[0]), vals)
            vals = np.where(pos > gx[-1], gy[-1] + sr_ * (pos - gx[-1]), vals)
            x[bad] = vals.astype(np.float32)
        elif good.size == 1:
            x[bad] = x[~bad][0]
        else:
            x = np.full_like(x, 300.0)
    if sigma_frames > 0:
        x = _np_gaussian1d(x, sigma_frames).astype(np.float32)
    return x


def _pad_memo(memo: dict, arr: np.ndarray, target: int, mode: str,
              axis: int = -1) -> np.ndarray:
    """Pad ``arr`` to ``target`` along ``axis``, memoized on the source
    object's identity so arrays shared across notes pad to a SHARED
    padded object (preserving the phrase batcher's in_axes=None dedupe)."""
    cur = arr.shape[axis]
    if cur >= target:
        return arr
    key = ("pad", id(arr), target, mode, axis)
    out = memo.get(key)
    if out is None:
        width = [(0, 0)] * arr.ndim
        width[axis] = (0, target - cur)
        if mode == "zero":
            out = np.pad(arr, width)
        else:
            out = np.pad(arr, width, mode="edge")
        memo[key] = out
    return out


def _bucketize(rs: "RenderStatic", arrays: dict, memo: dict,
               n_target: int | None = None):
    """Pad note geometry to shared length buckets (SURVEY §7 hard part 3).

    Sample counts round up to a ~1.25-ratio geometric bucket
    (config.bucket_len); frame counts derive from the sample bucket so a
    bucket pair never splits a graph signature.  Plan/position arrays pad
    by repeating their last entry (the padded tail replays the final true
    frame/sample), features pad edge, fry weights pad zero.  The render
    graph (RenderStatic.masked) zeroes everything past the traced
    ``n_true`` before any normalization, so padded output is exact over
    the true region up to sub-sample boundary smoothing of the
    voiced/unvoiced crossfade.  The host slices results back to n_true.
    """
    from dataclasses import replace

    hop = rs.hop
    # n_fft//2 headroom: the masked synth writes the true-end stft reflect
    # pad into the padded region past n_true.  ``n_target`` (>= rs.n)
    # lets the phrase planner unify several length buckets into one
    # graph when the padding waste is bounded (see plan_phrase).
    n_b = config.bucket_len(max(rs.n, int(n_target or 0)) + rs.n_fft // 2)
    te_b = config.bucket_frames(n_b, hop)
    if rs.t_env > te_b:                       # pathological geometry
        te_b = config.bucket_frames(config.bucket_len(rs.t_env * hop), hop)

    def fbucket(frames: int) -> int:
        return config.bucket_frames(config.bucket_len(frames * hop), hop)

    a = dict(arrays)
    a["env_cut"] = _pad_memo(memo, a["env_cut"],
                             fbucket(a["env_cut"].shape[1]), "edge", axis=1)
    s_b = config.bucket_len(max(a["f0_cut"].shape[0],
                                a["mask_cut"].shape[0]))
    a["f0_cut"] = _pad_memo(memo, a["f0_cut"], s_b, "edge")
    a["mask_cut"] = _pad_memo(memo, a["mask_cut"], s_b, "edge")

    # env plan: post-velocity env frames must land on te_b; with velocity
    # the plan lives in the pre-warp domain and buckets independently.
    # Sample-domain loop/velocity positions are device-built closed
    # forms, so only the pre-velocity length (rs.n_loop) buckets.
    ep_b = fbucket(len(a["env_pos0"])) if rs.vel_on else te_b
    for k in ("env_pos0", "env_pos1", "env_w"):
        a[k] = _pad_memo(memo, a[k], ep_b, "edge")
    if rs.vel_on:
        a["vel_env_pos"] = _pad_memo(memo, a["vel_env_pos"], te_b, "edge")
        n_loop_b = config.bucket_len(rs.n_loop or rs.n)
    else:
        n_loop_b = n_b

    a["tracks"] = _pad_memo(memo, a["tracks"], te_b, "edge", axis=1)
    a["tracks_raw"] = _pad_memo(memo, a["tracks_raw"], te_b, "edge", axis=1)

    rs_b = replace(rs, n=n_b, t_env=te_b, n_loop=n_loop_b, masked=True)
    return rs_b, a


def _feature_path(in_file: Path) -> Path:
    return in_file.with_name(f"{in_file.stem}_features.goofy")


def _src_tag(feat_path: str) -> str:
    stem = Path(feat_path).name
    if stem.endswith("_features.goofy"):
        return stem[: -len("_features.goofy")]
    return Path(feat_path).stem


def invalidate_render_cache(out_path: str, feat_path: str) -> None:
    """Delete cached renders for a source after a voicing edit
    (ref: SillySampler.py:23-41)."""
    try:
        out_dir = Path(out_path).parent
        tag = _src_tag(feat_path)
        for p in out_dir.glob(f"{tag}*.wav"):
            try:
                p.unlink()
                log.info("[SE] Invalidated cache: %s", p.name)
            except Exception as e:  # pragma: no cover
                log.warning("[SE] Could not delete %s: %s", p, e)
        for ext in ("json", "txt", "lock"):
            for p in out_dir.glob(f"{tag}*.{ext}"):
                try:
                    p.unlink()
                except Exception:  # pragma: no cover
                    pass
    except Exception as e:  # pragma: no cover
        log.warning("[SE] Cache invalidate failed: %s", e)


# --------------------------------------------------------------------------
# Universal fallback dispatch (VERDICT r2 item 2: bounded time-to-first-
# note).  A warmed reference renders ANY flag string at full speed after
# its one-time numba warmup (ref: GOOFER.py:1224); here every new
# (flag-toggle set x geometry) is a fresh XLA graph — minutes of compile
# for the flag-heavy stacks.  The bridge: warm_universal() compiles the
# all-features-on graph (render_core.universal_static) for a geometry
# bucket once; a first-sight note whose bucket is warmed then renders
# immediately through it (unused features exactly neutral) while the
# specialized graph compiles on a background thread.  Steady state is
# unchanged: once a signature has rendered once, it dispatches directly.

_graph_lock = threading.Lock()
_seen_statics: set = set()        # specialized signatures compiled in-process
_universal_ready: dict = {}       # universal static -> {array: shape}
_inflight_statics: set = set()    # background compiles in progress
_bg_compiler = None

# VERDICT r3 item 7: every specialized signature pins a compiled
# executable inside the shared jit wrapper, with no eviction — a long
# OpenUtau session across many flag combos x geometries accumulates
# them without bound.  When the count crosses this budget the sweep
# drops EVERY single-note executable (specialized and universal) and
# re-warms the universal ladder in the background, so the steady-state
# working set is bounded at ~budget executables + the ladder.
GRAPH_BUDGET = int(os.environ.get("GOOFER_TPU_GRAPH_BUDGET", "256"))


def _compiler():
    global _bg_compiler
    if _bg_compiler is None:
        from concurrent.futures import ThreadPoolExecutor
        _bg_compiler = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="goofer-bg-compile")
    return _bg_compiler


def _sweep_graph_budget() -> None:
    """Bound the compiled single-note working set (see GRAPH_BUDGET).

    Over budget: drop every compiled executable in the shared jit
    wrapper, reset the signature bookkeeping, and re-warm the universal
    ladder for the sample rates that were warm — in the background, so
    the sweeping request only pays its own (already rendered) graph.
    With the persistent XLA compilation cache enabled the re-warm
    deserializes instead of recompiling."""
    from goofer_tpu.sampler.render_core import clear_compiled_render_graphs

    with _graph_lock:
        if len(_seen_statics) <= GRAPH_BUDGET:
            return
        warmed = {(ru.sr, ru.n_fft, ru.hop) for ru in _universal_ready}
        _seen_statics.clear()
        _universal_ready.clear()
        _ladder_warming_srs.clear()
    log.info("Graph budget (%d) exceeded: clearing compiled note graphs "
             "and re-warming the universal ladder", GRAPH_BUDGET)
    clear_compiled_render_graphs()
    for sr, n_fft, hop in sorted(warmed):
        _warm_ladder_background(sr, n_fft, hop)


def _find_covering_universal(ru: RenderStatic, shapes: dict):
    """A warmed universal graph whose geometry DOMINATES the note's
    bucketed geometry (every dimension >=): smaller notes promote into
    it by edge-padding, so a handful of warmed sizes cover every note
    below them.  Returns (target_static, target_shapes) or None.
    Prefers the tightest cover (least padded compute)."""
    from dataclasses import replace

    best = None
    near_miss = None
    with _graph_lock:
        ready = list(_universal_ready.items())
    for cand, cshapes in ready:
        if (cand.sr, cand.n_fft, cand.hop) != (ru.sr, ru.n_fft, ru.hop):
            continue
        if cand != replace(ru, n=cand.n, t_env=cand.t_env,
                           n_loop=cand.n_loop):
            continue
        bad = [k for k in shapes
               if k not in cshapes
               or any(c < s for c, s in zip(cshapes[k], shapes[k]))]
        if bad:
            near_miss = (cand, bad)
            continue
        if best is None or cand.n < best[0].n:
            best = (cand, cshapes)
    if best is None and near_miss is not None:
        cand, bad = near_miss
        log.debug("Universal cover miss: warmed n=%d fails domination on "
                  "%s (note shapes %s)", cand.n, bad,
                  {k: shapes[k] for k in bad})
    return best


def _promote_arrays(arrays: dict, target_shapes: dict) -> dict:
    """Edge-pad every device input up to the covering universal graph's
    shapes (the same padding _bucketize uses: padded tails replay the
    last true frame/sample and are masked out of the output)."""
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        tgt = target_shapes[k]
        if tuple(v.shape) != tuple(tgt):
            pad = [(0, t - s) for s, t in zip(v.shape, tgt)]
            v = np.pad(v, pad, mode="edge")
        out[k] = v
    return out


def render_note_auto(rsmp: "GooferResampler", rs: RenderStatic,
                     arrays: dict, scalars: dict, prepare_bucketed):
    """Dispatch a single-note render, bridging first-sight compiles
    through a warmed universal graph when one covers the note.

    ``prepare_bucketed`` lazily re-plans the note with bucketed geometry
    (only needed on the fallback path)."""
    with _graph_lock:
        seen = rs in _seen_statics or not _universal_ready
    if not seen:
        rs_b, arrays_b, scalars_b = prepare_bucketed()
        ru = universal_static(rs_b)
        cover = None
        if ru is not None:
            a_u, s_u = universalize_inputs(rs_b, arrays_b, scalars_b,
                                           rsmp.params)
            cover = _find_covering_universal(
                ru, {k: np.asarray(v).shape for k, v in a_u.items()})
        if cover is not None:
            with _graph_lock:
                should_bg = rs not in _inflight_statics
                if should_bg:
                    _inflight_statics.add(rs)
            if should_bg:
                key = rsmp.key

                def _compile_specialized():
                    try:
                        render_note(rs, arrays, scalars, key
                                    ).block_until_ready()
                        with _graph_lock:
                            _seen_statics.add(rs)
                        _sweep_graph_budget()
                    finally:
                        with _graph_lock:
                            _inflight_statics.discard(rs)

                _compiler().submit(_compile_specialized)
            log.info("Rendering via universal graph "
                     "(specialized graph compiling in background)")
            target, tshapes = cover
            out = render_note(target, _promote_arrays(a_u, tshapes),
                              s_u, rsmp.key)
            return out[: rs.n]
        if ru is not None:
            # no rung dominates this note (unwarmed sample rate, or
            # geometry past the ladder): warm the ladder for its rate in
            # the background so later first-sight combos are covered
            _warm_ladder_background(ru.sr, ru.n_fft, ru.hop)
    out = render_note(rs, arrays, scalars, rsmp.key)
    with _graph_lock:
        _seen_statics.add(rs)
    _sweep_graph_budget()
    return out


# Default warm ladder (VERDICT r3 item 1): note lengths covering the
# interactive range up to long sustains, at the sample rates voicebanks
# actually ship (44.1 kHz everywhere, 48 kHz common for modern banks;
# other rates — e.g. 22.05 kHz — warm lazily on first sight, see
# render_note_auto).  Every note whose bucketed geometry fits UNDER a
# rung promotes into it, so this ladder covers first-sight renders of
# any flag combination across the whole range.
WARM_NOTE_SECONDS = (0.75, 2.0, 4.0, 8.0)
WARM_SAMPLE_RATES = (44100, 48000)


def _inflate_warm_arrays(rs_b: RenderStatic, a_u: dict, sec: float,
                         hop: int) -> dict:
    """Grow the warm note's device arrays along the axes where REAL notes
    outgrow the synthetic warm note, so the recorded cover shapes
    dominate what the server actually sees:

    - ``pitch_ticks``: the synthetic warm note's pitch string is trivial
      (~16 ticks) but UTAU ships tick-rate bend curves — up to ~1100
      ticks/s at extreme tempos — padded to a pow2.  Cost of the larger
      table is one edge-padded HBM buffer; the per-sample interp is a
      gather, independent of table height.
    - ``env_pos0/1/w``: the pre-velocity loop plan.  A velocity-stretched
      note's PRE-warp frame count can reach ~2x its post-warp t_env
      (velocity factor range [0.5, 2], prefix-only), while the warm note
      renders at velocity 100 (plan length == t_env).
    """
    def fbucket(frames: int) -> int:
        return config.bucket_frames(config.bucket_len(frames * hop), hop)

    a = dict(a_u)
    k_t = max(1024, 1 << int(math.ceil(math.log2(max(2.0, 1100.0 * sec)))))
    if a["pitch_ticks"].shape[0] < k_t:
        a["pitch_ticks"] = np.pad(
            a["pitch_ticks"], (0, k_t - a["pitch_ticks"].shape[0]),
            mode="edge")
    ep_t = fbucket(2 * rs_b.t_env)
    for k in ("env_pos0", "env_pos1", "env_w"):
        if a[k].shape[0] < ep_t:
            a[k] = np.pad(a[k], (0, ep_t - a[k].shape[0]), mode="edge")
    return a


def plan_warm_entries(note_seconds=WARM_NOTE_SECONDS, sr: int = 44100,
                      n_fft: int = config.SAMPLER_N_FFT,
                      hop: int = config.SAMPLER_HOP):
    """Build the (universal static, arrays, scalars, key) tuples the warm
    ladder compiles — PURE host planning, no device work, so tests can
    assert the coverage invariant (every realistic note geometry finds a
    dominating rung) without paying the compiles."""
    rng = np.random.default_rng(0)
    entries = []
    for sec in note_seconds:
        # generous source: covers cuts up to ~2.5x the note length (the
        # oto cutoff can run past the sustain region; truly unbounded
        # cuts — cutoff 0 on a much longer sample — fall back to the
        # specialized compile path)
        ylen = int(sec * 2.5 * sr) + n_fft
        t_src = 1 + ylen // hop
        env = np.exp(rng.normal(-4.0, 1.0,
                                (n_fft // 2 + 1, t_src))).astype(np.float32)
        f0i = np.full(ylen, 220.0, dtype=np.float32)
        vmask = np.ones(ylen, dtype=np.float32)
        forms = {i: np.full(t_src, 500.0 * (i + 1), dtype=np.float32)
                 for i in range(4)}
        r = GooferResampler(
            "_warm.wav", "_warm_out.wav", "C4", 100, "",
            0, int(sec * 1000), 30, 0, 100, 0, "!120", "AA",
            autorender=False, n_fft=n_fft, hop=hop)
        rs_b, arrays_b, scalars_b = r.prepare(
            env, f0i, vmask, forms, sr, ylen, bucket=True)
        ru = universal_static(rs_b)
        if ru is None:
            continue
        a_u, s_u = universalize_inputs(rs_b, arrays_b, scalars_b, r.params)
        a_u = _inflate_warm_arrays(rs_b, a_u, sec, hop)
        entries.append((ru, a_u, s_u, r))
    return entries


def warm_universal(note_seconds=WARM_NOTE_SECONDS, sr=44100,
                   n_fft: int = config.SAMPLER_N_FFT,
                   hop: int = config.SAMPLER_HOP) -> int:
    """Compile the universal render graph for the geometry buckets that
    ``note_seconds``-long notes land in (server warmup / probe use);
    every note whose bucketed geometry fits UNDER a warmed size promotes
    into it (render_note_auto), so a short ladder of sizes covers the
    interactive range.  ``sr`` may be an int or an iterable of rates.
    Synthetic features are generated in-process — no voicebank needed.
    Returns the number of graphs compiled."""
    srs = (sr,) if isinstance(sr, (int, np.integer)) else tuple(sr)
    compiled = 0
    for rate in srs:
        for ru, a_u, s_u, r in plan_warm_entries(
                note_seconds, int(rate), n_fft, hop):
            shapes = {k: tuple(np.asarray(v).shape) for k, v in a_u.items()}
            with _graph_lock:
                if _universal_ready.get(ru) == shapes:
                    continue
            render_note(ru, a_u, s_u, r.key).block_until_ready()
            with _graph_lock:
                _universal_ready[ru] = shapes
            compiled += 1
    return compiled


_ladder_warming_srs: set = set()


def _warm_ladder_background(sr: int, n_fft: int, hop: int) -> None:
    """On a universal-cover miss, warm the full ladder for the note's
    sample rate in the background (dedup per (sr, n_fft, hop)): the miss
    means the voicebank runs at a rate (or geometry) the startup warmup
    did not cover, and every LATER first-sight flag combo at this rate
    would miss too.  The current note still pays its specialized
    compile; the session recovers from the second combo on."""
    key = (int(sr), int(n_fft), int(hop))
    with _graph_lock:
        if key in _ladder_warming_srs:
            return
        _ladder_warming_srs.add(key)

    def _warm():
        try:
            n = warm_universal(sr=sr, n_fft=n_fft, hop=hop)
            log.info("Background ladder warm for sr=%d done (%d graphs)",
                     sr, n)
        except Exception:
            log.exception("Background ladder warm for sr=%d failed", sr)
            with _graph_lock:
                _ladder_warming_srs.discard(key)

    _compiler().submit(_warm)


# fry-off scalar block (see GooferResampler._fry_scalars)
_FRY_ZERO = {k: 0.0 for k in (
    "fry_c0", "fry_c1", "fry_g0", "fry_g1", "fry_r0", "fry_rs",
    "fry_s", "fry_e", "fry_a1", "fry_rin", "fry_b0", "fry_rout")}

# get/insert under a lock: the HTTP server's handler threads all plan
# through here (SURVEY §5 race bar); readers hold their own reference so
# the clear-when-full sweep can't invalidate an entry mid-use.
_decoded_lock = threading.Lock()
_decoded_cache: dict = {}


def acquire_features(in_file: Path, n_fft: int, hop: int):
    """Load the .goofy cache or extract + save it
    (ref: SillySampler.py:415-432).  Returns dense env on device.

    Decoded features are memoized on (path, mtime): repeated phrase plans
    and server requests against the same source skip the .goofy parse and
    the knot-decode device round-trip."""
    feat = _feature_path(in_file)
    if feat.exists():
        ck = (str(feat), feat.stat().st_mtime_ns, n_fft, hop)
        with _decoded_lock:
            hit = _decoded_cache.get(ck)
        if hit is not None:
            return hit
        log.info("Loading cached features")
        env, f0i, vmask, forms, sr, ylen = load_features(feat)
        if isinstance(env, dict) and env.get("mode") == "knots":
            env = np.asarray(decode_env_from_knots(
                jnp.asarray(env["knot_vals_log"], dtype=jnp.float32),
                env["sr"], env["n_fft"], env["n_bins"]))
        out = (np.asarray(env, dtype=np.float32), f0i, vmask, forms,
               sr, ylen)
        with _decoded_lock:
            if len(_decoded_cache) > 64:
                _decoded_cache.clear()
            _decoded_cache[ck] = out
        return out
    log.info("Extracting features")
    y, sr = read_wav_mono(in_file)
    # Route the singleton through the BUCKETED batch graph (batch of 1):
    # the exact-length graph is compiled per distinct file length and is
    # almost never warm on an interactive path, while the bucketed
    # analysis graphs are shared across lengths (<=4 shapes per ladder),
    # pre-warmed by folder extraction / cache seeding, and bit-match the
    # per-file path (tests/test_batch_extract.py).  VERDICT r4 item 3:
    # first-contact extraction pays one warm dispatch, not a compile.
    from goofer_tpu.analysis.features import extract_features_batch

    env, f0i, vmask, forms, knots = extract_features_batch(
        [y], sr, n_fft=n_fft, hop_length=hop)[0]
    ylen = len(y)
    save_features(feat, knots, f0i, vmask, forms, sr, ylen)
    return np.asarray(env, dtype=np.float32), f0i, vmask, forms, sr, ylen


class GooferResampler:
    """13-positional-arg UTAU resampler (ref: SillySampler.py:286-306).

    Constructing the object renders the note, like the reference.
    ``editor_hook(y_snip, sr, init_mask) -> mask|None`` replaces the
    blocking tkinter editor for SE1.
    """

    def __init__(self, in_file, out_file, pitch, velocity, flags="",
                 offset=0, length=1000, consonant=0, cutoff=0,
                 volume=100, modulation=0, tempo="!120", pitch_string="AA",
                 editor_hook=None, n_fft=config.SAMPLER_N_FFT,
                 hop=config.SAMPLER_HOP, seed: int = 0,
                 autorender: bool = True):
        self.in_file = Path(in_file)
        self.out_file = Path(out_file)
        self.params = NoteParams.from_args(
            pitch, velocity, flags, offset, length, consonant, cutoff,
            volume, modulation, tempo, pitch_string)
        self.editor_hook = editor_hook
        self.n_fft = n_fft
        self.hop = hop
        self._seed = seed
        self._key = None
        if autorender:
            self.render()

    @property
    def key(self):
        # lazy: PRNGKey is a device dispatch, and phrase planning
        # constructs many resamplers whose key is never used (the
        # batcher supplies its own)
        if self._key is None:
            self._key = jax.random.PRNGKey(self._seed)
        return self._key

    # ------------------------------------------------------------------

    def render(self):
        from goofer_tpu.utils.profiling import (
            StageTimer,
            device_trace,
            profiling_enabled,
        )

        p = self.params
        timer = StageTimer(enabled=profiling_enabled())
        with device_trace():
            with timer.stage("features"):
                env, f0i, vmask, forms, sr, ylen = acquire_features(
                    self.in_file, self.n_fft, self.hop)

                forms = formants_to_int_keys(forms)
                if p.reverse:
                    log.info("Reversing features (R flag)")
                    env = env[:, ::-1]
                    f0i = f0i[::-1]
                    vmask = vmask[::-1]
                    forms = {k: np.asarray(forms[k])[::-1] for k in forms}

            with timer.stage("resample"):
                out = self.resample(env, f0i, vmask, forms, sr, ylen)
                out = np.asarray(out)

            with timer.stage("write"):
                log.info("Writing %s", self.out_file)
                write_wav(self.out_file, out, sr)
        if timer.enabled:
            timer.report(audio_seconds=len(out) / sr)

    # ------------------------------------------------------------------

    def _editor_roundtrip(self, mask_cut: np.ndarray, cut, sr, ylen):
        """SE1: run the voicing editor on the note snippet and write the
        edited mask back into the .goofy (ref: SillySampler.py:577-616)."""
        from goofer_tpu.editor.core import write_back_voicing

        p = self.params
        feat_path = str(_feature_path(self.in_file))
        y_src, _ = read_wav_mono(self.in_file)
        if p.reverse:
            y_src = y_src[::-1]
        y_snip = y_src[cut.start_sample:cut.end_sample].astype(np.float32)

        result = self.editor_hook(y_snip, sr, mask_cut.astype(np.float32))
        if result is not None and len(result) == len(mask_cut):
            edited = np.asarray(result, dtype=np.float32)
            write_back_voicing(feat_path, edited, cut.start_sample,
                               cut.end_sample, p.reverse)
            invalidate_render_cache(str(self.out_file), feat_path)
            return edited
        return mask_cut

    # ------------------------------------------------------------------

    def resample(self, env, f0i, vmask, forms, sr, ylen):
        """Prepare host-side plans/arrays and run the fused render graph
        (sampler/render_core.py) in a single device dispatch.

        First sight of a graph signature (flag-toggle set x geometry)
        would cost an XLA compile (seconds to minutes for flag-heavy
        stacks); when a warmed UNIVERSAL graph covers the note, it
        renders immediately through that while the specialized graph
        compiles in a background thread (VERDICT r2 item 2 —
        render_note_auto)."""
        rs, arrays, scalars = self.prepare(env, f0i, vmask, forms, sr, ylen)
        log.info("Synthesizing")
        if self.params.use_editor:
            # SE1 is a blocking interactive render and prepare() is not
            # side-effect-free under it (the editor round-trip) — the
            # lazy bucketed re-plan of the universal bridge would open
            # the editor twice; render directly
            return render_note(rs, arrays, scalars, self.key)
        out = render_note_auto(
            self, rs, arrays, scalars,
            lambda: self.prepare(env, f0i, vmask, forms, sr, ylen,
                                 bucket=True))
        return out

    # ------------------------------------------------------------------

    def prepare(self, env, f0i, vmask, forms, sr, ylen, cache=None,
                bucket: bool = False):
        """Host planning: cut geometry, loop/velocity index plans, formant
        sanitize, pitch curve, fry weights.  Returns (RenderStatic,
        arrays, scalars) for render_note / the phrase batcher.

        ``cache`` (optional dict, shared across the notes of a phrase)
        memoizes cut slices, looped formant tracks and pitch curves so
        repeated notes contribute identical array OBJECTS — the phrase
        batcher then passes them unbatched (vmap in_axes=None).

        ``bucket=True`` pads every geometry-dependent array to a length
        bucket and marks the render masked (scalars carry ``n_true``), so
        arbitrary note geometries share a handful of compiled graphs —
        output is exact over the true region up to boundary smoothing
        (see _bucketize)."""
        p = self.params
        hop = self.hop
        sample_len_sec = ylen / sr
        memo = cache if cache is not None else {}

        def cached(key, fn):
            val = memo.get(key)
            if val is None:
                val = fn()
                memo[key] = val
            return val

        cut = plan_cut(sample_len_sec, sr, hop, p.offset_sec,
                       p.consonant_sec, p.cutoff_sec, p.reverse)
        log.info("Interpolating features")

        env_cut = cached(
            ("env_cut", id(env), cut.start_frame, cut.end_frame),
            lambda: np.asarray(env[:, cut.start_frame:cut.end_frame],
                               dtype=np.float32))
        f0_cut = cached(
            ("f0_cut", id(f0i), cut.start_sample, cut.end_sample),
            lambda: np.asarray(f0i[cut.start_sample:cut.end_sample],
                               dtype=np.float32))
        mask_cut = cached(
            ("mask_cut", id(vmask), cut.start_sample, cut.end_sample),
            lambda: np.asarray(vmask[cut.start_sample:cut.end_sample],
                               dtype=np.float32))

        pre_frames = cut.consonant_frame - cut.start_frame
        tail_frames = cut.end_frame - cut.consonant_frame
        pre_samples = cut.consonant_sample - cut.start_sample
        tail_samples = cut.end_sample - cut.consonant_sample

        # --- SE editor + FV -------------------------------------------
        if p.use_editor:
            if self.editor_hook is not None:
                mask_cut = self._editor_roundtrip(mask_cut, cut, sr, ylen)
            else:
                # ref blocks on the tkinter editor here; headless we can
                # only log the skip (never silently, VERDICT r1 item 4)
                log.warning("[SE] flag set but no editor is available "
                            "(no display/tkinter) — rendering unedited")
        if p.force_voiced:
            mask_cut = np.ones_like(mask_cut)

        # --- sustain loop + velocity plans ----------------------------
        desired_tail_samples = int(p.length_sec * sr)
        desired_tail_frames = int(np.ceil(p.length_sec * sr / hop))

        env_plan = plan_env_loop(pre_frames, tail_frames,
                                 desired_tail_frames, p.loop_mode)
        target_frames = len(env_plan)
        # sample loop positions are rebuilt ON DEVICE from
        # (pre, tail) scalars (render_core.loop_positions) — only the
        # length is needed here: identity prefix + desired tail samples
        # (plan.plan_sample_loop semantics, ref SillySampler.py:698-712)
        n_loop = pre_samples + desired_tail_samples

        vel = p.velocity_factor
        fplan = None
        vel_samp_on = False
        vel_pre_new = 1
        if abs(vel - 1.0) > 1e-6 and pre_frames > 1 and pre_samples > 1:
            fplan = plan_prefix_stretch(target_frames, pre_frames, vel)
            if n_loop > 1:
                # velocity sample positions are also device-built
                # (render_core.velocity_positions); host derives the
                # warped length (plan.plan_prefix_stretch semantics)
                vel_samp_on = True
                vel_pre_new = max(1, int(round(pre_samples * vel)))
        vel_on = fplan is not None or vel_samp_on
        t_env = len(fplan) if fplan is not None else target_frames
        n_total = (vel_pre_new + (n_loop - pre_samples) if vel_samp_on
                   else n_loop)

        # --- formant tracks: loop -> velocity -> canon -> sanitize ----
        track_plan = plan_track_loop(pre_frames, tail_frames,
                                     desired_tail_frames, p.loop_mode)

        def build_tracks():
            rows = []
            rows_raw = []
            for k in (1, 2, 3, 4):
                track = np.asarray(forms.get(k, np.zeros(1)),
                                   dtype=np.float32)
                track = track[cut.start_frame:cut.end_frame]
                if track.size == 0:
                    track = np.zeros(1, dtype=np.float32)
                looped = _np_apply_plan(track, track_plan)
                looped = _np_fit(looped, target_frames)
                if fplan is not None:
                    looped = _np_fit(_np_apply_plan(looped, fplan), t_env)
                # reference quirk: canon to the PRE-velocity frame count,
                # then sanitize edge-pads back out
                # (ref: SillySampler.py:756,792)
                looped = _np_fit(looped, target_frames)
                # warp-anchor track: upstream sanitize_smooth_formant
                # ALIASES the canon'd float32 track, so its gap-fill
                # writes back into the dict gf.synthesize warps by —
                # invalid frames (unvoiced head, sub-min_hz) reach the
                # warp FILLED (interp/extrapolated, UNsmoothed).  The
                # aliasing breaks when sanitize pads/slices, i.e. when
                # velocity changed the frame count (t_env !=
                # target_frames) — then the warp sees the raw zeros.
                # (ref: SillySampler.py:264-283 via 802-805, 1015;
                # certified by tests/test_ref_upstream.py)
                fit = _np_fit(looped, t_env)
                good_any = np.any(
                    np.isfinite(fit) & (fit >= SANITIZE_MIN_HZ[k - 1])
                    & (fit <= sr * 0.48))
                if t_env == target_frames and good_any:
                    # all-bad tracks skip the fill: upstream's 300 Hz
                    # fallback rebinds instead of writing through
                    warp_tr = sanitize_formant_track(
                        looped, t_env, sr, SANITIZE_MIN_HZ[k - 1],
                        sigma_frames=0)
                else:
                    warp_tr = fit
                rows_raw.append(warp_tr)
                rows.append(sanitize_formant_track(
                    looped, t_env, sr, SANITIZE_MIN_HZ[k - 1],
                    sigma_frames=4))
            return np.stack(rows), np.stack(rows_raw)

        tracks, tracks_raw = cached(
            ("tracks", id(forms), cut.start_frame, cut.end_frame,
             p.loop_mode, desired_tail_frames, target_frames, t_env, vel),
            build_tracks)

        # --- pitch curve ------------------------------------------------
        # The device interpolates the tick-rate curve per sample
        # (render_core); the host builds the dense curve too, but only for
        # the pd scale and the pulse-overlap bounds below — it never ships.
        tick_dt = 60.0 / (p.tempo * 96.0)

        def build_ticks():
            bend = p.bend_cents.astype(np.float64)
            semi = bend / 100.0 + p.pitch_midi
            if p.t_cents:
                semi = semi + p.t_cents / 100.0
            k = len(semi)
            k_pad = max(16, 1 << (k - 1).bit_length())
            out = np.full(k_pad, semi[-1], dtype=np.float32)
            out[:k] = semi.astype(np.float32)
            return out, k

        pitch_ticks, n_ticks = cached(
            ("ticks", p.pitch_midi, p.t_cents, p.bend_cents.tobytes()),
            build_ticks)

        def build_midi_curve():
            semi = pitch_ticks[:n_ticks].astype(np.float64)
            t_samples = np.arange(n_total) / sr
            if n_ticks == 1:
                return np.full(n_total, float(semi[0]))
            t_max = (n_ticks - 1) * tick_dt
            t_clamped = np.clip(t_samples, 0.0, t_max)
            return np.interp(t_clamped / tick_dt,
                             np.arange(n_ticks), semi)

        midi_curve = cached(
            ("midi", n_total, p.pitch_midi, p.t_cents, p.tempo,
             p.bend_cents.tobytes()),
            build_midi_curve)

        # --- pd: smoothed bend + 95th-percentile scale (host) -----------
        pd_on = p.pitch_dyn != 0.0
        pd_baseline = p.pitch_midi + (p.t_cents / 100.0)

        # the smoothed bend curve itself is rebuilt on device from the
        # midi curve (render_core); only the percentile scale ships
        def build_pd_ref():
            sigma = max(1, int(0.010 * sr))
            bend = _np_gaussian1d(midi_curve - pd_baseline, float(sigma))
            return float(np.percentile(np.abs(bend), 95.0) + 1e-8)

        if pd_on:
            pd_ref = cached(
                ("pd", n_total, pd_baseline, p.pitch_midi, p.t_cents,
                 p.tempo, p.bend_cents.tobytes()),
                build_pd_ref)
        else:
            pd_ref = 1.0

        # --- fry weights ------------------------------------------------
        vf = min(100.0, max(-100.0, float(p.fry_amount)))
        fry_on = vf != 0.0

        # the fry weight/mask curves are piecewise-linear ramps; the
        # host derives their exact integer region bounds + slopes (same
        # arithmetic as the reference's array surgery) and the device
        # materializes the curves (render_core.fry_curves) — the last
        # O(n)-per-note dispatch payload eliminated
        fry_sc = (self._fry_scalars(n_total, sr, vf) if fry_on
                  else _FRY_ZERO)

        # --- statics + scalars ----------------------------------------
        tension_sign = 0 if p.tension == 0 else (1 if p.tension > 0 else -1)
        tension_order = int(min(6, max(1, round(1 + abs(p.tension) * 4))))

        # per-band formant warp: the piecewise-linear map's deviation
        # from identity peaks AT the anchors (|f_orig - f_shifted| over
        # valid anchors; endpoints are pinned), so the host bounds the
        # warp's bin offset and the device uses the banded dense-select
        # resample instead of a per-element gather (ops/envelope.py)
        warp_band = 0
        warp_on = any(s != 1.0 for s in p.f_shifts)
        if warp_on:
            n_bins = env_cut.shape[0]
            nyq = sr / 2.0
            off_hz = 0.0
            for k in range(4):
                tr = tracks_raw[k]
                sh = tr * p.f_shifts[k]
                valid = np.isfinite(tr) & (tr > 50.0) & (tr < nyq) \
                    & (sh > 50.0)
                if np.any(valid):
                    off_hz = max(off_hz,
                                 float(np.max(np.abs(tr - sh)[valid])))
            band = int(np.ceil(off_hz * (n_bins - 1) / nyq)) + 2
            # round UP to a bucket so nearby notes share graphs; too
            # wide (> ~nb/2) falls back to the unbounded gather
            for b in (8, 16, 32, 64, 128, 192, 256):
                if band <= b and b < n_bins // 2:
                    warp_band = b
                    break

        # pulse-overlap bound from the f0 range this note can produce:
        # longest pulse ~ sr/f0_floor samples, onsets up to f0_ceil/sr per
        # sample, pulses are zero past u = Ra + Rk*(1-Ra) ~= 0.804
        hz_lo = float(440.0 * 2.0 ** ((np.min(midi_curve) - 69.0) / 12.0))
        hz_hi = float(440.0 * 2.0 ** ((np.max(midi_curve) - 69.0) / 12.0))
        floor_cands = [hz_lo, config.PULSE_FALLBACK_F0]
        ceil_cands = [hz_hi, config.PULSE_FALLBACK_F0]
        if fry_on:
            floor_cands.append(p.fry_base_hz)
            ceil_cands.append(p.fry_base_hz)
        jit_lo = max(0.25, 1.0 - p.f0_jitter_strength) if p.f0_jitter else 1.0
        jit_hi = (1.0 + p.f0_jitter_strength) if p.f0_jitter else 1.0
        f0_floor = max(1.0, min(floor_cands) * jit_lo)
        f0_ceil = max(ceil_cands) * jit_hi
        # subharmonics run at 2x f0 (semitones=12): same ratio, covered.
        ratio = f0_ceil / f0_floor
        max_overlap = config.bucket_overlap(
            int(min(32, max(3, math.ceil(0.804 * ratio) + 2))))
        # growl layer: f0 * 0.5 * 2**N(0, mix^2); bound the spread at 3
        # sigma each way (tails only lose low-amplitude pulse ends)
        spread = 2.0 ** (6.0 * p.growl_mix ** 2) if p.growl_mix > 0 else 1.0
        growl_max_overlap = config.bucket_overlap(int(min(32, max(3,
            math.ceil(0.804 * ratio * spread) + 2))))
        # onset-spacing floor from the same f0 ceiling: sizes the pulse
        # kernel's compact tables (m = n/spacing rows to gather)
        min_spacing = config.bucket_min_spacing(int(sr / max(f0_ceil, 1.0)))
        growl_min_spacing = config.bucket_min_spacing(int(sr / max(
            f0_ceil * 0.5 * spread, 1.0)))
        # su layer: f0/2 -> onsets 2x sparser -> half the kernel rows
        su_min_spacing = config.bucket_min_spacing(int(sr / max(
            f0_ceil * 0.5, 1.0)))
        # subharmonic layer: semitones=12 (2x) with vibrato depth 3
        # (peak f0 x (1 + depth)) hardcoded at the main synth call
        subharm_min_spacing = config.bucket_min_spacing(int(sr / max(
            f0_ceil * 2.0 * 4.0, 1.0)))

        rs = RenderStatic(
            sr=sr, n_fft=self.n_fft, hop=hop, n=n_total, t_env=t_env,
            tilt_on=p.brightness_env != 1.0,
            shape_amt=float(p.env_shape),
            fw_on=p.formant_width != 0.0,
            vel_on=vel_on,
            strengths_on=any(abs(s) > 1e-6 for s in p.formant_strengths),
            pd_on=p.pitch_dyn != 0.0,
            fry_on=fry_on,
            f0_jitter=p.f0_jitter,
            volume_jitter=p.volume_jitter,
            add_subharm=p.add_subharm,
            warp_formants=warp_on,
            warp_band=warp_band,
            formant_shift_on=p.formant_shift != 1.0,
            su_on=p.subharm_gain > 0.0,
            sj_on=p.growl_mix > 0.0,
            sd_on=p.sd_strength > 0,
            tension_sign=tension_sign,
            tension_order=tension_order,
            sa_on=p.aperiodic_mix > 0.0,
            max_overlap=max_overlap,
            growl_max_overlap=growl_max_overlap,
            min_spacing=min_spacing,
            growl_min_spacing=growl_min_spacing,
            subharm_min_spacing=subharm_min_spacing,
            su_min_spacing=su_min_spacing,
            n_loop=n_loop,
        )

        one = cached(("zeros1",), lambda: np.zeros(1, dtype=np.float32))
        arrays = {
            "env_cut": env_cut,
            "f0_cut": f0_cut if f0_cut.size else one,
            "mask_cut": mask_cut if mask_cut.size else one,
            "env_pos0": env_plan.pos0, "env_pos1": env_plan.pos1,
            "env_w": env_plan.w,
            "vel_env_pos": (fplan.pos0 if fplan is not None else one),
            "tracks": tracks,
            "tracks_raw": tracks_raw,
            "pitch_ticks": pitch_ticks,
        }
        scalars = {
            "brightness_env": p.brightness_env,
            # compile-time on the specialized graph (RenderStatic
            # .shape_amt picks blur kernels); traced on the universal one
            "env_shape": p.env_shape,
            "fw_amount": p.formant_width,
            "formant_shift": p.formant_shift,
            "formant_band_shifts": np.asarray(p.f_shifts, dtype=np.float32),
            "formant_strengths": np.asarray(p.formant_strengths,
                                            dtype=np.float32),
            "f0_jitter_strength": p.f0_jitter_strength,
            "volume_jitter_strength": p.volume_jitter_strength,
            "subharm_weight": p.subharm_weight,
            "normalize": p.normalize,
            "pitch_dyn": p.pitch_dyn,
            "pd_baseline": pd_baseline,
            "pd_ref": pd_ref,
            "tick_dt_samp": tick_dt * sr,
            "n_ticks": float(n_ticks),
            "fry_vh": p.fry_base_hz,
            "subharm_gain": p.subharm_gain,
            "growl_mix": p.growl_mix,
            "sd_strength": p.sd_strength,
            "tension": p.tension,
            "harmonic_mix": p.harmonic_mix,
            "breathiness_mix": p.breathiness_mix,
            "unvoiced_mix": p.unvoiced_mix,
            "volume": p.volume,
            "aperiodic_mix": p.aperiodic_mix,
            "n_true": float(n_total),
            # engine noise strengths (ref synthesize defaults,
            # GOOFER.py:975); traced so tests can zero the noise stems
            "uv_strength": 0.75,
            "breath_strength": 0.1,
            # device-side position closed forms (render_core)
            "loop_pre": float(pre_samples),
            "loop_tail": float(max(1, tail_samples)),
            "vel_pre_new": float(vel_pre_new if vel_samp_on else 1),
            "vel_pre_len": float(pre_samples if vel_samp_on else 1),
            "vel_factor": float(vel if vel_samp_on else 1.0),
            **fry_sc,
        }
        if bucket:
            rs, arrays = _bucketize(rs, arrays, memo)
        return rs, arrays, scalars

    # ------------------------------------------------------------------

    def _fry_scalars(self, n, sr, vf):
        """Exact integer region bounds + ramp slopes of the fry
        weight/mask curves (ref: SillySampler.py:883-965), computed with
        the reference's host arithmetic and shipped as 12 scalars; the
        device materializes the piecewise-linear curves
        (render_core.fry_curves).

        base_w: 1 on [c0, c1), r0 + rs*(j - g0) on [g0, g1), else 0.
        fry_mask: on [s, e): ramp-in (j - s)*rin for j < a1 (else 1)
        times ramp-out 1 - (j - b0)*rout for j >= b0 (else 1)."""
        p = self.params
        vl = p.fry_glide_pct

        c0 = c1 = g0 = g1 = 0
        r0 = rs_ = 0.0
        if vf > 0:
            L = int(round(n * (vf / 100.0)))
            if L > 0:
                glide = min(L, max(0, int(round(L * (vl / 100.0)))))
                const = L - glide
                c0, c1 = 0, const
                if glide > 0:
                    # base_w = 1 - linspace(0,1,glide)
                    g0, g1 = const, L
                    r0 = 1.0
                    rs_ = -1.0 / (glide - 1) if glide > 1 else 0.0
        else:
            L = int(round(n * (abs(vf) / 100.0)))
            if L > 0:
                glide = min(L, max(0, int(round(L * (vl / 100.0)))))
                const = L - glide
                start = n - L
                if glide > 0:
                    # base_w = 1 - linspace(1,0,glide)
                    g0, g1 = start, start + glide
                    r0 = 0.0
                    rs_ = 1.0 / (glide - 1) if glide > 1 else 0.0
                if const > 0:
                    c0, c1 = start + glide, n

        # faded region mask (sized from the note midpoint,
        # ref: SillySampler.py:937-965)
        mid = n // 2
        if vf > 0:
            L2 = int(round(mid * (vf / 100.0)))
            s_i, e_i = 0, max(0, min(n, L2))
        else:
            L2 = int(round((n - mid) * (abs(vf) / 100.0)))
            s_i, e_i = max(0, n - L2), n
        a1 = s_i
        b0 = e_i
        rin = rout = 0.0
        if e_i > s_i:
            fade = int(0.01 * sr)
            if fade > 0:
                a1 = min(e_i, s_i + fade)
                if a1 - s_i > 1:
                    rin = 1.0 / (a1 - s_i - 1)
                b0 = max(s_i, e_i - fade)
                if e_i - b0 > 1:
                    rout = 1.0 / (e_i - b0 - 1)
        else:
            s_i = e_i = 0
        return {
            "fry_c0": float(c0), "fry_c1": float(c1),
            "fry_g0": float(g0), "fry_g1": float(g1),
            "fry_r0": float(r0), "fry_rs": float(rs_),
            "fry_s": float(s_i), "fry_e": float(e_i),
            "fry_a1": float(a1), "fry_rin": float(rin),
            "fry_b0": float(b0), "fry_rout": float(rout),
        }
