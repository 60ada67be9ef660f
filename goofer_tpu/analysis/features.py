"""Feature extraction: spectral envelope + F0 + voicing + formants + knots.

Mirrors the reference analysis entry (ref: GOOFER.py:940-969):

* envelope = Gaussian-blurred STFT magnitude (sigma = 2 freq bins) — the
  reference is a blur, not cepstral liftering, and we match the reference;
* F0 = AC pitch track -> nan->0 -> short-gap bridging -> linear per-sample
  interpolation over a shared [0, duration] axis -> clip [1e-5, 2000];
* voicing mask = f0_interp > 75 Hz;
* formants = Burg tracks padded to the envelope frame count;
* mel-knot compression of the envelope for storage.

The entire analysis traces into ONE jitted graph per (length, sr, frame
config) — envelope, pitch, formants, per-sample interpolation and the
knot-error sweep all run in a single device dispatch; the host only picks
the adaptive K (11 scalars) and gathers the chosen knot rows.
"""
from __future__ import annotations

import functools
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np

from goofer_tpu import config
from goofer_tpu.analysis.formants import formant_graph
from goofer_tpu.analysis.pitch import PitchConfig, fix_f0_gaps, pitch_graph
from goofer_tpu.ops.envelope import (
    KNOT_EPS,
    KNOT_K_MAX,
    KNOT_K_START,
    KNOT_K_STEP,
    _knot_bin_idx,
    _decode_matrix,
    mel_knot_freqs,
)
from goofer_tpu.ops.filters import gaussian_blur1d
from goofer_tpu.ops.interp import gather_lerp
from goofer_tpu.ops.stft import stft


def _packed(graph, example_args):
    """Wrap a multi-output analysis graph so ONE flat f32 vector leaves
    the device: one device-to-host copy instead of six.  Returns
    (packed_fn, shapes, split_points); the host splits/reshapes after a
    single fetch."""
    shapes = jax.eval_shape(graph, *example_args)
    sizes = [int(np.prod(sh.shape)) for sh in shapes]
    splits = list(np.cumsum(sizes)[:-1])

    def packed(*args):
        outs = graph(*args)
        return jnp.concatenate(
            [o.reshape(-1).astype(jnp.float32) for o in outs])

    return packed, shapes, splits


def _unpack(flat_np, shapes, splits):
    parts = np.split(flat_np, splits)
    return [p.reshape(sh.shape) for p, sh in zip(parts, shapes)]


def _packed_mixed(graph, example_args):
    """_packed for heterogeneous output dtypes: f16/u8/i32 outputs are
    BITCAST into the one f32 fetch vector (VERDICT r2 item 4 — the warm
    extraction fetch shipped ~5x the bytes it kept; f16 knots and u8
    masks halve/quarter their share).  The host views the words back."""
    shapes = jax.eval_shape(graph, *example_args)
    words = []
    for sh in shapes:
        sz = int(np.prod(sh.shape))
        if sh.dtype in (jnp.float32.dtype, jnp.int32.dtype):
            words.append(sz)
        elif sh.dtype == jnp.float16.dtype:
            words.append(-(-sz // 2))
        elif sh.dtype == jnp.uint8.dtype:
            words.append(-(-sz // 4))
        else:
            raise TypeError(f"unpackable dtype {sh.dtype}")
    splits = list(np.cumsum(words)[:-1])

    def packed(*args):
        outs = graph(*args)
        flats = []
        for o in outs:
            b = o.reshape(-1)
            if o.dtype == jnp.float32.dtype:
                flats.append(b)
            elif o.dtype == jnp.int32.dtype:
                flats.append(jax.lax.bitcast_convert_type(b, jnp.float32))
            elif o.dtype == jnp.float16.dtype:
                pad = (-b.shape[0]) % 2
                if pad:
                    b = jnp.pad(b, (0, pad))
                flats.append(jax.lax.bitcast_convert_type(
                    b.reshape(-1, 2), jnp.float32))
            elif o.dtype == jnp.uint8.dtype:
                pad = (-b.shape[0]) % 4
                if pad:
                    b = jnp.pad(b, (0, pad))
                flats.append(jax.lax.bitcast_convert_type(
                    b.reshape(-1, 4), jnp.float32))
        return jnp.concatenate(flats)

    return packed, shapes, splits


def _unpack_mixed(flat_np, shapes, splits):
    parts = np.split(np.ascontiguousarray(flat_np, dtype=np.float32),
                     splits)
    outs = []
    for p, sh in zip(parts, shapes):
        dt = np.dtype(str(sh.dtype))
        sz = int(np.prod(sh.shape))
        outs.append(np.ascontiguousarray(p).view(dt)[:sz].reshape(sh.shape))
    return outs


def _lean_tail(sr, n_fft, k_values, log_env, f0_track, tracks, errs):
    """Device side of the adaptive-K knot pick (VERDICT r2 item 4): the
    first K under budget is selected ON DEVICE and only its (padded)
    knot rows leave the chip as f16 — the dense env/log_env (2 x
    n_bins x T f32, the bulk of the warm-extraction fetch) never ship.

    f0 ships at FRAME rate (VERDICT r3 item 6): the per-sample f32
    interp + u8 mask were ~60% of the lean fetch bytes (0.5 MB for a
    2 s file);
    the linear per-sample interp and the >75 Hz threshold are trivial
    host math (_host_f0_interp), identical to the device formula up to
    last-bit rounding — sub-f16, so the stored .goofy payload is
    unchanged (tests/test_batch_extract.py::test_lean_extraction_
    identical compares at storage precision).

    Same arithmetic as the host _pick_knots (the f32->f16 cast rounds
    nearest-even on both sides)."""
    n_bins = n_fft // 2 + 1
    ok = errs < KNOT_EPS
    chosen = jnp.where(jnp.any(ok), jnp.argmax(ok),
                       len(k_values) - 1).astype(jnp.int32)
    k_top = max(k_values)
    idx_stack = np.stack([
        np.pad(_knot_bin_idx(sr, n_fft, k, n_bins),
               (0, k_top - k), mode="edge")
        for k in k_values])
    rows = jnp.take(jnp.asarray(idx_stack), chosen, axis=0)
    knots16 = log_env[rows, :].astype(jnp.float16)
    return knots16, chosen, f0_track.astype(jnp.float32), tracks


def _host_f0_interp(f0_track, n: int, f0_min: float, nf: int | None = None):
    """Host mirror of the device per-sample f0 interpolation (shared
    [0, duration] axis, edge-clamped linear gather, clip, >f0_min mask;
    ref: GOOFER.py:960-966).  ``nf`` (bucketed path) is the TRUE frame
    count inside a padded track.  float32 arithmetic like the device;
    differences are last-bit rounding — invisible at the f16 storage
    precision of the .goofy payload."""
    f0_track = np.asarray(f0_track, dtype=np.float32)
    k = int(len(f0_track) if nf is None else nf)
    if k <= 1:
        f0_interp = np.full(n, f0_track[0] if k else 0.0, dtype=np.float32)
    else:
        if nf is None:
            pos = np.linspace(0.0, k - 1.0, n).astype(np.float32)
        else:
            ratio = np.float32(k - 1.0) / np.float32(max(n - 1, 1))
            pos = np.arange(n, dtype=np.float32) * ratio
            pos = np.minimum(pos, np.float32(k - 1.0))
        lo = np.clip(np.floor(pos).astype(np.int32), 0, k - 2)
        frac = (pos - lo.astype(np.float32))
        hi = np.minimum(lo + 1, k - 1)
        f0_interp = f0_track[lo] * (1.0 - frac) + f0_track[hi] * frac
    f0_interp = np.clip(f0_interp, config.F0_CLIP_LO, config.F0_CLIP_HI)
    mask = (f0_interp > f0_min).astype(np.float64)
    return f0_interp.astype(np.float64), mask


def _knots_from_lean(knots16, chosen_idx, k_values, sr, n_fft,
                     t_true=None) -> dict:
    k = int(k_values[int(chosen_idx)])
    vals = knots16[:k] if t_true is None else knots16[:k, :t_true]
    n_bins = n_fft // 2 + 1
    return {
        "mode": "knots",
        "knot_vals_log": np.asarray(vals, dtype=np.float16),
        "hz_knots": mel_knot_freqs(sr, n_fft, k),
        "n_bins": int(n_bins),
        "n_fft": int(n_fft),
        "sr": int(sr),
    }


@functools.lru_cache(maxsize=32)
def _analysis_graph(n: int, sr: int, n_fft: int, hop: int, f0_min: float,
                    f0_merge_range: int, with_formants: bool,
                    lean: bool = False):
    """Build + jit the fused analysis for one static configuration.

    ``lean``: fetch only what the .goofy keeps — device-picked f16 knot
    rows, chosen-K index, per-sample f0, u8 voicing mask and formant
    tracks (no dense env_spec/log_env; VERDICT r2 item 4)."""
    n_bins = n_fft // 2 + 1
    k_values = tuple(range(KNOT_K_START, KNOT_K_MAX + 1, KNOT_K_STEP))

    def graph(y):
        S = stft(y, n_fft, hop)
        mag = jnp.abs(S) + 1e-8
        env_spec = gaussian_blur1d(mag, 2.0, axis=0)
        t_frames = env_spec.shape[1]

        # pitch -> gaps -> per-sample interp -> clip -> mask
        f0_track = pitch_graph(y, sr, hop / sr, PitchConfig(f0_min=f0_min))
        f0_track = jnp.nan_to_num(f0_track)
        f0_track = fix_f0_gaps(f0_track, f0_merge_range)
        if not lean:
            if f0_track.shape[0] > 1:
                # shared [0, duration] axis on both grids
                # (ref: GOOFER.py:960-963)
                pos = jnp.linspace(0.0, f0_track.shape[0] - 1.0, n)
                f0_interp = gather_lerp(f0_track, pos, axis=0)
            else:
                f0_interp = jnp.full((n,), f0_track[0])
            f0_interp = jnp.clip(f0_interp, config.F0_CLIP_LO,
                                 config.F0_CLIP_HI)
            voicing_mask = (f0_interp > f0_min).astype(jnp.float32)

        if with_formants:
            tracks = formant_graph(y, sr, hop / sr)
        else:
            tracks = jnp.zeros((5, t_frames), dtype=jnp.float32)

        # knot codec error sweep (all candidate K in one dispatch)
        env_s = gaussian_blur1d(env_spec, 0.5, axis=0)
        log_env = jnp.log(jnp.maximum(env_s, 1e-8))
        check_idx = np.linspace(0, t_frames - 1,
                                min(256, t_frames)).astype(np.int64)
        env_check = env_s[:, check_idx]
        log_check = log_env[:, check_idx]
        errs = []
        for k in k_values:
            bin_idx = _knot_bin_idx(sr, n_fft, k, n_bins)
            knots = log_check[bin_idx, :]
            w = jnp.asarray(_decode_matrix(sr, n_fft, k))
            recon = jnp.exp(jnp.dot(w, knots,
                                    precision=jax.lax.Precision.HIGHEST,
                                    preferred_element_type=jnp.float32))
            errs.append(jnp.max(jnp.abs(recon - env_check)
                                / (env_check + 1e-8)))
        if lean:
            return _lean_tail(sr, n_fft, k_values, log_env, f0_track,
                              tracks, jnp.stack(errs))
        return env_spec, f0_interp, voicing_mask, tracks, log_env, \
            jnp.stack(errs)

    pack = _packed_mixed if lean else _packed
    packed, shapes, splits = pack(
        graph, (jax.ShapeDtypeStruct((n,), jnp.float32),))
    from goofer_tpu.utils import aot

    cfg = (f"{n}|{sr}|{n_fft}|{hop}|{f0_min}|{f0_merge_range}|"
           f"{with_formants}|{lean}")
    return aot.wrap("analysis", cfg, jax.jit(packed)), \
        k_values, shapes, splits


@functools.lru_cache(maxsize=32)
def _analysis_graph_bucketed(n_pad: int, sr: int, n_fft: int, hop: int,
                             f0_min: float, f0_merge_range: int,
                             with_formants: bool, pf_pad: int, ff_pad: int,
                             lean: bool = False, mesh=None):
    """Bucket-padded, vmapped analysis graph: one compile serves every
    file whose length rounds up to ``n_pad`` (SURVEY §7 / an earlier perf-review
    item 4).  Waveforms carry trailing zeros; the pitch/formant frame
    grids are host-computed from each file's TRUE length (windows never
    read padding), padded to static frame buckets, and the Viterbi passes
    through padded steps untouched — so true-frame results equal the
    unpadded graph."""
    from goofer_tpu.analysis.formants import formant_graph as _fg
    from goofer_tpu.analysis.pitch import pitch_graph_bucketed

    n_bins = n_fft // 2 + 1
    k_values = tuple(range(KNOT_K_START, KNOT_K_MAX + 1, KNOT_K_STEP))
    dt = hop / sr

    def graph(y, n_true, p_starts, p_nf, f_starts, f_nf):
        # write the stft's right reflect pad at the TRUE end into the
        # zero padding, so even the boundary-straddling frames equal the
        # unpadded analysis: padded[n_true+k] = y[n_true-2-k]
        nt = n_true.astype(jnp.int32)
        m = n_fft // 2
        src = jnp.clip(nt - 2 - jnp.arange(m, dtype=jnp.int32), 0,
                       n_pad - 1)
        y_m = jax.lax.dynamic_update_slice(y, jnp.take(y, src), (nt,))

        S = stft(y_m, n_fft, hop)
        mag = jnp.abs(S) + 1e-8
        env_spec = gaussian_blur1d(mag, 2.0, axis=0)
        t_pad = env_spec.shape[1]
        # true stft frame count: 1 + n_true // hop (center-padded framing)
        t_true = 1 + n_true.astype(jnp.int32) // hop

        f0_track = pitch_graph_bucketed(y, sr, dt, p_starts, p_nf,
                                        PitchConfig(f0_min=f0_min))
        f0_track = jnp.nan_to_num(f0_track)
        f0_track = fix_f0_gaps(f0_track, f0_merge_range)
        if not lean:
            # per-sample interp over the shared [0, duration] axis, with
            # the TRUE frame/sample counts (ref: GOOFER.py:960-963)
            pos = (jnp.arange(n_pad, dtype=jnp.float32)
                   * (jnp.maximum(p_nf.astype(jnp.float32) - 1.0, 0.0)
                      / jnp.maximum(n_true - 1.0, 1.0)))
            pos = jnp.minimum(pos, p_nf.astype(jnp.float32) - 1.0)
            f0_interp = gather_lerp(f0_track, pos, axis=0)
            f0_interp = jnp.where(p_nf > 1, f0_interp, f0_track[0])
            f0_interp = jnp.clip(f0_interp, config.F0_CLIP_LO,
                                 config.F0_CLIP_HI)
            voicing_mask = (f0_interp > f0_min).astype(jnp.float32)

        if with_formants:
            tracks = _fg(y, sr, dt, starts=f_starts, nf=f_nf)
        else:
            tracks = jnp.zeros((5, ff_pad), dtype=jnp.float32)

        # knot codec error sweep at 256 check columns of the TRUE range
        env_s = gaussian_blur1d(env_spec, 0.5, axis=0)
        log_env = jnp.log(jnp.maximum(env_s, 1e-8))
        cpos = jnp.round(jnp.arange(256, dtype=jnp.float32)
                         * (t_true.astype(jnp.float32) - 1.0) / 255.0
                         ).astype(jnp.int32)
        env_check = env_s[:, cpos]
        log_check = log_env[:, cpos]
        errs = []
        for k in k_values:
            bin_idx = _knot_bin_idx(sr, n_fft, k, n_bins)
            knots = log_check[bin_idx, :]
            w = jnp.asarray(_decode_matrix(sr, n_fft, k))
            recon = jnp.exp(jnp.dot(w, knots,
                                    precision=jax.lax.Precision.HIGHEST,
                                    preferred_element_type=jnp.float32))
            errs.append(jnp.max(jnp.abs(recon - env_check)
                                / (env_check + 1e-8)))
        if lean:
            return _lean_tail(sr, n_fft, k_values, log_env, f0_track,
                              tracks, jnp.stack(errs))
        return env_spec, f0_interp, voicing_mask, tracks, log_env, \
            jnp.stack(errs)

    pack = _packed_mixed if lean else _packed
    packed, shapes, splits = pack(graph, (
        jax.ShapeDtypeStruct((n_pad,), jnp.float32),
        jax.ShapeDtypeStruct((), jnp.float32),
        jax.ShapeDtypeStruct((pf_pad,), jnp.int32),
        jax.ShapeDtypeStruct((), jnp.int32),
        jax.ShapeDtypeStruct((ff_pad,), jnp.int32),
        jax.ShapeDtypeStruct((), jnp.int32),
    ))
    vm = jax.vmap(packed)
    if mesh is None:
        from goofer_tpu.utils import aot

        cfg = (f"{n_pad}|{sr}|{n_fft}|{hop}|{f0_min}|{f0_merge_range}|"
               f"{with_formants}|{pf_pad}|{ff_pad}|{lean}")
        return aot.wrap("analysis_b", cfg, jax.jit(vm)), \
            k_values, shapes, splits
    # shard_map, not GSPMD-from-input-shardings: the SPMD partitioner
    # cannot partition the fft custom-call's batch dim and would
    # all-gather + replicate every file's FFT work on every device
    # (see sampler/phrase.py:_batched_core).  All six inputs are
    # per-file, so everything shards on dim 0 over every mesh axis.
    from jax.sharding import PartitionSpec as P

    spec = P(mesh.axis_names)
    fn = jax.jit(jax.shard_map(vm, mesh=mesh, in_specs=(spec,) * 6,
                               out_specs=spec, check_vma=False))
    return fn, k_values, shapes, splits


def extract_features(y, sr: int, n_fft: int = 1024, hop_length: int = 256,
                     f0_min: float = 75.0, f0_merge_range: int = 2,
                     with_formants: bool = True, dense: bool = True):
    """Returns (env_spec, f0_interp, voicing_mask, formants, env_knots)
    with the reference's shapes and dtypes (NumPy on the way out).

    ``dense=False`` (folder extraction / .goofy-bound callers): the
    adaptive-K knot pick runs ON DEVICE and only the saved payload is
    fetched — f16 knot rows, f0, u8 mask, tracks — skipping the dense
    env_spec/log_env (~4x fewer d2h bytes; VERDICT r2 item 4).
    env_spec comes back None; the .goofy payload matches the dense
    path's to <=1-2 ulp (XLA fusion reassociation)."""
    y = np.asarray(y, dtype=np.float32)
    n = len(y)
    graph, k_values, shapes, splits = _analysis_graph(
        n, int(sr), n_fft, hop_length, float(f0_min),
        int(f0_merge_range), bool(with_formants), lean=not dense)
    flat = np.asarray(graph(jnp.asarray(y)))          # ONE d2h round trip

    if not dense:
        knots16, chosen, f0_track, tracks = _unpack_mixed(
            flat, shapes, splits)
        env_knots = _knots_from_lean(knots16, chosen, k_values, sr, n_fft)
        t_frames = knots16.shape[1]
        env_spec = None
        f0_interp, voicing_mask = _host_f0_interp(f0_track, n, f0_min)
    else:
        env_spec, f0_interp, voicing_mask, tracks, log_env, errs = _unpack(
            flat, shapes, splits)
        env_knots = _pick_knots(log_env, errs, k_values, sr, n_fft)
        t_frames = env_spec.shape[1]

    if tracks.shape[1] < t_frames:
        tracks = np.pad(tracks, ((0, 0), (0, t_frames - tracks.shape[1])))
    else:
        tracks = tracks[:, :t_frames]
    formants = {i + 1: tracks[i] for i in range(tracks.shape[0])}

    return (env_spec, f0_interp.astype(np.float64),
            voicing_mask.astype(np.float64), formants, env_knots)


def _pick_knots(log_env: np.ndarray, errs: np.ndarray, k_values,
                sr: int, n_fft: int) -> dict:
    """Host side of the adaptive-K search: pick the first K under the
    budget and gather its knot rows (ref: GOOFER.py:97-147)."""
    n_bins = n_fft // 2 + 1
    chosen = k_values[-1]
    for k, e in zip(k_values, errs):
        if e < KNOT_EPS:
            chosen = int(k)
            break
    bin_idx = _knot_bin_idx(sr, n_fft, chosen, n_bins)
    return {
        "mode": "knots",
        "knot_vals_log": log_env[bin_idx, :].astype(np.float16),
        "hz_knots": mel_knot_freqs(sr, n_fft, chosen),
        "n_bins": int(n_bins),
        "n_fft": int(n_fft),
        "sr": int(sr),
    }


def extract_features_batch(ys, sr: int, n_fft: int = 1024,
                           hop_length: int = 256, f0_min: float = 75.0,
                           f0_merge_range: int = 2,
                           with_formants: bool = True,
                           chunk: int = 16, dense: bool = True,
                           mesh=None):
    """Batched feature extraction: waveforms bucket by padded length and
    each bucket runs as vmapped dispatches of ONE compiled analysis graph
    (chunks padded to a fixed batch), so a voicebank of arbitrary file
    lengths extracts with a handful of compiles instead of one
    multi-second compile per distinct length.

    ``ys``: list of 1-D float arrays at a common sample rate.  Returns a
    list of per-file tuples shaped exactly like extract_features.
    ``dense=False``: device-side knot pick, no dense env in the fetch
    (env comes back None per file; see extract_features).

    ``mesh``: a jax.sharding.Mesh shards each chunk's file batch over
    EVERY mesh axis (per-file analysis is independent — pure data
    parallelism, no collectives; the multi-chip voicebank-extraction
    step, SURVEY §2.6).  Batches pad up to a mesh-size multiple."""
    from goofer_tpu.analysis.formants import formant_frame_grid
    from goofer_tpu.analysis.pitch import (
        PitchConfig,
        _frame_grid,
        pitch_window_len,
    )

    cfg = PitchConfig(f0_min=f0_min)
    dt = hop_length / sr
    items = []
    for i, y in enumerate(ys):
        y = np.asarray(y, dtype=np.float32)
        # +8 hops margin keeps the trailing pad past the gap-filler reach
        n_pad = config.bucket_len(len(y) + 8 * hop_length)
        items.append((n_pad, i, y))

    results: list = [None] * len(ys)
    by_bucket: dict = {}
    for n_pad, i, y in items:
        by_bucket.setdefault(n_pad, []).append((i, y))

    # Chunks DISPATCH ahead of the fetch loop (jit dispatch is async) so
    # device execution of later chunks overlaps the host's
    # fetch/unpack/save of earlier ones (VERDICT r3 item 6) — but the
    # pipeline is BOUNDED to a sliding window of in-flight chunks
    # (ADVICE r4: dispatch-all kept every chunk's device result + async
    # host copy resident at once, so memory scaled with folder size; the
    # dense path carries ~10 MB of f32 env payload per 2 s file).  Lean
    # payloads are ~100x smaller, so the lean window is wider.
    max_inflight = 3 if dense else 32

    def dispatches():
        for n_pad, group in sorted(by_bucket.items()):
            pf_pad = n_pad // hop_length + 2
            ff_pad = n_pad // hop_length + 2
            graph, k_values, shapes, splits = _analysis_graph_bucketed(
                n_pad, int(sr), n_fft, hop_length, float(f0_min),
                int(f0_merge_range), bool(with_formants), pf_pad, ff_pad,
                lean=not dense, mesh=mesh)
            for c0 in range(0, len(group), chunk):
                part = group[c0:c0 + chunk]
                b_pad = config.bucket_batch(min(chunk, len(part)))
                if mesh is not None and b_pad % mesh.size != 0:
                    b_pad = -(-b_pad // mesh.size) * mesh.size
                rows = part + [part[-1]] * (b_pad - len(part))

                yb = np.zeros((b_pad, n_pad), dtype=np.float32)
                n_true = np.empty(b_pad, dtype=np.float32)
                p_starts = np.zeros((b_pad, pf_pad), dtype=np.int32)
                p_nf = np.empty(b_pad, dtype=np.int32)
                f_starts = np.zeros((b_pad, ff_pad), dtype=np.int32)
                f_nf = np.empty(b_pad, dtype=np.int32)
                ff_true = np.empty(b_pad, dtype=np.int64)
                for j, (idx, y) in enumerate(rows):
                    n = len(y)
                    yb[j, :n] = y
                    n_true[j] = n
                    wlen = min(pitch_window_len(sr, cfg), max(16, n))
                    nf, starts, _ = _frame_grid(n, sr, dt, wlen)
                    p_nf[j] = nf
                    p_starts[j, :nf] = starts
                    p_starts[j, nf:] = starts[-1]
                    fnf, fstarts, _, _ = formant_frame_grid(n, sr, dt)
                    ff_true[j] = fnf
                    f_nf[j] = fnf
                    f_starts[j, :fnf] = fstarts
                    f_starts[j, fnf:] = fstarts[-1]

                if mesh is None:
                    flat_dev = graph(yb, n_true, p_starts, p_nf,
                                     f_starts, f_nf)      # async dispatch
                else:
                    from jax.sharding import NamedSharding
                    from jax.sharding import PartitionSpec as P

                    def put(x):
                        spec = P(mesh.axis_names,
                                 *((None,) * (x.ndim - 1)))
                        return jax.device_put(jnp.asarray(x),
                                              NamedSharding(mesh, spec))

                    flat_dev = graph(
                        put(yb), put(n_true), put(p_starts), put(p_nf),
                        put(f_starts), put(f_nf))
                # start the d2h async at dispatch time so this chunk's
                # transfer overlaps the host's unpacking of the previous
                # one
                try:
                    flat_dev.copy_to_host_async()
                except (AttributeError, RuntimeError):  # pragma: no cover
                    pass
                yield (flat_dev, part, p_nf, ff_true, k_values,
                       shapes, splits)

    def drain(item):
        flat_dev, part, p_nf, ff_true, k_values, shapes, splits = item
        flat_b = np.asarray(flat_dev)
        unpack = _unpack_mixed if not dense else _unpack
        rows_np = [unpack(row, shapes, splits) for row in flat_b]

        for j, (idx, y) in enumerate(part):
            n = len(y)
            t_true = 1 + n // hop_length
            if not dense:
                knots16, chosen, f0_tr, tr = rows_np[j]
                env = None
                knots = _knots_from_lean(knots16, chosen, k_values,
                                         sr, n_fft, t_true=t_true)
                f0_out, mask_out = _host_f0_interp(
                    f0_tr, n, f0_min, nf=int(p_nf[j]))
            else:
                env_j, f0_j, mask_j, tr, log_j, errs_j = rows_np[j]
                env = env_j[:, :t_true]
                knots = _pick_knots(log_j[:, :t_true], errs_j,
                                    k_values, sr, n_fft)
                f0_out = f0_j[:n].astype(np.float64)
                mask_out = mask_j[:n].astype(np.float64)
            tr = tr[:, :int(ff_true[j])]
            if tr.shape[1] < t_true:
                tr = np.pad(tr, ((0, 0), (0, t_true - tr.shape[1])))
            else:
                tr = tr[:, :t_true]
            formants = {k + 1: tr[k] for k in range(tr.shape[0])}
            results[idx] = (env, f0_out, mask_out, formants, knots)

    window: deque = deque()
    for item in dispatches():
        window.append(item)
        if len(window) > max_inflight:
            drain(window.popleft())      # fetch oldest; keeps <= max
    while window:
        drain(window.popleft())
    return results
