"""Batched note rendering: vmap within a chip, jax.sharding across chips.

Replaces the reference's thread-pool file parallelism with a single
vmapped dispatch over a padded note bucket, optionally sharded over a
('dp', 'tp') mesh: the note batch rides the dp axis and the mel-knot
envelope-decode contraction rides tp (explicit psum inside shard_map).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from goofer_tpu.engine.synth import (
    SynthStatic,
    default_knobs,
    synth_core_impl,
)
from goofer_tpu.ops.envelope import _decode_matrix


@dataclass
class NoteBatch:
    """Equal-shape note bucket.  ``lengths`` holds true sample counts;
    features are padded (f0/mask with zeros -> silence, env with edge
    frames).  Padding perturbs only the last blur/OLA window before each
    note boundary; bucket sizing keeps that slack small."""
    env: jnp.ndarray        # (B, n_bins, T) or knots (B, K, T)
    f0: jnp.ndarray         # (B, N)
    mask: jnp.ndarray       # (B, N)
    tracks: jnp.ndarray     # (B, 4, T)
    lengths: np.ndarray     # (B,)


def pad_note_batch(envs, f0s, masks, tracks) -> NoteBatch:
    """Pad per-note features to the bucket maximum."""
    b = len(envs)
    n_max = max(int(len(f) ) for f in f0s)
    t_max = max(int(e.shape[1]) for e in envs)
    n_bins = envs[0].shape[0]
    env_b = np.zeros((b, n_bins, t_max), dtype=np.float32)
    f0_b = np.zeros((b, n_max), dtype=np.float32)
    mask_b = np.zeros((b, n_max), dtype=np.float32)
    tr_b = np.zeros((b, 4, t_max), dtype=np.float32)
    lengths = np.zeros(b, dtype=np.int64)
    for i in range(b):
        t = envs[i].shape[1]
        n = len(f0s[i])
        env_b[i, :, :t] = envs[i]
        env_b[i, :, t:] = envs[i][:, -1:]
        f0_b[i, :n] = f0s[i]
        mask_b[i, :n] = masks[i]
        tr_b[i, :, :t] = tracks[i]
        tr_b[i, :, t:] = tracks[i][:, -1:]
        lengths[i] = n
    return NoteBatch(jnp.asarray(env_b), jnp.asarray(f0_b),
                     jnp.asarray(mask_b), jnp.asarray(tr_b), lengths)


@partial(jax.jit, static_argnums=(0,))
def _render_batch_core(st: SynthStatic, env, f0, mask, tracks, knobs, keys):
    fn = jax.vmap(partial(synth_core_impl, st),
                  in_axes=(0, 0, 0, 0, None, 0))
    return fn(env, f0, mask, tracks, knobs, keys)


def _full_knobs(knobs: dict | None) -> dict:
    full = default_knobs()
    if knobs:
        full.update(knobs)
    return {k: jnp.asarray(v, dtype=jnp.float32) for k, v in full.items()}


def render_batch(st: SynthStatic, batch: NoteBatch, knobs: dict | None = None,
                 key=None):
    """Single-chip batched render.  Returns stems of shape (B, N)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, batch.f0.shape[0])
    return _render_batch_core(st, batch.env, batch.f0, batch.mask,
                              batch.tracks, _full_knobs(knobs), keys)


_decode_render_cache: dict = {}


def _decode_and_render_sharded(mesh, st: SynthStatic, n_bins: int):
    """shard_map'd knot decode + batched synthesis: the note batch rides
    'dp' and the knot contraction axis rides 'tp' with an EXPLICIT
    ``jax.lax.psum`` closing the partial products — the one collective
    this framework semantically needs (SURVEY §2.6).

    shard_map rather than GSPMD-from-input-shardings because the SPMD
    partitioner cannot partition the fft custom-call's batch dimension:
    it all-gathers the batch and every device redundantly computes every
    note's FFTs (measured on the 8-device virtual mesh: 12 all-gathers,
    dp=8 throughput 0.44-0.60x of dp=1).  Inside shard_map the FFTs run
    on local shards only.  Synthesis after the psum is replicated across
    tp members (the standard tensor-parallel epilogue cost)."""
    key = (mesh, st, n_bins)
    fn = _decode_render_cache.get(key)
    if fn is None:
        def f(w_l, knots_l, f0_l, mask_l, tracks_l, knobs, keys_l):
            log_env = jnp.einsum("nk,bkt->bnt", w_l,
                                 knots_l.astype(jnp.float32),
                                 precision=jax.lax.Precision.HIGHEST,
                                 preferred_element_type=jnp.float32)
            log_env = jax.lax.psum(log_env, "tp")
            env = jnp.exp(log_env)[:, :n_bins, :]
            vm = jax.vmap(partial(synth_core_impl, st),
                          in_axes=(0, 0, 0, 0, None, 0))
            return vm(env, f0_l, mask_l, tracks_l, knobs, keys_l)

        fn = jax.jit(jax.shard_map(
            f, mesh=mesh,
            in_specs=(P(None, "tp"), P("dp", "tp"), P("dp"), P("dp"),
                      P("dp"), P(), P("dp")),
            out_specs=P("dp"), check_vma=False))
        _decode_render_cache[key] = fn
    return fn


def render_batch_sharded(mesh, st: SynthStatic, knots, f0, mask, tracks,
                         knobs: dict | None = None, key=None, sr=None,
                         n_fft=None, n_bins=None):
    """Multi-chip batched render from knot-compressed envelopes.

    Shardings: note batch over 'dp'; the knot contraction axis over 'tp'
    (the decode einsum reduces over tp with an explicit psum inside
    shard_map — see _decode_and_render_sharded)."""
    sr = sr or st.sr
    n_fft = n_fft or st.n_fft
    n_bins = n_bins or (n_fft // 2 + 1)
    if key is None:
        key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, f0.shape[0])
    w = jnp.asarray(_decode_matrix(sr, n_fft, knots.shape[1]))

    # shard_map needs every sharded axis length divisible by its mesh
    # axis (GSPMD tolerated uneven shapes; shard_map errors opaquely —
    # ADVICE r4).  The knot contraction axis pads with zeros: a zero w
    # column times a zero knot row adds +0 to the log-space einsum sum,
    # so decode is exact.  The note batch can't be padded invisibly
    # (callers index outputs by note), so assert it with a clear error.
    tp = int(mesh.shape["tp"])
    if knots.shape[1] % tp:
        pad = tp - knots.shape[1] % tp
        knots = jnp.pad(knots, ((0, 0), (0, pad), (0, 0)))
        w = jnp.pad(w, ((0, 0), (0, pad)))
    dp = int(mesh.shape["dp"])
    if f0.shape[0] % dp:
        raise ValueError(
            f"note batch {f0.shape[0]} not divisible by the dp mesh "
            f"axis ({dp}); pad the batch (replicate a note and drop its "
            f"output) or pick a dp that divides it")

    def shard(x, spec):
        return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))

    w = shard(w, P(None, "tp"))
    knots = shard(knots, P("dp", "tp", None))
    f0 = shard(f0, P("dp", None))
    mask = shard(mask, P("dp", None))
    tracks = shard(tracks, P("dp", None, None))
    keys = shard(keys, P("dp", None))
    knobs_full = _full_knobs(knobs)

    fn = _decode_and_render_sharded(mesh, st, n_bins)
    return fn(w, knots, f0, mask, tracks, knobs_full, keys)


_sharded_render_cache: dict = {}


def render_notes_sharded(mesh, rs, axes: tuple, arrays: list,
                         scalars: dict, keys, batch_axes=("dp", "tp")):
    """Shard one phrase group's FULL fused note render (the flag chain +
    all synthesis layers, sampler/render_core.py) over a device mesh.

    Each note render is independent (SURVEY §2.6), so the note batch
    shards over every mesh axis in ``batch_axes`` with no collectives —
    this is the multi-chip production step for offline UST rendering.
    ``axes`` marks per-ARRAY_ORDER entries batched (0) or shared (None,
    replicated); the batch size must be divisible by the mesh size.

    Sharded via jax.shard_map, NOT GSPMD-from-input-shardings: the SPMD
    partitioner cannot partition the fft custom-call's batch dim and
    replicates every note's FFT work on every device (see
    _decode_and_render_sharded).  shard_map runs the per-shard program
    locally — zero collectives by construction, and bitwise-equal output
    to the single-device vmap (tests/test_parallel.py).
    """
    from goofer_tpu.sampler.render_core import render_note_core

    batch_spec = P(tuple(a for a in batch_axes if a in mesh.axis_names))
    key_fn = (rs, axes, mesh, batch_spec)
    fn = _sharded_render_cache.get(key_fn)
    if fn is None:
        core = partial(render_note_core, rs)
        vm = jax.vmap(core, in_axes=tuple(axes) + (0, 0))
        in_specs = tuple(batch_spec if a == 0 else P() for a in axes)
        fn = jax.jit(jax.shard_map(
            vm, mesh=mesh, in_specs=in_specs + (batch_spec, batch_spec),
            out_specs=batch_spec, check_vma=False))
        _sharded_render_cache[key_fn] = fn

    def shard(x, batched):
        x = jnp.asarray(x)
        spec = (P(*(batch_spec + (None,) * (x.ndim - 1)))
                if batched else P(*((None,) * x.ndim)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    args = [shard(a, ax == 0) for a, ax in zip(arrays, axes)]
    sc = {k: shard(v, True) for k, v in scalars.items()}
    keys = shard(keys, True)
    return fn(*args, sc, keys)
