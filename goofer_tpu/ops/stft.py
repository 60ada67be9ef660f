"""STFT / iSTFT with sqrt-Hann windows and win^2-normalized overlap-add.

Matches the reference's framing contract (ref: GOOFER.py:355-413):

* analysis: center reflect-pad by n_fft//2 (edge-pad for inputs shorter than
  2 samples), strided frames, sqrt-Hann window, rfft over the frame axis;
  frame count = max(1, 1 + (len(padded) - n_fft) // hop).
* synthesis: irfft per frame, windowed overlap-add normalized by the
  accumulated squared window (skipping bins where the accumulation is ~0),
  center trim, then pad/cut to the requested length.

Gather-free formulation: when hop divides n_fft (all call sites use
n_fft/hop = 4) framing and OLA avoid gathers/scatters entirely — the signal
is reshaped into hop-sized chunks and frames become R = n_fft//hop shifted
views; OLA is R dense shifted adds.  The win^2 normalizer is data-independent
and precomputed in NumPy at trace time.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from goofer_tpu.ops.windows import sqrt_hann_window


def frame_count(n_samples: int, n_fft: int, hop: int) -> int:
    pad = n_fft // 2
    padded = n_samples + 2 * pad
    if padded < n_fft:
        padded = n_fft
    return max(1, 1 + (padded - n_fft) // hop)


def _frame_signal(x_padded: jnp.ndarray, n_fft: int, hop: int,
                  num_frames: int) -> jnp.ndarray:
    """Return frames of shape (n_fft, num_frames)."""
    if n_fft % hop == 0:
        r = n_fft // hop
        needed = (num_frames + r - 1) * hop
        if x_padded.shape[0] < needed:
            x_padded = jnp.pad(x_padded, (0, needed - x_padded.shape[0]))
        else:
            x_padded = x_padded[:needed]
        chunks = x_padded.reshape(num_frames + r - 1, hop)  # C[m, q]
        parts = [chunks[i:i + num_frames].T for i in range(r)]  # (hop, T) each
        return jnp.concatenate(parts, axis=0)
    # General fallback: gather.
    idx = (jnp.arange(num_frames)[None, :] * hop
           + jnp.arange(n_fft)[:, None])
    needed = (num_frames - 1) * hop + n_fft
    if x_padded.shape[0] < needed:
        x_padded = jnp.pad(x_padded, (0, needed - x_padded.shape[0]))
    return x_padded[idx]


def stft(x: jnp.ndarray, n_fft: int, hop: int,
         window: np.ndarray | None = None) -> jnp.ndarray:
    """Complex STFT of a 1-D signal; returns (n_fft//2 + 1, num_frames)."""
    if window is None:
        window = sqrt_hann_window(n_fft)
    x = jnp.asarray(x, dtype=jnp.float32)
    n = x.shape[0]
    pad = n_fft // 2
    mode = "reflect" if n >= 2 else "edge"
    x_padded = jnp.pad(x, pad, mode=mode)
    if x_padded.shape[0] < n_fft:
        x_padded = jnp.pad(x_padded, (0, n_fft - x_padded.shape[0]),
                           mode="edge")
    num_frames = frame_count(n, n_fft, hop)
    frames = _frame_signal(x_padded, n_fft, hop, num_frames)
    frames = frames * jnp.asarray(window, dtype=jnp.float32)[:, None]
    return jnp.fft.rfft(frames, axis=0)


@functools.lru_cache(maxsize=None)
def _win_sum_sq(n_fft: int, hop: int, num_frames: int,
                expected_len: int) -> np.ndarray:
    """Accumulated window^2 across overlapped frames (NumPy, trace-time)."""
    window = sqrt_hann_window(n_fft).astype(np.float64)
    acc = np.zeros(expected_len, dtype=np.float64)
    w2 = window * window
    for t in range(num_frames):
        acc[t * hop: t * hop + n_fft] += w2
    return acc.astype(np.float32)


def istft(S: jnp.ndarray, hop: int, window: np.ndarray | None = None,
          length: int | None = None) -> jnp.ndarray:
    """Inverse STFT with windowed win^2-normalized overlap-add."""
    n_fft = (S.shape[0] - 1) * 2
    if window is None:
        window = sqrt_hann_window(n_fft)
    window = jnp.asarray(window, dtype=jnp.float32)
    num_frames = S.shape[1]
    frames = jnp.fft.irfft(S, axis=0, n=n_fft).astype(jnp.float32)
    frames = frames * window[:, None]

    pad = n_fft // 2
    expected_len = n_fft + hop * (num_frames - 1)

    if n_fft % hop == 0:
        r = n_fft // hop
        y = jnp.zeros(expected_len, dtype=jnp.float32)
        for i in range(r):
            seg = frames[i * hop:(i + 1) * hop, :].T.reshape(-1)
            y = y.at[i * hop: i * hop + num_frames * hop].add(seg)
    else:
        idx = (jnp.arange(num_frames)[None, :] * hop
               + jnp.arange(n_fft)[:, None])
        y = jnp.zeros(expected_len, dtype=jnp.float32).at[idx.reshape(-1)].add(
            frames.reshape(-1))

    win_sum = _win_sum_sq(n_fft, hop, num_frames, expected_len)
    denom = jnp.asarray(np.where(win_sum > 1e-9, win_sum, 1.0))
    y = y / denom

    y = y[pad: expected_len - pad]
    if length is not None:
        cur = y.shape[0]
        if cur < length:
            y = jnp.pad(y, (0, length - cur))
        else:
            y = y[:length]
    return y
