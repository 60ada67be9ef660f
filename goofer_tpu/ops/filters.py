"""Gaussian smoothing as static-kernel convolution.

Matches the reference's hand-rolled ``gaussian_filter1d`` semantics
(ref: GOOFER.py:241-261): kernel radius ``int(truncate * sigma + 0.5)``,
normalized Gaussian taps, reflect padding, 'valid' convolution.

Sigma is always a host-side (static) float here, so the kernel is a
compile-time constant.  Small kernels lower to a direct conv;
large kernels (long smoothing windows over per-sample tracks) use FFT
convolution, which XLA executes as a few rfft/irfft ops instead of a
multi-thousand-tap sliding window.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Direct conv only when taps * length is small, FFT with pow2 padding
# otherwise: on the accelerator these bounds were tuned for, direct-conv
# compile time grew superlinearly in taps * length.  Not yet measured on
# XLA:GPU (ROADMAP.md).
_DIRECT_CONV_MAX_WORK = 120_000   # taps * length
_DIRECT_CONV_MAX_TAPS = 33


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


@functools.lru_cache(maxsize=None)
def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Normalized Gaussian taps; radius = int(truncate*sigma + 0.5)."""
    radius = int(truncate * float(sigma) + 0.5)
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (t / float(sigma)) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


def fft_conv_valid(x2d: jnp.ndarray, kernel, ksize: int | None = None
                   ) -> jnp.ndarray:
    """'valid' FFT convolution of each (B, L) row with a symmetric kernel.

    The FFT size is padded to a power of two, whose FFT plans compile and
    run fastest.  Circular wraparound only corrupts full-conv indices
    < ksize-1, which the valid slice skips.
    """
    kernel = jnp.asarray(kernel, dtype=x2d.dtype)
    if ksize is None:
        ksize = kernel.shape[0]
    length = x2d.shape[-1]
    out_len = length - ksize + 1
    nfft = _next_pow2(length)
    kf = jnp.fft.rfft(kernel, n=nfft)
    xf = jnp.fft.rfft(x2d, n=nfft, axis=-1)
    full = jnp.fft.irfft(xf * kf[None, :], n=nfft, axis=-1)
    # 'full' conv index k maps to valid index k - (ksize - 1)
    return jax.lax.dynamic_slice_in_dim(full, ksize - 1, out_len, axis=-1)


def _conv_valid_lastaxis(x2d: jnp.ndarray, kernel: np.ndarray) -> jnp.ndarray:
    """'valid' correlation of each row of (B, L) with a symmetric kernel."""
    ksize = kernel.shape[0]
    length = int(x2d.shape[-1])
    if (ksize > _DIRECT_CONV_MAX_TAPS
            or ksize * length > _DIRECT_CONV_MAX_WORK):
        return fft_conv_valid(x2d, kernel, ksize)
    # Direct path: depthwise 1-D convolution.  Gaussian is symmetric so
    # correlation == convolution.
    lhs = x2d[:, None, :]  # (batch, chan=1, length)
    rhs = jnp.asarray(kernel, dtype=x2d.dtype)[None, None, :]  # (out_c, in_c, k)
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, 0, :]


def gaussian_blur1d(x: jnp.ndarray, sigma: float, axis: int = -1,
                    truncate: float = 4.0) -> jnp.ndarray:
    """Gaussian blur along ``axis`` with reflect padding (static sigma)."""
    if sigma is None or float(sigma) <= 0.0:
        return x
    kernel = gaussian_kernel1d(float(sigma), truncate)
    radius = (kernel.shape[0] - 1) // 2
    if radius <= 0:
        return x
    x = jnp.asarray(x)
    moved = jnp.moveaxis(x, axis, -1)
    shape = moved.shape
    flat = moved.reshape((-1, shape[-1]))
    pad_spec = [(0, 0), (radius, radius)]
    padded = jnp.pad(flat, pad_spec, mode="reflect")
    out = _conv_valid_lastaxis(padded, kernel)
    out = out.reshape(shape)
    return jnp.moveaxis(out, -1, axis)


def gaussian_blur1d_traced(x: jnp.ndarray, sigma, max_sigma: float,
                           axis: int = -1,
                           truncate: float = 4.0) -> jnp.ndarray:
    """Gaussian blur with a TRACED sigma (universal fallback graph).

    The window is static (radius from ``max_sigma``); taps are computed
    in-graph and zeroed beyond the reference's own radius
    ``int(truncate*sigma + 0.5)``, so for any sigma <= max_sigma the
    effective kernel equals gaussian_kernel1d(sigma) exactly (the extra
    window positions contribute exact zeros).  sigma <= 0 selects a
    delta kernel — exact identity."""
    radius = int(truncate * float(max_sigma) + 0.5)
    if radius <= 0:
        return x
    t = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    sig = jnp.maximum(jnp.asarray(sigma, jnp.float32), 1e-6)
    k = jnp.exp(-0.5 * (t / sig) ** 2)
    ref_radius = jnp.floor(truncate * sig + 0.5)
    k = jnp.where(jnp.abs(t) <= ref_radius, k, 0.0)
    k = k / jnp.sum(k)
    delta = (t == 0).astype(jnp.float32)
    k = jnp.where(jnp.asarray(sigma, jnp.float32) > 0.0, k, delta)

    x = jnp.asarray(x)
    moved = jnp.moveaxis(x, axis, -1)
    shape = moved.shape
    flat = moved.reshape((-1, shape[-1]))
    padded = jnp.pad(flat, [(0, 0), (radius, radius)], mode="reflect")
    ksize = 2 * radius + 1
    length = int(padded.shape[-1])
    if (ksize > _DIRECT_CONV_MAX_TAPS
            or ksize * length > _DIRECT_CONV_MAX_WORK):
        out = fft_conv_valid(padded, k, ksize)
    else:
        lhs = padded[:, None, :]
        rhs = k.astype(padded.dtype)[None, None, :]
        out = jax.lax.conv_general_dilated(
            lhs, rhs, window_strides=(1,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            precision=jax.lax.Precision.HIGHEST)[:, 0, :]
    return jnp.moveaxis(out.reshape(shape), -1, axis)


def gaussian_blur_freq(env: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Blur a (n_bins, T) spectrogram-like array along the frequency axis."""
    return gaussian_blur1d(env, sigma, axis=0)


def gaussian_blur_complex_freq(S: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Frequency-axis blur of a complex spectrogram: blur re/im separately.

    The reference calls its real-valued gaussian_filter on complex data when
    smoothing voiced columns (ref: GOOFER.py:1143); numpy convolution then
    operates on complex values, equivalent to blurring parts independently.
    """
    re = gaussian_blur1d(jnp.real(S), sigma, axis=0)
    im = gaussian_blur1d(jnp.imag(S), sigma, axis=0)
    return jax.lax.complex(re, im)


def smooth_mask_downsampled(mask: jnp.ndarray, sigma: float = 100.0,
                            ds: int = 4) -> jnp.ndarray:
    """Soft voiced/unvoiced crossfade (ref: GOOFER.py:556-569).

    Downsample by ``ds``, blur with sigma/ds (floored at 1), then linearly
    resample back to the original length over a shared [0, 1] axis.
    """
    from goofer_tpu.ops.interp import resample_1d

    n = mask.shape[0]
    if ds > 1:
        short = mask[::ds].astype(jnp.float32)
    else:
        short = mask.astype(jnp.float32)
    sig_short = max(1.0, float(sigma) / max(1, ds))
    short_s = gaussian_blur1d(short, sig_short)
    if ds > 1:
        return resample_1d(short_s, n).astype(jnp.float32)
    return short_s.astype(jnp.float32)
