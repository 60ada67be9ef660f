"""First-order IIR recurrences as associative scans.

The reference implements these as sequential Numba loops
(one_pole_highpass: GOOFER.py:877-892, _dynamic_butter_filter_core:
SillySampler.py:118-174).  A first-order filter, even with time-varying
coefficients, is the affine recurrence

    y[i] = a[i] * y[i-1] + b[i]

whose solution is an associative composition of affine maps, so it runs in
log-depth via ``jax.lax.associative_scan`` instead of one step per sample.
Higher "orders" in the reference are literal re-application of the same
one-pole pass, so an order-N cascade is N scans.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _affine_combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def first_order_recurrence(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve y[i] = a[i]*y[i-1] + b[i] with y[-1] = 0, vectorized.

    General path: one associative scan over affine maps (log-depth, but
    every level re-streams the full (a, b) pair through device memory,
    and the reference's "order-6" filters re-apply it six times)."""
    _, y = jax.lax.associative_scan(_affine_combine, (a, b))
    return y


_BLOCK = 32


def first_order_recurrence_pos(a: jnp.ndarray, b: jnp.ndarray
                               ) -> jnp.ndarray:
    """first_order_recurrence for STRICTLY POSITIVE a[i] (every filter
    here: LP decay 1-alpha and HP alpha both live in (0, 1)).

    Blocked two-pass formulation: within 32-sample blocks the solution
    is y[j] = P[j]*(carry + sum(b[k]/P[k])) with P the running
    coefficient product, computed via log-domain NATIVE cumsums; block
    carries compose through one tiny affine scan over n/32 elements.
    Replaces 15 full-length scan levels with ~3 elementwise passes.

    Block size bounds the dynamic range: |log a| <= 1.35 at the 0.45*sr
    cutoff ceiling, so exp spans at most e^43 per block — inside f32.
    Early-sample contributions lose relative precision only where they
    are attenuated by the same factor, so absolute error stays ~1e-6.

    The n/32 block carries compose through a ROLLED ``lax.scan``
    (unroll 8), not an associative scan: the log-depth odd/even
    recursion of ``associative_scan`` emits its body once per level for
    every recurrence, and the heavy 11-flag phrase graph holds dozens of
    recurrences, so the rolled scan keeps the generated code and the
    compile small.  The carry chain is ~0.1% of the recurrence's work.
    The 32-sample block and unroll 8 were tuned for another accelerator
    and are not yet measured on the GPU (ROADMAP.md).
    """
    n = a.shape[0]
    m = -(-n // _BLOCK)
    pad = m * _BLOCK - n
    a_p = jnp.pad(a, (0, pad), constant_values=1.0).reshape(m, _BLOCK)
    b_p = jnp.pad(b, (0, pad)).reshape(m, _BLOCK)

    logp = jnp.cumsum(jnp.log(a_p), axis=1)
    p = jnp.exp(logp)
    y_local = p * jnp.cumsum(b_p / p, axis=1)   # block-local, zero carry

    # carry into block k = recurrence solution over whole blocks:
    # y_end[k] = prod(a_blk[k]) * y_end[k-1] + y_local_end[k]
    a_blk = p[:, -1]
    b_blk = y_local[:, -1]

    def _step(c, ab):
        c = ab[0] * c + ab[1]
        return c, c

    _, y_end = jax.lax.scan(_step, jnp.zeros((), a_blk.dtype),
                            (a_blk, b_blk), unroll=min(8, m))
    carry = jnp.concatenate([jnp.zeros((1,), y_end.dtype), y_end[:-1]])

    y = y_local + p * carry[:, None]
    return y.reshape(-1)[:n]


def one_pole_highpass(x: jnp.ndarray, sr: float, fc: float) -> jnp.ndarray:
    """Static one-pole highpass: y[i] = a*(y[i-1] + x[i] - x[i-1]),
    a = rc/(rc + 1/sr), rc = 1/(2*pi*fc) (ref: GOOFER.py:877-892)."""
    if fc <= 0:
        return jnp.zeros_like(x)
    rc = 1.0 / (2.0 * jnp.pi * fc)
    a = jnp.float32(rc / (rc + 1.0 / sr))
    x = jnp.asarray(x, dtype=jnp.float32)
    dx = jnp.diff(x, prepend=0.0)
    a_vec = jnp.full_like(x, a)
    return first_order_recurrence_pos(a_vec, a * dx)


def dynamic_one_pole_cascade(x: jnp.ndarray, fc: jnp.ndarray, sr: float,
                             order: int, btype: str,
                             n_active=None) -> jnp.ndarray:
    """Time-varying one-pole LP/HP applied ``order`` times sequentially,
    matching the reference core loop (ref: SillySampler.py:118-174).

    LP pass:  y[i] = y[i-1] + alpha[i]*(x[i] - y[i-1]),
              alpha = 2*pi*fc / (2*pi*fc + sr)
    HP pass:  y[i] = alpha[i]*(y[i-1] + x[i] - x[i-1]),  prev_x init = x[0]
              alpha = sr / (2*pi*fc + sr)

    ``n_active`` (traced scalar, universal fallback graph): sections
    k >= n_active pass their input through unchanged via a select —
    ``order`` becomes the static MAXIMUM and the effective order is
    traced, exactly reproducing the specialized graph's cascade depth.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    two_pi = 2.0 * jnp.pi
    if btype == "lowpass":
        alpha = (two_pi * fc) / (two_pi * fc + sr)
    elif btype == "highpass":
        alpha = sr / (two_pi * fc + sr)
    else:
        raise ValueError(f"unknown btype {btype!r}")
    alpha = alpha.astype(jnp.float32)

    k = max(1, int(order))

    def _stage(y, s):
        if btype == "lowpass":
            y_f = first_order_recurrence_pos(1.0 - alpha, alpha * y)
        else:
            dx = jnp.diff(y, prepend=y[0:1][0])
            y_f = first_order_recurrence_pos(alpha, alpha * dx)
        if n_active is not None:
            y_f = jnp.where(s < n_active, y_f, y)
        return y_f, None

    if k == 1:
        y, _ = _stage(x, 0)
        return y
    # rolled over stages: the recurrence body (log-cumsum blocks +
    # carry chain) is emitted ONCE per cascade instead of k times --
    # the heavy graph holds ~14 cascades of order 4-6, so the unrolled
    # form duplicated that body ~60-80x in the generated code.
    y, _ = jax.lax.scan(_stage, x, jnp.arange(k))
    return y


def dynamic_butter_filter(signal: jnp.ndarray, f0: jnp.ndarray, sr: float,
                          cutoff_factor: float, order: int = 4,
                          btype: str = "lowpass",
                          n_active=None) -> jnp.ndarray:
    """F0-tracking cascaded one-pole filter (ref: SillySampler.py:95-115).

    Per-sample cutoff = f0 * cutoff_factor where f0 > 0, else the raw
    cutoff_factor (interpreted as Hz); floors 60 Hz (LP) / 20 Hz (HP);
    ceiling 0.45*sr.  f0 gets a 5-tap moving-average smooth when any
    sample is voiced.  ``n_active`` makes the cascade depth traced (see
    dynamic_one_pole_cascade).
    """
    from goofer_tpu.ops.interp import resample_1d

    x = jnp.asarray(signal, dtype=jnp.float32)
    n = x.shape[0]
    if n == 0:
        return x
    f0 = jnp.asarray(f0, dtype=jnp.float32)
    if f0.shape[0] != n:
        f0 = resample_1d(f0, n)

    k = 5
    pad = k // 2
    padded = jnp.pad(f0, (pad, pad), mode="edge")
    kernel = jnp.ones((k,), dtype=jnp.float32) / k
    smoothed = jnp.convolve(padded, kernel, mode="valid",
                            precision=jax.lax.Precision.HIGHEST)
    f0_s = jnp.where(jnp.any(f0 > 0), smoothed, f0)

    fc = jnp.where(f0_s > 0.0, f0_s * cutoff_factor, cutoff_factor)
    floor = 60.0 if btype == "lowpass" else 20.0
    fc = jnp.clip(fc, floor, 0.45 * sr)
    return dynamic_one_pole_cascade(x, fc, sr, order, btype,
                                    n_active=n_active)
