"""Global configuration for goofer_tpu.

Dtype policy mirrors the reference engine's split between compact storage and
full-precision math (ref: GOOFER.py:7-8): features persisted to `.goofy` files
are float16, all on-device compute is float32: the pipeline is elementwise-
and FFT-bound, not matmul-bound, and LSD parity with the CPU reference is part
of the contract.  f32 products ask for HIGHEST precision, so a GPU does not
run them in TF32; bfloat16 is available as an opt-in for the envelope matmul.
"""
from __future__ import annotations

import os

import numpy as np

# Storage dtype for .goofy feature files (ref: GOOFER.py:7).
STORAGE_DTYPE = np.float16
# Compute dtype for all device math (ref: GOOFER.py:8).
COMPUTE_DTYPE = np.float32
# Opt-in dtype for the mel-knot envelope-decode matmul — the one real
# matmul in the pipeline.  bfloat16 halves its memory traffic at <1e-2 relative
# envelope error (the knots are stored fp16 anyway); set
# GOOFER_TPU_ENVELOPE_MATMUL_DTYPE=bfloat16 to enable.
ENVELOPE_MATMUL_DTYPE = os.environ.get(
    "GOOFER_TPU_ENVELOPE_MATMUL_DTYPE", "float32")

# Frame parameters used by the resampler CLI (ref: SillySampler.py:14-15).
SAMPLER_N_FFT = 1024
SAMPLER_HOP = SAMPLER_N_FFT // 4

# Engine self-test defaults (ref: GOOFER.py:1262-1263).
ENGINE_N_FFT = 2048
ENGINE_HOP = ENGINE_N_FFT // 4

# Voicing threshold: f0 above this many Hz counts as voiced
# (ref: GOOFER.py:941-943, 966).
VOICING_THRESHOLD_HZ = 75.0

# f0 clipping range applied after per-sample interpolation
# (ref: GOOFER.py:964).
F0_CLIP_LO = 1e-5
F0_CLIP_HI = 2000.0

# LF glottal model constants used by the main pulse train
# (ref: GOOFER.py:1074 call site).
PULSE_RA = 0.02
PULSE_RG = 1.7
PULSE_RK = 0.8

# Period clamp for the pulse-train generator, in samples
# (ref: GOOFER.py:496-499).
PULSE_T0_MIN = 3
PULSE_T0_MAX = 8192

# Maximum number of simultaneously-overlapping pulse generations the
# pulse-train generator sums per output sample.  The reference scatters
# pulses of arbitrary overlap; overlap beyond this bound only occurs for
# pathological f0 trajectories (e.g. extreme growl noise) and contributes
# only low-amplitude pulse tails.
PULSE_MAX_OVERLAP = 16

# Fallback f0 used by the pulse train before the first voiced sample
# (ref: GOOFER.py:481).
PULSE_FALLBACK_F0 = 160.0

# HTTP server port for the resampler server mode (ref: SillySampler.py:1220).
SERVER_PORT = 8572

VERSION = "0.1.1"  # bump on ANY traced-graph change: the AOT blob store
                   # (utils/aot.py) keys on this, not on source text
# Version string of the reference CLI surface we reproduce
# (ref: SillySampler.py:1226).
REFERENCE_CLI_VERSION = "v2.6.1"


# Floor of 8: a 4-vs-8 split doubled the compiled-graph count across a
# pitch-diverse phrase for a negligible pulse-compute saving.
PULSE_OVERLAP_BUCKETS = (8, 16, 32)


def bucket_overlap(k: int) -> int:
    """Round a pulse-overlap bound up to a bucket so nearby notes share
    compiled graphs (K is a static shape-like parameter)."""
    for b in PULSE_OVERLAP_BUCKETS:
        if k <= b:
            return b
    return PULSE_OVERLAP_BUCKETS[-1]


# Assumed minimum pulse-onset spacing (samples): sizes the compact onset
# tables (m = n / spacing) and the per-block slab gathers.  The default
# 16 covers f0 up to ~2.75 kHz at 44.1 kHz; when the host knows the
# note's f0 ceiling it rounds sr/f0_ceil DOWN to a bucket, so typical
# pitches gather ~4-8x fewer table rows and extreme ones (heavy jitter
# at high f0) drop to 8 instead of silently losing pulses.
PULSE_MIN_SPACING = 16
PULSE_MIN_SPACING_BUCKETS = (8, 16, 32, 64, 128, 256)


def bucket_min_spacing(s: int) -> int:
    """Round an onset-spacing bound DOWN to a bucket (smaller is always
    safe — it only grows the tables).  Bounds below 8 (f0 ceilings past
    ~5.5 kHz — beyond any vocal range) clamp to 8."""
    out = PULSE_MIN_SPACING_BUCKETS[0]
    for b in PULSE_MIN_SPACING_BUCKETS:
        if b <= s:
            out = b
    return out


def bucket_len(n: int, base: int = 4096, ratio: float = 1.5,
               quantum: int = 1024) -> int:
    """Round a sample count up to a geometric length bucket (~ratio step,
    quantized), so arbitrary note geometries share a handful of compiled
    graphs.  Padding costs only masked device compute — the batcher
    slices outputs back to true extents on device before fetching."""
    b = base
    while b < n:
        b = -(-int(b * ratio) // quantum) * quantum
    return b


def bucket_frames(n_bucket: int, hop: int) -> int:
    """Envelope-frame bucket derived from a sample bucket: covers any true
    frame count a note of <= n_bucket samples can produce (+margin), so a
    (sample bucket, frame bucket) pair never splits a graph signature."""
    return n_bucket // hop + 8


def bucket_batch(b: int) -> int:
    """Round a note-batch size up to a bucket (vmap batch is a static
    shape; padded rows are sliced off on device before fetch).  The
    series is denser above 8 (steps of ~1.25x instead of 1.5x) so a
    17-note group pads to 20 rows, not 24 — batch padding is pure wasted
    device compute (VERDICT r1 item 6)."""
    b = int(b)
    p = 1 << max(0, b.bit_length() - 2)      # largest pow2 with 4p >= ...
    cands = {p, 2 * p, 3 * p, 4 * p, 6 * p, 8 * p}
    if p >= 8:
        cands.update({(5 * p) // 4, (5 * p) // 2, 5 * p})
    for cand in sorted(cands):
        if cand >= b:
            return cand
    return 8 * p
