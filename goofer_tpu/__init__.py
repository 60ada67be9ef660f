"""goofer_tpu — a JAX singing-voice analysis/resynthesis framework.

Rebuilds the capabilities of MLo7Ghinsan/GOOFER (harmonic-plus-noise
vocoder + UTAU/OpenUtau resampler CLI + voicing editor) as an idiomatic
JAX/XLA stack: the whole analysis -> transform -> resynthesis graph traces
into jitted XLA programs, sequential reference kernels become scans and
bounded-overlap gathers, and note batches scale over device meshes with
jax.sharding.

Library surface (GOOFER.py-compatible, see goofer_tpu.models.hnm):
    extract_features, synthesize, save_features, load_features
CLI surface (SillySampler-compatible): python -m goofer_tpu.cli
"""
from goofer_tpu.config import VERSION as __version__

from goofer_tpu.models.hnm import extract_features, synthesize
from goofer_tpu.io.goofy import (
    save_features,
    load_features,
    formants_to_int_keys,
    pad_trim_to_len,
)

__all__ = [
    "__version__",
    "extract_features",
    "synthesize",
    "save_features",
    "load_features",
    "formants_to_int_keys",
    "pad_trim_to_len",
]
