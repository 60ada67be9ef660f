"""Device-mesh helpers.

The reference's only parallelism is a CPU thread pool over files
(ref: SillySampler.py:235-238); each note render is embarrassingly
parallel.  The device equivalent is data parallelism over a note batch,
sharded over a device mesh via jax.sharding; the mel-knot envelope
decode — the one real matmul in the pipeline — additionally shards its
contraction axis over a tensor axis so the multi-device path exercises
genuine collectives (psum over the knot axis).
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None,
              axis_names=("dp", "tp"),
              tp: int = 1) -> Mesh:
    """Mesh over available devices: ('dp', 'tp') with tp given and
    dp = n_devices // tp."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if n % tp != 0:
        raise ValueError(f"tp={tp} does not divide device count {n}")
    dp = n // tp
    dev_array = np.array(devices[:n]).reshape(dp, tp)
    return Mesh(dev_array, axis_names)
