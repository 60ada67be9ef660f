""".goofy feature-bundle I/O, byte-compatible with the reference format.

A `.goofy` file is a compressed NPZ next to each source WAV
(ref: GOOFER.py:287-339).  Two modes:

* ``knots``: keys mode, knot_vals_log (fp16), hz_knots (fp32), n_bins,
  n_fft, env_sr, f0_interp (fp16, per-sample), voicing_mask (fp16,
  per-sample), formants (pickled dict {1..4: array}), sr, y_len.
* ``full``: keys mode, env_spec (fp16) and the same track keys plus an
  n_fft derived from the bin count.

Files written by the reference load here and vice versa — this cache is the
system's checkpoint/resume story (extract once, reuse forever).
"""
from __future__ import annotations

import os

import numpy as np

from goofer_tpu.config import STORAGE_DTYPE, COMPUTE_DTYPE


def formants_to_int_keys(d) -> dict:
    """Canonicalize a formant dict to integer keys 1..4, zero-filling missing
    tracks (ref: GOOFER.py:48-62)."""
    out = {}
    if isinstance(d, dict):
        for k, v in d.items():
            key = k
            if isinstance(key, str) and key.upper().startswith("F"):
                try:
                    key = int(key[1:])
                except Exception:
                    continue
            if isinstance(key, (int, np.integer)) and 1 <= int(key) <= 4:
                out[int(key)] = np.asarray(v)
    for i in (1, 2, 3, 4):
        if i not in out:
            out[i] = np.zeros(1, dtype=np.float64)
    return out


def pad_trim_to_len(x, length: int) -> np.ndarray:
    """Edge-pad or truncate a 1-D track to ``length`` (ref: GOOFER.py:64-70)."""
    x = np.asarray(x, dtype=np.float64)
    if x.size < length:
        if x.size == 0:
            return np.zeros(length, dtype=np.float64)
        return np.pad(x, (0, length - x.size), mode="edge")
    return x[:length]


def _savez_fast(fobj, **arrays) -> None:
    """npz writer at deflate level 1: np.savez_compressed hardwires
    zlib level 6, which cost half the warm folder-extraction wall clock
    at voicebank scale on a single host core.  Level 1 compresses these
    f16 payloads to within ~2% of the level-6 size at half the time;
    the output is a standard
    npz (np.load reads it unchanged, upstream included)."""
    import io
    import zipfile

    with zipfile.ZipFile(fobj, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=1) as z:
        for name, arr in arrays.items():
            b = io.BytesIO()
            np.lib.format.write_array(b, np.asarray(arr),
                                      allow_pickle=True)
            z.writestr(name + ".npy", b.getvalue())


def save_features(path, features, f0_interp, voicing_mask, formants, sr,
                  y_len) -> None:
    """Write a .goofy bundle (ref: GOOFER.py:287-317)."""
    with open(path, "wb") as f:
        if isinstance(features, dict) and features.get("mode") == "knots":
            _savez_fast(
                f,
                mode=np.array(["knots"]),
                knot_vals_log=np.asarray(features["knot_vals_log"],
                                         dtype=STORAGE_DTYPE),
                hz_knots=np.asarray(features["hz_knots"],
                                    dtype=COMPUTE_DTYPE),
                n_bins=np.array([features["n_bins"]], dtype=np.int32),
                n_fft=np.array([features["n_fft"]], dtype=np.int32),
                env_sr=np.array([features["sr"]], dtype=np.int32),
                f0_interp=np.asarray(f0_interp).astype(STORAGE_DTYPE),
                voicing_mask=np.asarray(voicing_mask).astype(STORAGE_DTYPE),
                formants=formants_to_int_keys(formants),
                sr=np.array([sr], dtype=np.int32),
                y_len=np.array([y_len], dtype=np.int64),
            )
        else:
            env_spec = np.asarray(features, dtype=STORAGE_DTYPE)
            _savez_fast(
                f,
                mode=np.array(["full"]),
                env_spec=env_spec,
                f0_interp=np.asarray(f0_interp).astype(STORAGE_DTYPE),
                voicing_mask=np.asarray(voicing_mask).astype(STORAGE_DTYPE),
                formants=formants_to_int_keys(formants),
                sr=np.array([sr], dtype=np.int32),
                y_len=np.array([y_len], dtype=np.int64),
                n_fft=np.array([env_spec.shape[0] * 2 - 2], dtype=np.int32),
            )


def save_features_atomic(path, *args, **kwargs) -> None:
    """Atomic variant: write to .tmp then os.replace
    (ref: SillyEditor.py:540-542)."""
    tmp = str(path) + ".tmp"
    save_features(tmp, *args, **kwargs)
    os.replace(tmp, str(path))


def load_features(path):
    """Load a .goofy bundle (ref: GOOFER.py:319-339).

    Returns (env_spec_or_knotpack, f0_interp, voicing_mask, formants, sr,
    y_len); knots mode returns the pack dict for later device decode.
    """
    data = np.load(path, allow_pickle=True)
    mode = str(data["mode"][0])
    if mode == "knots":
        env = {
            "mode": "knots",
            "knot_vals_log": data["knot_vals_log"],
            "hz_knots": data["hz_knots"],
            "n_bins": int(data["n_bins"][0]),
            "n_fft": int(data["n_fft"][0]),
            "sr": int(data["env_sr"][0]),
        }
    else:
        env = np.asarray(data["env_spec"], dtype=COMPUTE_DTYPE)
    f0_interp = np.asarray(data["f0_interp"], dtype=COMPUTE_DTYPE)
    voicing_mask = np.asarray(data["voicing_mask"], dtype=COMPUTE_DTYPE)
    formants = formants_to_int_keys(data["formants"].item())
    sr = int(data["sr"][0])
    y_len = int(data["y_len"][0])
    return env, f0_interp, voicing_mask, formants, sr, y_len
