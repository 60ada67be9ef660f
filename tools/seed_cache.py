"""Seed the persistent XLA compilation cache with the standard graph
ladder (VERDICT r3 item 2: the first-run story).

The reference pays ~seconds of Numba JIT on first run
(ref: GOOFER.py:1224, test.py:6); cold XLA compiles of the full graph
ladder take far longer.  The persistent compilation cache
(utils/compile_cache.py) already makes the SECOND run on a machine
fast — this tool is the install-time step that makes the FIRST server
start / bench fast too: run it once after installing (or bake its
output into the shipped image) and every later process deserializes the
ladder instead of compiling it.

What gets seeded (superset of the server's background warmup):
- the feature-extraction/analysis graphs at each warmed sample rate
- one tiny end-to-end note render (the plain specialized graph)
- the universal fallback ladder: WARM_NOTE_SECONDS x WARM_SAMPLE_RATES
- with --bench: the phrase-renderer graphs bench.py dispatches

Because this runs with the AOT store enabled (utils/aot.py, default on),
it also writes each graph's exported StableHLO blob, so later processes
skip Python tracing as well as compilation — the full warm-process
story.

Cache relocatability: entries are keyed on (serialized HLO, XLA backend
version, compile flags, device kind) — they hit on any machine running
the same jaxlib + runtime against the same device kind, so a cache
seeded on one machine is valid on another with the same card.  Set
JAX_COMPILATION_CACHE_DIR to a shared/shipped directory to relocate it.

Usage:  python tools/seed_cache.py [--bench] [--sr 44100 --sr 48000]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _dir_size_mb(path: str) -> float:
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total / 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", action="store_true",
                    help="also seed the phrase-renderer graphs bench.py uses")
    ap.add_argument("--sr", action="append", type=int, default=None,
                    help="sample rate(s) to seed (default: the warm ladder's)")
    args = ap.parse_args()

    t0 = time.perf_counter()

    from goofer_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax

    cache_dir = jax.config.jax_compilation_cache_dir
    size0 = _dir_size_mb(cache_dir) if cache_dir else 0.0
    print(f"cache dir: {cache_dir} ({size0:.1f} MB before)", flush=True)
    print(f"devices: {jax.devices()}", flush=True)

    from goofer_tpu.sampler.resampler import (
        WARM_SAMPLE_RATES,
        GooferResampler,
        warm_universal,
    )
    from goofer_tpu.utils.audio_io import write_wav

    srs = tuple(args.sr) if args.sr else WARM_SAMPLE_RATES
    tmp = tempfile.mkdtemp(prefix="goofer_seed_")

    for sr in srs:
        # analysis graphs + one tiny end-to-end specialized render
        t1 = time.perf_counter()
        src = os.path.join(tmp, f"w{sr}.wav")
        t = np.arange(int(0.4 * sr)) / sr
        y = 0.3 * np.sign(np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
        write_wav(src, y, sr)
        GooferResampler(src, os.path.join(tmp, f"out{sr}.wav"), "C4", 100,
                        "", 0, 300, 60, 0, 100, 0, "!120", "AA")
        print(f"[{time.perf_counter() - t0:6.1f}s] sr={sr}: analysis + "
              f"tiny render seeded ({time.perf_counter() - t1:.1f}s)",
              flush=True)

        # the universal fallback ladder
        t1 = time.perf_counter()
        n = warm_universal(sr=sr)
        print(f"[{time.perf_counter() - t0:6.1f}s] sr={sr}: universal "
              f"ladder seeded ({n} graphs, {time.perf_counter() - t1:.1f}s)",
              flush=True)

    if args.bench:
        t1 = time.perf_counter()
        from bench import _make_voicebank_sample
        from goofer_tpu.sampler.phrase import NoteSpec, render_phrase

        src = os.path.join(tmp, "bench_src.wav")
        _make_voicebank_sample(src, 44100)
        scale = ["C4", "D4", "E4", "F4", "G4", "A4", "B4", "C5", "A3", "G3"]
        notes = [NoteSpec(src, scale[i % 10], length=500, consonant=60,
                          flags=f"t{(i % 7 - 3) * 10}") for i in range(50)]
        notes += [NoteSpec(src, scale[(i * 3) % 10], length=750,
                           consonant=60, flags=f"B{(i % 5 - 2) * 10}")
                  for i in range(47)]
        heavy = "sh30sr30sg40su40sj20st-30vf40es30pd40fw20fsta50"
        notes += [NoteSpec(src, scale[i % 10], length=690, consonant=60,
                           flags=heavy + f"t{(i % 7 - 3) * 10}")
                  for i in range(80)]
        render_phrase(notes, pcm16=True)
        print(f"[{time.perf_counter() - t0:6.1f}s] bench phrase graphs "
              f"seeded ({time.perf_counter() - t1:.1f}s)", flush=True)

    size1 = _dir_size_mb(cache_dir) if cache_dir else 0.0
    print(f"[{time.perf_counter() - t0:6.1f}s] done; cache now "
          f"{size1:.1f} MB (+{size1 - size0:.1f} MB)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
