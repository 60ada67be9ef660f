"""Phrase-render benchmark on one GPU, through the full production
pipeline.

Workloads (the same phrases ``chip_smoke.py`` drives):

* light: 97 notes in two length buckets (0.5 s / 0.75 s at 44.1 kHz,
  ~60 s of audio), one t or B flag each;
* 11-flag: 80 notes of 0.75 s, each carrying the 11-flag texture/layer/
  tension/fry/dynamics stack;
* randomized: 40 notes of random length, so no two share a geometry;
* warm start: the first light-phrase render of this process (feature
  extraction plus trace, compile or cache load of every graph).

Each phrase render is per-note host planning plus one vmapped dispatch of
the fused render graph per bucket, int16 PCM quantization included, and
ends when every note's samples are on the host.  Feature extraction of
the source sample is cached (.goofy), matching the extract-once workflow
of the reference.  Warmup is timed separately from the steady-state reps.

Prints one JSON line per metric on stdout, each naming the device it ran
on; stage timings go to stderr.  Exits non-zero when JAX finds no GPU.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

_T0 = time.perf_counter()

SCALE = ["C4", "D4", "E4", "F4", "G4", "A4", "B4", "C5", "A3", "G3"]
HEAVY_FLAGS = "sh30sr30sg40su40sj20st-30vf40es30pd40fw20fsta50"


def _log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def _make_voicebank_sample(path, sr=44100, dur=0.6):
    from goofer_tpu.utils.audio_io import write_wav

    n = int(dur * sr)
    t = np.arange(n) / sr
    f0 = 220.0 * (1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t))
    phase = np.cumsum(f0 / sr)
    y = 0.35 * (2 * (phase % 1.0) - 1.0)
    y = np.convolve(y, np.ones(8) / 8.0, mode="same")
    rng = np.random.default_rng(0)
    y[: n // 10] = 0.05 * rng.standard_normal(n // 10)
    write_wav(path, y.astype(np.float32), sr)


def light_phrase(src, n_short=50, n_long=47):
    """The 97-note, ~60 s light phrase."""
    from goofer_tpu.sampler.phrase import NoteSpec

    notes = [NoteSpec(src, SCALE[i % len(SCALE)], length=500,
                      consonant=60, flags=f"t{(i % 7 - 3) * 10}")
             for i in range(n_short)]
    notes += [NoteSpec(src, SCALE[(i * 3) % len(SCALE)], length=750,
                       consonant=60, flags=f"B{(i % 5 - 2) * 10}")
              for i in range(n_long)]
    return notes


def heavy_phrase(src, n=80):
    """The 80-note 11-flag phrase (60 s)."""
    from goofer_tpu.sampler.phrase import NoteSpec

    return [NoteSpec(src, SCALE[i % len(SCALE)], length=690, consonant=60,
                     flags=HEAVY_FLAGS + f"t{(i % 7 - 3) * 10}")
            for i in range(n)]


def randomized_phrase(src, n=40):
    """40 notes of random length: no repeated note geometry."""
    from goofer_tpu.sampler.phrase import NoteSpec

    rng = np.random.default_rng(1)
    return [NoteSpec(src, SCALE[int(rng.integers(len(SCALE)))],
                     length=int(rng.integers(300, 900)), consonant=60,
                     flags=f"t{int(rng.integers(-30, 30))}")
            for _ in range(n)]


def audio_seconds(notes) -> float:
    return sum((n.consonant + n.length) / 1000.0 for n in notes)


def require_gpu(devices):
    """``devices`` unchanged, or SystemExit when they are not GPUs: a
    number taken on another backend is not a GPU number."""
    if devices[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX reports {devices[0].platform} "
                         f"devices {list(devices)}")
    return devices


def main():
    import jax

    from goofer_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    devs = require_gpu(jax.devices())
    device = {"platform": devs[0].platform,
              "device_kind": devs[0].device_kind,
              "device_count": len(devs)}
    _log(f"devices: {devs}")

    def emit(metric, value, unit):
        print(json.dumps({"metric": metric, "value": value, "unit": unit,
                          **device}), flush=True)

    from goofer_tpu.sampler.phrase import plan_phrase, render_phrase

    def reps(notes, n, tag):
        """n timed renders; each ends with every note on the host."""
        audio_s = audio_seconds(notes)
        rtfs = []
        for rep in range(n):
            t0 = time.perf_counter()
            outs = render_phrase(notes, pcm16=True)
            elapsed = time.perf_counter() - t0
            assert all(np.abs(o).max() > 0 for o in outs)
            rtfs.append(audio_s / elapsed)
            _log(f"{tag} rep {rep}: {elapsed:.4f}s for {audio_s:.1f}s "
                 f"audio -> {rtfs[-1]:.2f}x realtime")
        return rtfs

    tmp = tempfile.mkdtemp(prefix="goofer_bench_")
    src = os.path.join(tmp, "a.wav")
    _make_voicebank_sample(src)
    notes = light_phrase(src)

    t_warm = time.perf_counter()
    _log("warmup: feature extraction (compiles the analysis graph)")
    plan_phrase(notes[:1])
    _log("warmup: phrase render (compiles the fused render graphs)")
    outs = render_phrase(notes, pcm16=True)
    warmup_s = time.perf_counter() - t_warm
    assert all(o.dtype == np.int16 for o in outs)
    _log(f"warmup done in {warmup_s:.1f}s; timing reps")
    emit("warm_start_to_first_phrase", warmup_s, "s")

    light = reps(notes, 5, "light")
    emit("realtime_factor_60s_phrase_full_pipeline", max(light),
         "x_realtime")

    # device compute and dispatch alone: fetch=False blocks on every
    # group's result but skips the device-to-host copy
    comp = []
    for _ in range(4):
        t0 = time.perf_counter()
        render_phrase(notes, pcm16=True, fetch=False)
        comp.append(time.perf_counter() - t0)
    emit("realtime_factor_60s_phrase_compute_only",
         audio_seconds(notes) / min(comp), "x_realtime")

    heavy = heavy_phrase(src)
    t0 = time.perf_counter()
    render_phrase(heavy, pcm16=True)
    _log(f"11-flag warmup (80 notes): {time.perf_counter() - t0:.1f}s")
    emit("realtime_factor_60s_phrase_11flag_stack",
         max(reps(heavy, 4, "11-flag")), "x_realtime")

    rand = randomized_phrase(src)
    t0 = time.perf_counter()
    render_phrase(rand, pcm16=True)
    _log(f"randomized warmup (40 unique lengths): "
         f"{time.perf_counter() - t0:.1f}s")
    emit("realtime_factor_randomized_geometry_phrase",
         max(reps(rand, 5, "randomized")), "x_realtime")


if __name__ == "__main__":
    main()
