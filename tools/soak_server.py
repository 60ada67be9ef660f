"""Server-lifetime memory soak (VERDICT r3 item 7).

Renders a long stream of notes across many first-sight flag combos and
geometries — the access pattern of a whole OpenUtau session — and
tracks host RSS plus the graph-cache populations.  With the graph
budget active (resampler.GRAPH_BUDGET, default 256; set
GOOFER_TPU_GRAPH_BUDGET to soak faster) RSS must PLATEAU: the sweep
drops compiled note executables and re-warms the ladder instead of
accumulating every signature forever.

Usage:
  GOOFER_TPU_GRAPH_BUDGET=32 python tools/soak_server.py \
      --notes 400 --combos 60

Exit code 1 if the last-quarter RSS mean grew more than --tolerance
(default 8%) over the second quarter's mean (the first quarter is
warmup/compile churn and is excluded).
"""
from __future__ import annotations

import argparse
import itertools
import os
import random
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def _flag_combos(n: int) -> list:
    """n distinct flag strings spanning the whole decoded surface."""
    atoms = ["t{v}", "B{v}", "g{v}", "bre{v}", "es{v}", "st{v}", "pd{v}",
             "vf{v}", "fw{v}", "sh{v}", "sr{v}", "sg{v}", "su{v}",
             "sj{v}", "sd{v}", "sa{v}", "fa{v}", "fb{v}"]
    rng = random.Random(7)
    combos = set()
    while len(combos) < n:
        k = rng.randint(1, 6)
        parts = rng.sample(atoms, k)
        combos.add("".join(p.format(v=rng.choice([-40, -20, 15, 30, 50]))
                           for p in parts))
    return sorted(combos)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--notes", type=int, default=400)
    ap.add_argument("--combos", type=int, default=60)
    ap.add_argument("--tolerance", type=float, default=0.08)
    args = ap.parse_args()

    t0 = time.perf_counter()
    from goofer_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    import goofer_tpu.sampler.phrase as phrase
    import goofer_tpu.sampler.resampler as rsm
    from bench import _make_voicebank_sample

    print(f"GRAPH_BUDGET={rsm.GRAPH_BUDGET} "
          f"PHRASE_GRAPH_BUDGET={phrase.PHRASE_GRAPH_BUDGET}", flush=True)

    tmp = tempfile.mkdtemp(prefix="goofer_soak_")
    src = os.path.join(tmp, "src.wav")
    _make_voicebank_sample(src, 44100)
    out = os.path.join(tmp, "out.wav")

    print(f"[{time.perf_counter() - t0:6.1f}s] warming ladder", flush=True)
    rsm.warm_universal(sr=44100)

    combos = _flag_combos(args.combos)
    lengths = [320, 480, 700, 1100]
    scale = ["C4", "D4", "E4", "G4", "A4", "C5"]
    rng = random.Random(11)
    rss_track = []

    for i in range(args.notes):
        flags = combos[i % len(combos)]
        rsm.GooferResampler(
            src, out, scale[i % len(scale)], 100, flags, 0,
            lengths[i % len(lengths)], 60, 0, 100, 0, "!120",
            f"AB#{rng.randint(20, 60)}#")
        if (i + 1) % 25 == 0:
            rss = _rss_mb()
            rss_track.append(rss)
            with rsm._graph_lock:
                seen = len(rsm._seen_statics)
                uni = len(rsm._universal_ready)
            print(f"[{time.perf_counter() - t0:6.1f}s] note {i + 1:4d}  "
                  f"rss={rss:7.1f}MB  seen={seen:3d}  universal={uni:2d}  "
                  f"phrase_cache={len(phrase._batched_core_cache)}",
                  flush=True)

    q = max(1, len(rss_track) // 4)
    early = float(np.mean(rss_track[q:2 * q]))
    late = float(np.mean(rss_track[-q:]))
    growth = (late - early) / early
    print(f"RSS quarter means: early={early:.1f}MB late={late:.1f}MB "
          f"growth={growth * 100:.1f}% (tolerance "
          f"{args.tolerance * 100:.0f}%)", flush=True)
    if growth > args.tolerance:
        print("FAIL: RSS did not plateau", flush=True)
        return 1
    print("OK: RSS plateaued", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
