"""Smoke run of the resampler's main path on one GPU.

Drives each way users run the resampler once, through its normal entry
point and at the sizes they run, and checks what comes out:

1. device gate: JAX must report a GPU; the card's name and power limit
   come from ``nvidia-smi``;
2. CLI note render (``cli.main``) of the shipped voice recording, pitch
   checked by autocorrelation;
3. the bench's 97-note light phrase and 80-note 11-flag phrase through
   ``render_phrase(pcm16=True)``;
4. a burst of 8 concurrent POSTs, then one single POST, against the HTTP
   server running in a thread of this process; the burst must be served
   by the batched phrase dispatch, not the per-note fallback;
5. CLI folder extraction of a 60-file voicebank (WAV and FLAC);
6. parity on the device: ``render_note`` against the sequential oracle on
   the deterministic flag configs, and ``pulse_train`` against its oracle
   at bench width;
7. peak device memory.

Each phase prints its wall time and the compiles it paid.  A phase that
fails raises, and the script exits non-zero without a result line.  The
last line of stdout is one JSON object naming the device.

Usage: python chip_smoke.py [--rehearse]

``--rehearse`` lifts the device gate and cuts note, file and batch
counts, for a dry run on the CPU (``JAX_PLATFORMS=cpu``).
"""
from __future__ import annotations

import argparse
import json
import logging
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

SR = 44100
# pulse_train vs its oracle: the CPU suite's budget (tests/test_ops.py)
# over samples outside flip-prone onset windows, which stay rare
PULSE_ATOL = 5e-3
PULSE_MIN_KEEP = 0.9


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit, read by a child process that
    stays off JAX."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return res.stdout.strip() or f"nvidia-smi rc {res.returncode}"


def device_gate(devices, allow_cpu: bool = False) -> dict:
    """The device record of the result line; SystemExit unless JAX's
    devices are GPUs (or ``allow_cpu`` for a rehearsal)."""
    from bench import require_gpu

    if not allow_cpu:
        require_gpu(devices)
    d = devices[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def result_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": device})


class CompileLog(logging.Handler):
    """Collects JAX's per-graph XLA compile times and persistent-cache
    hits (``jax_log_compiles``) instead of letting them flood stderr."""

    _RE = re.compile(r"Finished XLA compilation of (.*) in ([0-9.e+-]+) sec")
    _HIT = "Persistent compilation cache hit"
    LOGGERS = ("jax._src.dispatch", "jax._src.interpreters.pxla",
               "jax._src.compiler")

    def __init__(self):
        super().__init__(logging.WARNING)
        self.lock_ = threading.Lock()
        self.entries: list[tuple[str, float]] = []
        self.hits = 0

    def emit(self, record):
        msg = record.getMessage()
        m = self._RE.search(msg)
        with self.lock_:
            if m:
                self.entries.append((m.group(1), float(m.group(2))))
            elif msg.startswith(self._HIT):
                self.hits += 1

    def take(self) -> str:
        """Summary since the last call: compiles (a cache hit counts as
        one, its time being the load), seconds, and the slowest three."""
        with self.lock_:
            got, self.entries = self.entries, []
            hits, self.hits = self.hits, 0
        if not got:
            return f"compiles: 0, cache hits: {hits}"
        got.sort(key=lambda e: -e[1])
        top = ", ".join(f"{name} {s:.1f} s" for name, s in got[:3])
        return (f"compiles: {len(got)}, {sum(s for _, s in got):.1f} s "
                f"in all, cache hits: {hits}; slowest: {top}")


def _voicebank_wave(rng, dur: float) -> np.ndarray:
    """A sung-vowel-like sample: noisy consonant head, then a harmonic
    tone with vibrato and a slow glide."""
    n = int(dur * SR)
    t = np.arange(n) / SR
    f0 = (float(rng.uniform(110.0, 400.0))
          * 2 ** (0.02 * np.sin(2 * np.pi * 5.5 * t) + 0.05 * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    y = sum(np.sin(h * phase) / h for h in range(1, 16))
    y *= 0.3 * np.minimum(1.0, t / 0.05)
    head = int(float(rng.uniform(0.05, 0.15)) * SR)
    y[:head] = 0.05 * rng.standard_normal(head)
    return y.astype(np.float32)


def _autocorr_midi(y: np.ndarray) -> float:
    """Pitch of a voiced span by autocorrelation, in MIDI note numbers."""
    seg = y - y.mean()
    ac = np.correlate(seg, seg, "full")[len(seg) - 1:]
    lo, hi = int(SR / 1000), int(SR / 60)
    lag = lo + int(np.argmax(ac[lo:hi]))
    return 69.0 + 12.0 * np.log2(SR / lag / 440.0)


def phase_cli_note(work: Path) -> None:
    import shutil

    from goofer_tpu import cli
    from goofer_tpu.utils.audio_io import read_wav_mono

    src = work / "voice.wav"
    shutil.copy(REPO / "tests/golden/voice/src.wav", src)
    out = work / "note.wav"
    rc = cli.main([str(src), str(out), "C4", "100", "t10B20", "0", "500",
                   "60", "0", "100", "0", "!120", "AA"])
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    y, sr = read_wav_mono(out)
    want = round(0.56 * sr)
    if sr != SR or abs(len(y) - want) > 256:
        raise RuntimeError(f"note is {len(y)} samples at {sr} Hz, "
                           f"want {want} +- 256 at {SR}")
    midi = _autocorr_midi(y[int(0.25 * sr): int(0.45 * sr)])
    if abs(midi - 60.1) > 0.5:
        raise RuntimeError(f"note pitch {midi:.2f} midi, want 60.1")
    print(f"  note: {len(y)} samples, peak {np.abs(y).max():.3f}, pitch "
          f"{midi:.2f} midi (want 60.1 +- 0.5)", flush=True)


def phase_phrases(work: Path, rehearse: bool) -> None:
    from bench import (
        _make_voicebank_sample,
        audio_seconds,
        heavy_phrase,
        light_phrase,
    )
    from goofer_tpu.sampler.phrase import render_phrase

    src = str(work / "phrase_src.wav")
    _make_voicebank_sample(src)
    phrases = {
        "light": light_phrase(src, *((2, 2) if rehearse else ())),
        "11-flag": heavy_phrase(src, *((2,) if rehearse else ())),
    }
    for name, notes in phrases.items():
        for call in ("first", "second"):
            t0 = time.perf_counter()
            outs = render_phrase(notes, pcm16=True)
            dt = time.perf_counter() - t0
            if len(outs) != len(notes):
                raise RuntimeError(f"{name}: {len(outs)} outputs for "
                                   f"{len(notes)} notes")
            for i, o in enumerate(outs):
                if o.dtype != np.int16 or o.size == 0 or not o.any():
                    raise RuntimeError(
                        f"{name} note {i}: dtype {o.dtype}, {o.size} "
                        f"samples, peak {np.abs(o).max(initial=0)}")
            print(f"  {name} phrase, {len(notes)} notes, "
                  f"{audio_seconds(notes):.1f} s of audio, {call} call: "
                  f"{dt:.3f} s", flush=True)


def phase_server(work: Path) -> None:
    # imported here, not by the first POST's handler thread, so the
    # burst's handlers do not queue on the import lock and miss the
    # batcher's window
    from goofer_tpu.editor import gui  # noqa: F401
    from goofer_tpu.sampler import flags, phrase, resampler  # noqa: F401
    from goofer_tpu.sampler import server
    from goofer_tpu.utils.audio_io import read_wav, write_wav

    rng = np.random.default_rng(2)
    srcs = []
    for i in range(2):
        p = work / f"server_src{i}.wav"
        write_wav(p, _voicebank_wave(rng, 0.8), SR)
        srcs.append(p)

    errors: list[logging.LogRecord] = []

    class _Errors(logging.Handler):
        def emit(self, record):
            errors.append(record)

    watch = _Errors(logging.ERROR)
    logging.getLogger("goofer_tpu").addHandler(watch)
    httpd = server.ThreadedHTTPServer(("127.0.0.1", 0),
                                      server.RequestHandler)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    try:
        def post(j, out):
            body = (f"{srcs[j % 2]} {out} {['C4', 'E4', 'G4'][j % 3]} 100 "
                    f"t{(j % 5) * 10 - 20} 0 {300 + 20 * j} 60 0 100 0 "
                    f"!120 AA")
            req = urllib.request.Request(url, data=body.encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=900) as resp:
                return resp.status

        outs = [work / f"burst{j}.wav" for j in range(8)]
        status: dict[int, object] = {}
        start = threading.Barrier(len(outs))

        def client(j):
            start.wait()
            try:
                status[j] = post(j, outs[j])
            except Exception as e:  # reported below as a failed request
                status[j] = e

        clients = [threading.Thread(target=client, args=(j,))
                   for j in range(len(outs))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=1200)
        bad = {j: s for j, s in status.items() if s != 200}
        if len(status) != len(outs) or bad:
            raise RuntimeError(f"burst responses {status}")
        burst_batches = list(server._batcher.batch_sizes)
        burst_pads = list(server._batcher.pad_sizes)

        single = work / "single.wav"
        if post(8, single) != 200:
            raise RuntimeError("single POST failed")
    finally:
        httpd.shutdown()
        httpd.server_close()
        logging.getLogger("goofer_tpu").removeHandler(watch)

    if errors:
        raise RuntimeError("server logged errors (the per-note fallback "
                           "ran?): " + "; ".join(r.getMessage()
                                                 for r in errors))
    if (sum(burst_batches) != len(outs)
            or min(burst_batches) < server.BurstBatcher.MIN_PHRASE
            or len(burst_pads) != len(burst_batches)):
        raise RuntimeError(f"burst not served by the batched dispatch: "
                           f"batches {burst_batches}, pads {burst_pads}")
    for p in outs + [single]:
        y, sr = read_wav(p)
        if sr != SR or len(y) == 0 or np.abs(y).max() < 1e-3:
            raise RuntimeError(f"{p.name}: {len(y)} samples at {sr} Hz, "
                               f"peak {np.abs(y).max(initial=0)}")
    print(f"  burst of {len(outs)} served as batches {burst_batches} "
          f"padded to {burst_pads}; single POST served; all WAVs written",
          flush=True)


def phase_folder(work: Path, rehearse: bool) -> None:
    from goofer_tpu import cli
    from goofer_tpu.utils.audio_io import write_wav
    from tests.flac_writer import write_flac

    bank = work / "voicebank"
    bank.mkdir()
    rng = np.random.default_rng(3)
    n_files = 6 if rehearse else 60
    files = []
    for i in range(n_files):
        y = _voicebank_wave(rng, float(rng.uniform(0.4, 2.0)))
        sub = bank / f"pitch{i % 3}"
        sub.mkdir(exist_ok=True)
        if i % 10 == 3:
            p = sub / f"s{i:02d}.flac"
            pcm = np.clip(np.round(y * 32767), -32768, 32767)
            write_flac(p, pcm.astype(np.int64), SR)
        else:
            p = sub / f"s{i:02d}.wav"
            write_wav(p, y, SR)
        files.append(p)
    rc = cli.main([str(bank)])
    if rc != 0:
        raise RuntimeError(f"folder extraction returned {rc}")
    missing = [p.name for p in files
               if not p.with_name(f"{p.stem}_features.goofy").exists()]
    if missing:
        raise RuntimeError(f"no .goofy for {missing}")
    n_flac = sum(p.suffix == ".flac" for p in files)
    print(f"  {len(files)} files ({n_flac} FLAC): every one has its .goofy",
          flush=True)


def phase_parity(rehearse: bool) -> None:
    import jax

    from goofer_tpu.ops.pulse import pulse_train
    from tests import oracles as o
    from tests.fixtures_common import DET_CONFIGS, make_synth_features
    from tests.test_resample_oracle import (
        DET_ATOL,
        DET_LSD_DB,
        det_parity,
        pulse_keep_mask,
    )

    print("  precision: f32 products and convolutions pinned to "
          "lax.Precision.HIGHEST; default matmul precision "
          f"{jax.config.jax_default_matmul_precision}", flush=True)
    features = make_synth_features()
    failed = []
    for cfg_id, pitch, vel, flags, ps, length_ms, min_keep, outl in \
            DET_CONFIGS:
        keep, err, lsd = det_parity(features, pitch, vel, flags, ps,
                                    length_ms, outl)
        err_tol = DET_ATOL if outl == 0.0 else outl
        err_name = "max |err|/peak" if outl == 0.0 else \
            f"share beyond {DET_ATOL:g}"
        ok = keep > min_keep and err <= err_tol and lsd < DET_LSD_DB
        print(f"  render_note {cfg_id}: kept {keep:.4f} (> {min_keep}), "
              f"{err_name} {err:.3e} (<= {err_tol:g}), LSD {lsd:.4f} dB "
              f"(< {DET_LSD_DB}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(cfg_id)

    batch, n = (4, 8192) if rehearse else (80, 33075)
    rng = np.random.default_rng(4)
    t = np.arange(n) / SR
    f0 = (rng.uniform(110.0, 330.0, (batch, 1))
          * 2 ** (0.3 * np.sin(2 * np.pi * rng.uniform(1.0, 4.0, (batch, 1))
                               * t[None, :])))
    f0[:, int(0.3 * n): int(0.4 * n)] = 0.0
    f0[:, : int(0.02 * n)] = 0.0
    f0 = f0.astype(np.float32)
    fn = jax.jit(jax.vmap(lambda f: pulse_train(f, SR)))
    f0_dev = jax.device_put(f0)
    got = np.asarray(fn(f0_dev))
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        fn(f0_dev).block_until_ready()
        times.append(time.perf_counter() - t0)
    err, kept = 0.0, 0
    for row, f in zip(got, f0):
        keep = pulse_keep_mask(f, SR)
        kept += int(keep.sum())
        err = max(err, float(np.abs(row - o.o_pulse_train(f, SR))[keep].max()))
    kept_frac = kept / f0.size
    ok = err < PULSE_ATOL and kept_frac > PULSE_MIN_KEEP
    print(f"  pulse_train batch {batch} x {n} samples: kept {kept_frac:.4f} "
          f"(> {PULSE_MIN_KEEP}; flip-prone onsets excluded), max |err| "
          f"{err:.3e} (< {PULSE_ATOL:g}) {'ok' if ok else 'FAIL'}; "
          f"plain jnp path {np.median(times) * 1e3:.3f} ms median, "
          f"{min(times) * 1e3:.3f} ms min of {len(times)} calls",
          flush=True)
    if not ok:
        failed.append("pulse_train")
    if failed:
        raise RuntimeError(f"parity failed: {failed}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="allow a CPU platform and cut counts (dry run)")
    args = ap.parse_args(argv)

    import jax

    device = device_gate(jax.devices(), allow_cpu=args.rehearse)
    card = card_name_and_power_limit()
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}, devices: {jax.devices()}", flush=True)

    from goofer_tpu import native
    from goofer_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}",
          flush=True)
    try:
        native.load()
        native.load_snd()
        codec = "native C++ codecs"
    except (OSError, subprocess.CalledProcessError) as e:
        codec = f"Python fallback codecs (native build failed: {e})"
    print(f"audio I/O: {codec}", flush=True)

    compiles = CompileLog()
    for name in CompileLog.LOGGERS:
        lg = logging.getLogger(name)
        lg.addHandler(compiles)
        lg.propagate = False
    jax.config.update("jax_log_compiles", True)

    work = Path(tempfile.mkdtemp(prefix="goofer_smoke_"))
    label = device["kind"]
    phases = [
        ("cli note", lambda: phase_cli_note(work)),
        ("phrases", lambda: phase_phrases(work, args.rehearse)),
        ("server burst", lambda: phase_server(work)),
        ("folder extraction", lambda: phase_folder(work, args.rehearse)),
        ("parity", lambda: phase_parity(args.rehearse)),
    ]
    for name, run in phases:
        print(f"[{label}] phase {name}", flush=True)
        t0 = time.perf_counter()
        run()
        print(f"[{label}] phase {name}: {time.perf_counter() - t0:.3f} s; "
              f"{compiles.take()}", flush=True)

    stats = jax.devices()[0].memory_stats() or {}
    print(f"[{label}] peak device memory: "
          f"{stats.get('peak_bytes_in_use', 'not reported')} bytes",
          flush=True)
    print(f"card: {card}", flush=True)
    print(result_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
