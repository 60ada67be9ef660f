"""HTTP server mode: live POST round-trip on a local port."""
import threading
import urllib.request

import numpy as np
import pytest

from goofer_tpu.sampler.server import ThreadedHTTPServer, RequestHandler
from goofer_tpu.utils.audio_io import read_wav
from goofer_tpu.utils.profiling import StageTimer

from tests.test_resampler import _make_sample


@pytest.fixture(scope="module")
def server():
    httpd = ThreadedHTTPServer(("127.0.0.1", 0), RequestHandler)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}"
    httpd.shutdown()


def test_get_returns_200(server):
    with urllib.request.urlopen(server) as resp:
        assert resp.status == 200


def test_post_renders_note(server, tmp_path):
    wav = tmp_path / "src.wav"
    _make_sample(wav)
    out = tmp_path / "rendered.wav"
    body = f"{wav} {out} C4 100 g0 0 300 50 0 100 0 !120 AA"
    req = urllib.request.Request(server, data=body.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        assert resp.status == 200
    y, sr = read_wav(out)
    assert sr == 44100 and len(y) > 0
    assert np.max(np.abs(y)) > 0.01


def test_concurrent_posts(server, tmp_path):
    """N parallel POSTs against the threaded server: exercises the
    locked module caches (_plan_memo/_batched_core_cache/_decoded_cache)
    under real handler-thread concurrency (SURVEY §5 race bar,
    VERDICT r1 item 7).  Mixes two sources and two flag strings so both
    cache-hit and cache-miss paths race."""
    wavs = []
    for i in range(2):
        w = tmp_path / f"src{i}.wav"
        _make_sample(w, f0=220.0 + 40.0 * i)
        wavs.append(w)

    def post(j):
        out = tmp_path / f"out{j}.wav"
        flags = "g0" if j % 2 else "t20B60"
        body = (f"{wavs[j % 2]} {out} C4 100 {flags} 0 300 50 0 100 0 "
                f"!120 AA")
        req = urllib.request.Request(server, data=body.encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            assert resp.status == 200
        y, sr = read_wav(out)
        assert sr == 44100 and len(y) > 0
        return j

    threads = []
    errors = []

    def run(j):
        try:
            post(j)
        except Exception as e:  # pragma: no cover - failure path
            errors.append((j, e))

    for j in range(8):
        t = threading.Thread(target=run, args=(j,))
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors


def test_post_bad_args_returns_500(server):
    req = urllib.request.Request(server, data=b"garbage", method="POST")
    try:
        urllib.request.urlopen(req, timeout=60)
        raised = False
    except urllib.error.HTTPError as e:
        raised = True
        assert e.code == 500
        assert b"An error occurred" in e.read()
    assert raised


def test_burst_pad_ladder(monkeypatch, tmp_path):
    """A 5-note burst pads to the 8-rung of PHRASE_PAD_LADDER — not 16
    (VERDICT r4 item 4) — and each request still gets its own output.
    Device work is stubbed out; this tests the batcher's pad/dispatch
    bookkeeping only."""
    import goofer_tpu.sampler.phrase as phrase_mod
    import goofer_tpu.sampler.resampler as resampler_mod
    import goofer_tpu.utils.audio_io as audio_io_mod
    from goofer_tpu.sampler.server import BurstBatcher, _Request

    seen = {}

    def fake_render_phrase(notes, **kw):
        seen["n"] = len(notes)
        return [np.zeros(64, dtype=np.int16) for _ in notes]

    monkeypatch.setattr(phrase_mod, "render_phrase", fake_render_phrase)
    monkeypatch.setattr(resampler_mod, "acquire_features",
                        lambda *a, **k: (None, None, None, None, 44100,
                                         64))
    written = []
    monkeypatch.setattr(audio_io_mod, "write_wav",
                        lambda path, y, sr: written.append(str(path)))

    b = BurstBatcher()
    batch = [_Request([str(tmp_path / "in.wav"),
                       str(tmp_path / f"out{j}.wav"),
                       "C4", 100, "", 0, 300, 50, 0, 100, 0, "!120",
                       "AA"]) for j in range(5)]
    b._render(batch)
    assert seen["n"] == 8            # padded to the 8 rung, not 16
    assert b.pad_sizes == [8]
    assert len(written) == 5         # one WAV per real request
    assert all(r.done.is_set() and r.error is None for r in batch)


def test_burst_fallback_is_logged(monkeypatch, tmp_path, caplog):
    """A poisoned phrase path must show up in server logs before the
    per-note fallback runs (VERDICT r4 item 5)."""
    import logging

    import goofer_tpu.sampler.phrase as phrase_mod
    from goofer_tpu.sampler.server import BurstBatcher, _Request

    def boom(notes, **kw):
        raise RuntimeError("poisoned phrase path")

    monkeypatch.setattr(phrase_mod, "render_phrase", boom)

    rendered = []
    b = BurstBatcher()
    monkeypatch.setattr(
        BurstBatcher, "_render_one",
        lambda self, req: (rendered.append(req), req.done.set()))
    batch = [_Request(["a.wav", "b.wav"]) for _ in range(4)]
    with caplog.at_level(logging.ERROR, logger="goofer_tpu"):
        b._render(batch)
    assert any("burst phrase dispatch failed" in r.message
               for r in caplog.records)
    assert len(rendered) == 4        # fallback still served every note


def test_listen_backlog_holds_a_burst():
    """16 connects while the accept loop is busy all complete at once:
    none waits on a resent SYN, which would split a burst."""
    import socket

    httpd = ThreadedHTTPServer(("127.0.0.1", 0), RequestHandler)
    socks = []
    try:
        for _ in range(16):
            c = socket.socket()
            socks.append(c)
            c.settimeout(0.5)
            c.connect(httpd.server_address)
        httpd.socket.settimeout(0.5)
        for _ in socks:
            httpd.socket.accept()[0].close()
    finally:
        for c in socks:
            c.close()
        httpd.server_close()


@pytest.mark.parametrize("max_wait_s, want", [(5.0, [6]), (0.2, "split")])
def test_burst_window_follows_arrivals(monkeypatch, max_wait_s, want):
    """POSTs 0.1 s apart, spread over more than one 0.3 s window, merge
    into one batch; ``MAX_WAIT_S`` still bounds how long it collects."""
    from goofer_tpu.sampler.server import BurstBatcher

    batches = []

    def fake_render(self, batch):
        batches.append(len(batch))
        for req in batch:
            req.done.set()

    monkeypatch.setattr(BurstBatcher, "_render", fake_render)
    b = BurstBatcher()
    b.WINDOW_S, b.MAX_WAIT_S = 0.3, max_wait_s
    clients = []
    for j in range(6):
        c = threading.Thread(target=b.submit, args=([j],))
        c.start()
        clients.append(c)
        threading.Event().wait(0.1)
    for c in clients:
        c.join(timeout=10)
    assert sum(batches) == 6
    if want == "split":
        assert len(batches) > 1, batches
    else:
        assert batches == want


def test_stage_timer_report():
    t = StageTimer(enabled=True)
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    rep = t.report(audio_seconds=1.0)
    assert "a" in rep and "n=2" in rep and "realtime" in rep


def test_burst_posts_batch_into_few_dispatches(server, tmp_path):
    """16 simultaneous POSTs (an editor exporting a track fires one per
    note) merge into a handful of vmapped phrase dispatches instead of
    16 per-note renders (VERDICT r2 item 5).  Asserts on the batcher's
    observed batch sizes AND that every output WAV is written."""
    from goofer_tpu.sampler.server import _batcher

    wav = tmp_path / "burst_src.wav"
    _make_sample(wav)
    # warm the plan/feature caches and the render graph once so the
    # burst measures batching, not compiles
    body = (f"{wav} {tmp_path/'warm.wav'} C4 100 t15 0 300 50 0 100 0 "
            f"!120 AA")
    req = urllib.request.Request(server, data=body.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        assert resp.status == 200

    n0 = len(_batcher.batch_sizes)

    def post(j):
        out = tmp_path / f"burst_out{j}.wav"
        body = (f"{wav} {out} C4 100 t{10+j} 0 300 50 0 100 0 !120 AA")
        req = urllib.request.Request(server, data=body.encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            assert resp.status == 200

    errors = []

    def run(j):
        try:
            post(j)
        except Exception as e:   # pragma: no cover
            errors.append((j, e))

    threads = [threading.Thread(target=run, args=(j,)) for j in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors

    sizes = _batcher.batch_sizes[n0:]
    assert sum(sizes) == 16
    # the 16 bursted notes must have merged into few dispatches (first
    # arrivals may slip into a small leading batch while the rest queue)
    assert len(sizes) <= 4, sizes
    assert max(sizes) >= 8, sizes

    for j in range(16):
        y, sr = read_wav(tmp_path / f"burst_out{j}.wav")
        assert sr == 44100 and len(y) > 0
        assert np.max(np.abs(y)) > 0.01
