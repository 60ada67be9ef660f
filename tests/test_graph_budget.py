"""Bounded server-lifetime caches (VERDICT r3 item 7).

A long OpenUtau session walks many (flag-combo x geometry x batch-size)
signatures; each pins a compiled executable.  Two bounds:

- resampler._sweep_graph_budget: when the specialized-signature count
  crosses GRAPH_BUDGET, drop ALL single-note executables and re-warm the
  universal ladder in the background.
- phrase._batched_core_cache: LRU of vmapped-graph jit wrappers capped
  at PHRASE_GRAPH_BUDGET (evicting a wrapper drops the only strong
  reference to its executables).

The logic is tested directly (fake signatures, recorded hooks) — an
RSS-plateau soak at real scale lives in tools/soak_server.py (on the card).
"""
import numpy as np
import pytest

import goofer_tpu.sampler.phrase as phrase
import goofer_tpu.sampler.resampler as rsm
from goofer_tpu.sampler.render_core import RenderStatic


@pytest.fixture
def _clean_graph_state():
    with rsm._graph_lock:
        saved = (set(rsm._seen_statics), dict(rsm._universal_ready),
                 set(rsm._ladder_warming_srs))
        rsm._seen_statics.clear()
        rsm._universal_ready.clear()
        rsm._ladder_warming_srs.clear()
    yield
    with rsm._graph_lock:
        rsm._seen_statics.clear()
        rsm._seen_statics.update(saved[0])
        rsm._universal_ready.clear()
        rsm._universal_ready.update(saved[1])
        rsm._ladder_warming_srs.clear()
        rsm._ladder_warming_srs.update(saved[2])


def _static(n):
    return RenderStatic(sr=44100, n_fft=1024, hop=256, n=n, t_env=64)


def test_sweep_noop_under_budget(monkeypatch, _clean_graph_state):
    calls = []
    monkeypatch.setattr(rsm, "GRAPH_BUDGET", 4)
    monkeypatch.setattr(
        "goofer_tpu.sampler.render_core.clear_compiled_render_graphs",
        lambda: calls.append("clear"))
    rsm._seen_statics.update(_static(4096 * i) for i in range(1, 4))
    rsm._sweep_graph_budget()
    assert calls == []
    assert len(rsm._seen_statics) == 3


def test_sweep_clears_and_rewarm_scheduled(monkeypatch, _clean_graph_state):
    calls = []
    monkeypatch.setattr(rsm, "GRAPH_BUDGET", 2)
    monkeypatch.setattr(
        "goofer_tpu.sampler.render_core.clear_compiled_render_graphs",
        lambda: calls.append("clear"))
    monkeypatch.setattr(
        rsm, "_warm_ladder_background",
        lambda sr, n_fft, hop: calls.append(("warm", sr, n_fft, hop)))

    ru = rsm.universal_static(
        rsm.RenderStatic(sr=48000, n_fft=1024, hop=256, n=8192,
                         t_env=40, masked=True))
    rsm._universal_ready[ru] = {"env_cut": (513, 48)}
    rsm._seen_statics.update(_static(4096 * i) for i in range(1, 5))

    rsm._sweep_graph_budget()
    assert calls == ["clear", ("warm", 48000, 1024, 256)]
    assert not rsm._seen_statics
    assert not rsm._universal_ready
    assert not rsm._ladder_warming_srs


def test_phrase_graph_lru_evicts_oldest(monkeypatch):
    saved = dict(phrase._batched_core_cache)
    phrase._batched_core_cache.clear()
    monkeypatch.setattr(phrase, "PHRASE_GRAPH_BUDGET", 3)
    try:
        axes = (None,) * len(phrase.ARRAY_ORDER)
        statics = [_static(4096 * i) for i in range(1, 6)]
        for rs in statics[:3]:
            phrase._batched_core(rs, axes)
        # hit the OLDEST entry: it must survive the next eviction
        phrase._batched_core(statics[0], axes)
        phrase._batched_core(statics[3], axes)     # evicts statics[1]
        keys = {k[0] for k in phrase._batched_core_cache}
        assert statics[0] in keys and statics[1] not in keys
        phrase._batched_core(statics[4], axes)     # evicts statics[2]
        keys = {k[0] for k in phrase._batched_core_cache}
        assert keys == {statics[0], statics[3], statics[4]}
        assert len(phrase._batched_core_cache) == 3
    finally:
        phrase._batched_core_cache.clear()
        phrase._batched_core_cache.update(saved)
