"""chip_smoke.py and bench.py on a machine without a GPU: they refuse to
go on, and the smoke's result line carries exactly the keys its readers
take."""
import json

import jax
import pytest

import bench
import chip_smoke


@pytest.mark.parametrize("gate", [
    chip_smoke.device_gate, bench.require_gpu,
], ids=["chip_smoke", "bench"])
def test_gate_refuses_cpu(gate):
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="no GPU"):
        gate(jax.devices())


def test_result_line_carries_exactly_ok_and_device():
    device = chip_smoke.device_gate(jax.devices(), allow_cpu=True)
    line = json.loads(chip_smoke.result_line(device))
    assert set(line) == {"ok", "device"}
    assert line["ok"] is True
    assert set(line["device"]) == {"platform", "kind", "count"}
    assert line["device"] == {"platform": "cpu",
                              "kind": jax.devices()[0].device_kind,
                              "count": len(jax.devices())}


def test_compile_log_collects_compile_times():
    import logging

    log = chip_smoke.CompileLog()
    for msg in ("Finished XLA compilation of jit(a) in 1.5 sec",
                "Finished tracing + transforming b for pjit in 0.1 sec",
                "Persistent compilation cache hit for 'jit_c' with key 'k'",
                "Finished XLA compilation of jit(c) in 2.5e-01 sec"):
        log.emit(logging.LogRecord("jax", logging.WARNING, "", 0, msg,
                                   None, None))
    assert log.take() == ("compiles: 2, 1.8 s in all, cache hits: 1; "
                          "slowest: jit(a) 1.5 s, jit(c) 0.2 s")
    assert log.take() == "compiles: 0, cache hits: 0"
