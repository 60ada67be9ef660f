"""The persistent XLA cache goes where JAX_COMPILATION_CACHE_DIR says, and
otherwise to one fixed path inside the checkout."""
from pathlib import Path

import pytest

from goofer_tpu.utils import aot
from goofer_tpu.utils.compile_cache import CACHE_ROOT, xla_cache_dir

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("environ,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/xla"}, None),
    ({}, str(REPO / ".cache" / "xla")),
], ids=["env_set", "in_checkout"])
def test_xla_cache_dir(environ, want):
    assert xla_cache_dir(environ) == want


def test_aot_store_defaults_into_the_checkout(monkeypatch):
    monkeypatch.delenv("GOOFER_TPU_AOT", raising=False)
    assert aot.store_dir() == str(CACHE_ROOT / "aot")
    assert CACHE_ROOT == REPO / ".cache"
