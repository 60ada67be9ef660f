"""Test environment: JAX on a virtual 8-device CPU platform, so sharding
tests run without accelerators; ``GOOFER_TPU_TEST_PLATFORM=gpu`` keeps
the GPU instead (for the ``gpu``-marked tests and the oracle suite on the
card).

The platform is set through jax.config as well as the environment, in case
JAX was imported before this file.  XLA_FLAGS is read at first backend
init, so the host-device-count flag works from here.
"""
import os

import pytest

# AOT exported-module store (utils/aot.py) off by default under test:
# its digest keys on the release VERSION, not the source, so a blob
# written by an edited working tree would serve stale graph semantics
# to later test runs.  tests/test_aot.py opts back in with a tmp store.
os.environ.setdefault("GOOFER_TPU_AOT", "0")

if os.environ.get("GOOFER_TPU_TEST_PLATFORM") != "gpu":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
    # keep the persistent compilation cache OFF for the virtual-CPU
    # suite: tests drive cli.main()/the server in-process, which enable
    # the cache dir process-wide, and serializing the large universal
    # render executables on the forced-host platform aborts the
    # interpreter (SIGABRT inside compilation_cache.put_executable_
    # and_time at test_universal).  CPU compiles are fast; nothing is
    # lost.  The master switch survives setup_compile_cache, which only
    # sets the cache dir.
    jax.config.update("jax_enable_compilation_cache", False)

    # XLA:CPU segfaults inside backend_compile when a large render graph
    # is compiled after enough jit/LLVM state has accumulated in one
    # process (~200+ tests; first seen at test_universal, then at
    # test_resampler as the suite grew — the same compiles succeed in a
    # fresh process and MALLOC_CHECK_ sees no heap corruption, so the
    # trigger is accumulated compiler state, not this repo's code).
    # The canonical full-suite path is tools/run_tests.sh, which bounds
    # per-process accumulation STRUCTURALLY by running the suite as four
    # fresh pytest processes.  For direct `pytest tests/` invocations,
    # keep this in-process defense: at each module boundary, if enough
    # tests have run since the last reset, drop JAX's caches.  Threshold
    # well under the ~180-test crash horizon; clearing costs only the few
    # cross-module graph recompiles (CPU compiles are fast).
    import gc

    _tests_since_clear = {"n": 0}

    @pytest.fixture(autouse=True)
    def _count_tests_for_compiler_reset():
        yield
        _tests_since_clear["n"] += 1

    @pytest.fixture(scope="module", autouse=True)
    def _bounded_compiler_state():
        if _tests_since_clear["n"] >= 80:
            jax.clear_caches()
            gc.collect()
            _tests_since_clear["n"] = 0
        yield
else:
    # the compile cache the CLI and bench use: the oracle suite on the
    # card otherwise recompiles every production graph each run
    from goofer_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise.
    Decided here, at run time, never while a module is imported."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run with GOOFER_TPU_TEST_PLATFORM=gpu "
                    "on a machine with one")
    return dev
