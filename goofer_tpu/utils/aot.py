"""AOT exported-graph store: kill per-process tracing of the hot graphs.

The reference pays ~seconds of Numba JIT once per process
(ref: GOOFER.py:1224, test.py:6).  Here the persistent XLA compilation
cache already removes recompiles, but every fresh process still pays
Python tracing + MLIR lowering before it can even LOOK UP the cache —
tens of seconds for the 11-flag phrase graph, whose jaxpr is ~72k
primitives, dominated by the blocked-IIR cascades.

Fix: ``jax.export``.  The first process to build a graph serializes its
lowered StableHLO (far smaller than the compiled executable) into this
store; every later process deserializes the module (a C++ parse) and
jits ``exported.call`` directly, which
wraps the pre-lowered module instead of re-tracing Python.  Compiled
executables of the wrapped module land in the same persistent XLA cache,
so a fresh process goes disk -> StableHLO -> cache-hit executable with
zero tracing.

Keying: sha256 of (jax version, platform, family tag, static-config
repr, arg-spec signature).  Platform is in the key because exported
modules check their lowering platform at call time; jax version because
serialized modules only guarantee backward compatibility.

Store is best-effort everywhere: any failure falls back to the plain
jitted function.  ``GOOFER_TPU_AOT=0`` disables it; ``GOOFER_TPU_AOT=
<dir>`` relocates it (default ``<repo>/.cache/aot``, beside the XLA
cache of utils/compile_cache.py).
"""
from __future__ import annotations

import hashlib
import logging
import os
import tempfile
import threading

log = logging.getLogger("goofer_tpu")

_lock = threading.Lock()


def store_dir() -> str | None:
    v = os.environ.get("GOOFER_TPU_AOT", "")
    if v == "0":
        return None
    if v:
        return v
    from goofer_tpu.utils.compile_cache import CACHE_ROOT

    return str(CACHE_ROOT / "aot")


_src_fp: str | None = None


def _source_fingerprint() -> str:
    """sha256 over every .py file in the goofer_tpu package (path +
    content), computed once per process.  Keyed into the digest so a
    traced-graph edit that ships without a config.VERSION bump can never
    serve a stale exported module — wrong audio with no error was the
    failure mode (ADVICE r4).  ~1 MB of source, a few ms."""
    global _src_fp
    if _src_fp is None:
        import goofer_tpu

        h = hashlib.sha256()
        pkg = os.path.dirname(os.path.abspath(goofer_tpu.__file__))
        for root, dirs, files in os.walk(pkg):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            for name in sorted(files):
                if not name.endswith(".py"):
                    continue
                p = os.path.join(root, name)
                h.update(os.path.relpath(p, pkg).encode())
                with open(p, "rb") as f:
                    h.update(f.read())
        _src_fp = h.hexdigest()[:16]
    return _src_fp


def _digest(family: str, config_repr: str, args) -> str:
    import jax
    import numpy as np

    from goofer_tpu import config

    # config.VERSION invalidates the store per release; the source
    # fingerprint invalidates it on ANY package edit, so a blob can
    # never outlive the code that traced it (the XLA executable cache
    # keys on HLO content and needs no such guard).
    parts = [config.VERSION, _source_fingerprint(), jax.__version__,
             jax.devices()[0].platform, family, config_repr]
    for leaf in jax.tree.leaves(args):
        # leaves are post-_canon: every one carries .dtype, and device
        # arrays are never np.asarray'd (that would fetch them)
        parts.append(f"{np.shape(leaf)}:{leaf.dtype}")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:32]


def _canon(args):
    """Canonicalize host-side args exactly the way jit would (x64 off:
    f64 -> f32, i64 -> i32), so the exported module's arg specs match
    the avals of every later call.  np.asarray on numpy inputs is free;
    astype copies only when the dtype actually changes; device arrays
    pass through untouched (asarray would fetch them)."""
    import jax
    import numpy as np

    def c(x):
        if isinstance(x, jax.Array):
            return x            # already canonical; asarray would fetch
        a = np.asarray(x)
        ct = jax.dtypes.canonicalize_dtype(a.dtype)
        return a if a.dtype == ct else a.astype(ct)

    return jax.tree.map(c, args)


def wrap(family: str, config_repr: str, jitted_fn):
    """Return a callable with the store wired around ``jitted_fn``.

    On the first invocation (arg shapes now known) it loads the exported
    module from the store if present — skipping Python tracing entirely —
    or traces via ``jitted_fn``, exports it, and saves the blob so the
    NEXT process skips the trace.  In both cases execution then runs
    through ``jit(exported.call)``, so the persistent XLA cache is keyed
    on the wrapped module consistently across processes.
    """
    d = store_dir()
    if d is None:
        return jitted_fn

    import jax
    import numpy as np

    # one exported module per arg signature, exactly like jit retraces
    # per signature: the phrase/analysis graphs see several batch
    # shapes through one wrapper (bucket chunking)
    resolved: dict = {}

    def call(*args):
        args = _canon(args)
        leaves, treedef = jax.tree.flatten(args)
        sig = (treedef,) + tuple(
            (np.shape(l), str(l.dtype)) for l in leaves)
        fn = resolved.get(sig)
        if fn is None:
            with _lock:
                fn = resolved.get(sig)
                if fn is None:
                    fn = _resolve(family, config_repr, jitted_fn,
                                  args, d)
                    resolved[sig] = fn
        return fn(*args)

    call.lower = jitted_fn.lower   # diagnostics lower the underlying
    return call                    # module directly


def _resolve(family: str, config_repr: str, jitted_fn, args, d: str):
    import jax
    import jax.export

    try:
        key = _digest(family, config_repr, args)
        path = os.path.join(d, f"{family}-{key}.stablehlo")
    except Exception:
        log.debug("aot: digest failed; plain jit", exc_info=True)
        return jitted_fn

    try:
        with open(path, "rb") as f:
            exp = jax.export.deserialize(f.read())
        return jax.jit(exp.call)
    except FileNotFoundError:
        pass
    except Exception:
        log.debug("aot: load %s failed; re-exporting", path, exc_info=True)

    try:
        import numpy as np

        specs = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(np.shape(x), x.dtype), args)
        exp = jax.export.export(jitted_fn)(*specs)
        blob = exp.serialize()
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)      # atomic: concurrent writers converge
        return jax.jit(exp.call)
    except Exception:
        log.debug("aot: export failed; plain jit", exc_info=True)
        return jitted_fn
