"""SillySampler-compatible CLI dispatcher (ref: SillySampler.py:1226-1275).

Modes, selected exactly like the reference:
* no args                         -> HTTP server on :8572
* all args end in .goofy          -> voicing-editor batch mode
* one existing non-.goofy path    -> recursive folder feature extraction
* >= 13 args                      -> one note render (UTAU protocol)
"""
from __future__ import annotations

import logging
import sys
from pathlib import Path

from goofer_tpu import config
from goofer_tpu.utils.compile_cache import setup_compile_cache

logging.basicConfig(format="%(message)s", level=logging.INFO)
log = logging.getLogger("goofer_tpu")

HELP_STRING = (
    "Usage:\n"
    "  goofer-sampler in.wav out.wav pitch velocity flags\n"
    "           offset(ms) length(ms) consonant(ms) cutoff(ms)\n"
    "           volume(%) modulation(%) !tempo pitch_string\n\n"
    "Example:\n"
    "  goofer-sampler in.wav out.wav C4 100 g0 0 1000 0 700 100 0 !120 AA"
)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    log.info("goofer_tpu SillySampler %s (surface-compatible with %s)",
             config.VERSION, config.REFERENCE_CLI_VERSION)
    # persistent XLA cache — the equivalent of the reference's Numba
    # warmup idiom (ref: GOOFER.py:1224): after the first run, note-render
    # graphs load from disk instead of recompiling
    setup_compile_cache()

    if not argv:
        try:
            from goofer_tpu.sampler.server import run
            run()
            return 0
        except TypeError:
            log.info(HELP_STRING)
            return 0

    log.info("Args: %s (count=%d)", argv, len(argv))
    try:
        if all(Path(a).suffix.lower() == ".goofy" for a in argv):
            from goofer_tpu.editor.gui import edit_goofy_files
            edit_goofy_files(argv)
            return 0

        if (len(argv) == 1 and Path(argv[0]).exists()
                and Path(argv[0]).suffix.lower() != ".goofy"):
            from goofer_tpu.sampler.batch_extract import (
                extract_features_recursive,
            )
            log.info("Scanning folder: %s", argv[0])
            extract_features_recursive(Path(argv[0]))
            log.info("Done extracting features.")
            return 0

        if len(argv) < 13:
            raise TypeError(f"Expected 13 arguments but got {len(argv)}")

        from goofer_tpu.editor.gui import available_interactive_hook
        from goofer_tpu.sampler.resampler import GooferResampler
        # SE1 blocks on the voicing editor mid-render like the reference
        # (SillySampler.py:581-611) whenever a display is available.
        GooferResampler(*argv[:13],
                        editor_hook=available_interactive_hook())
        return 0
    except TypeError as e:
        log.error("Argument parsing failed: %s", str(e))
        log.error(HELP_STRING)
        return 1
    except Exception:
        log.exception("Failed to render")
        return 1


if __name__ == "__main__":
    sys.exit(main())
