#!/bin/sh
# OpenUtau/UTAU resampler launcher: forwards all arguments to the
# goofer_tpu CLI (point OpenUtau's resampler path at this script).
exec python3 -m goofer_tpu.cli "$@"
