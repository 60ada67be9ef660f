"""Every f32 product and convolution on the render and analysis paths
asks for HIGHEST precision: a GPU may otherwise run an f32 dot or conv in
TF32, and decode_env_from_knots exponentiates that error into the
envelope that the oracle suite holds to 5e-3 of peak."""
from functools import partial

import jax
import jax.numpy as jnp
import pytest

from goofer_tpu.analysis import features
from goofer_tpu.ops import envelope, filters, scan_iir

SR, N_FFT, HOP = 44100, 1024, 256
F32 = jnp.float32


def _spec(*shape, dtype=F32):
    return jax.ShapeDtypeStruct(shape, dtype)


def _decode():
    fn = jax.jit(partial(envelope.decode_env_from_knots, sr=SR,
                         n_fft=N_FFT, n_bins=N_FFT // 2 + 1))
    return fn.lower(_spec(64, 12))


def _knot_errors():
    fn = jax.jit(lambda e: envelope._knot_errors(e, SR, N_FFT)[0])
    return fn.lower(_spec(N_FFT // 2 + 1, 12))


def _analysis():
    fn, *_ = features._analysis_graph(8192, SR, N_FFT, HOP, 75.0, 2, True,
                                      lean=True)
    return fn.lower(_spec(8192))


def _analysis_bucketed():
    n_pad = 8192
    nf = n_pad // HOP + 2
    fn, *_ = features._analysis_graph_bucketed(
        n_pad, SR, N_FFT, HOP, 75.0, 2, True, nf, nf, lean=True)
    i32 = jnp.int32
    return fn.lower(_spec(2, n_pad), _spec(2), _spec(2, nf, dtype=i32),
                    _spec(2, dtype=i32), _spec(2, nf, dtype=i32),
                    _spec(2, dtype=i32))


def _sharded_decode():
    from goofer_tpu.engine.synth import SynthStatic
    from goofer_tpu.parallel import batch, make_mesh

    n = 4096
    st = SynthStatic(sr=SR, n_fft=N_FFT, hop=HOP, n=n)
    t = n // HOP + 1
    fn = batch._decode_and_render_sharded(make_mesh(1, tp=1), st,
                                          N_FFT // 2 + 1)
    knobs = jax.tree.map(lambda v: _spec(*jnp.shape(v)),
                         batch._full_knobs(None))
    return fn.lower(_spec(N_FFT // 2 + 1, 64), _spec(1, 64, t), _spec(1, n),
                    _spec(1, n), _spec(1, 4, t), knobs,
                    _spec(1, 2, dtype=jnp.uint32))


def _blur():
    fn = jax.jit(lambda x: filters.gaussian_blur1d(x, 2.0, axis=0))
    return fn.lower(_spec(N_FFT // 2 + 1, 12))


def _blur_traced():
    fn = jax.jit(lambda x, s: filters.gaussian_blur1d_traced(x, s, 2.0))
    return fn.lower(_spec(4, 100), _spec())


def _butter():
    fn = jax.jit(lambda x, f: scan_iir.dynamic_butter_filter(
        x, f, float(SR), 2.0))
    return fn.lower(_spec(1000), _spec(1000))


SITES = {
    "decode_env_from_knots": _decode,
    "knot_errors": _knot_errors,
    "analysis_graph": _analysis,
    "analysis_graph_bucketed": _analysis_bucketed,
    "sharded_knot_decode": _sharded_decode,
    "gaussian_blur1d": _blur,
    "gaussian_blur1d_traced": _blur_traced,
    "dynamic_butter_filter": _butter,
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_products_ask_for_highest_precision(site):
    text = SITES[site]().as_text()
    ops = [line for line in text.splitlines()
           if "stablehlo.dot_general" in line
           or "stablehlo.convolution" in line]
    assert ops, f"{site}: no dot or convolution in the lowered graph"
    loose = [line.strip() for line in ops if "HIGHEST" not in line]
    assert not loose, loose
