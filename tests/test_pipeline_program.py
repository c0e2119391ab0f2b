"""Properties of the production stage-B program (tpu/pipeline.py).

* Residual levels upload dense or as COO (index, value) pairs, chosen
  per frame by pack_frame_pipeline; both uploads decode bit-exactly.
* `_pipeline_frame` is integer arithmetic throughout: no floating-point
  value, dot_general or convolution appears in its jaxpr, so the GPU's
  TF32 matmul rounding cannot reach it and results are exact.
"""
import jax
import jax.extend.core as jcore
import numpy as np
import pytest

import hevc_tpu.tpu.pipeline as pl
from hevc_tpu import native
from hevc_tpu.decoder.core import Decoder
from hevc_tpu.encoder.core import EncoderConfig, IntraEncoder
from hevc_tpu.encoder.generate import synth_frame


def _stream(n=3, **kw):
    cfg = EncoderConfig(**dict(dict(width=64, height=64, qp=30, gop="ipp",
                                    deblocking=True, sao=True), **kw))
    enc = IntraEncoder(cfg)
    out = bytearray()
    for t in range(n):
        f = synth_frame("noise", cfg.width, cfg.height, t, seed=3)
        if cfg.bit_depth > 8:
            f = [p.astype(np.int32) << (cfg.bit_depth - 8) for p in f]
        out += enc.encode_frame(f)
    return bytes(out)


def _decode_capturing(stream):
    """jax-backend decode; returns (frames, [args of each
    _pipeline_frame call])."""
    calls = []
    orig = pl._pipeline_frame

    def wrapper(*args):
        calls.append(args)
        return orig(*args)

    pl._pipeline_frame = wrapper
    try:
        frames = Decoder(check_md5=True,
                         recon_backend="jax").decode_bytes(stream)
    finally:
        pl._pipeline_frame = orig
    return frames, calls


@pytest.fixture(scope="module")
def native_stage_a():
    if not native.available():
        pytest.skip("native stage A unavailable (no C++ toolchain)")


@pytest.mark.parametrize("upload", ["dense", "coo"])
def test_residual_upload_forms_bitexact(native_stage_a, monkeypatch,
                                        upload):
    monkeypatch.setattr(pl, "COO_MIN_COEFFS",
                        0 if upload == "coo" else 1 << 40)
    stream = _stream()
    ref = Decoder(check_md5=True, recon_backend="inline").decode_bytes(
        stream)
    got, calls = _decode_capturing(stream)
    coo = [dict(a[-1])["coo"][0] for a in calls]
    if upload == "coo":
        assert any(coo), "no frame took the COO upload"
    else:
        assert not any(coo)
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert b.md5_ok
        for p in range(3):
            np.testing.assert_array_equal(a.planes[p], b.planes[p])


def _walk(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            subs = v if isinstance(v, (tuple, list)) else (v,)
            for sub in subs:
                if isinstance(sub, jcore.ClosedJaxpr):
                    yield from _walk(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    yield from _walk(sub)


def _is_float(aval):
    return hasattr(aval, "dtype") and \
        np.issubdtype(aval.dtype, np.floating)


@pytest.mark.parametrize("name,kw", [
    ("main_ipp", {}),
    ("main10_422", dict(bit_depth=10, chroma_format_idc=2)),
    ("scaling_lists", dict(scaling_lists="custom")),
])
def test_pipeline_frame_is_integer_only(native_stage_a, name, kw):
    _frames, calls = _decode_capturing(_stream(n=2, **kw))
    kinds = {bool(a[7]) for a in calls}
    assert kinds == {False, True}, "want an intra and an inter frame"
    for args in calls:
        closed = jax.make_jaxpr(pl._pipeline_frame,
                                static_argnums=(10,))(*args)
        prims = set()
        for eqn in _walk(closed.jaxpr):
            prims.add(eqn.primitive.name)
            avals = [v.aval for v in eqn.invars + eqn.outvars
                     if hasattr(v, "aval")]
            assert not any(_is_float(a) for a in avals), \
                f"{name}: float value in {eqn.primitive.name}"
        assert "conv_general_dilated" not in prims
        assert "dot_general" in prims   # the int32 IDCT matmuls
