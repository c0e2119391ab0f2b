"""Device-resident pipeline (tpu/pipeline.py) vs the inline oracle.

The jax backend's default path: native stage A -> native tiled pack ->
one-buffer upload -> device stage B with HBM-resident references.  Must
be bit-exact with the inline NumPy decode, including across frames that
reference device-DPB entries, concealed refs, and PCM canvases.
"""
import os

import numpy as np
import pytest

from hevc_tpu import native
from hevc_tpu.decoder.core import Decoder
from hevc_tpu.encoder.core import EncoderConfig, IntraEncoder, RaEncoder
from hevc_tpu.encoder.generate import synth_frame

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")


def _stream(cfg, n=4, kind="noise"):
    frames = [synth_frame(kind, cfg.width, cfg.height, t, seed=3)
              for t in range(n)]
    if cfg.bit_depth > 8:
        frames = [[(p.astype(np.int32) << (cfg.bit_depth - 8)) for p in f]
                  for f in frames]
    if cfg.gop != "ra":
        enc = IntraEncoder(cfg)
        out = bytearray()
        for f in frames:
            out += enc.encode_frame(f)
        return bytes(out)
    return bytes(RaEncoder(cfg).encode(frames))


CONFIGS = {
    "ra_filters": (dict(width=96, height=80, qp=31, gop="ra",
                        deblocking=True, sao=True, split_policy="random",
                        seed=2, max_transform_hierarchy_depth_intra=2), 8),
    "wp": (dict(width=64, height=64, qp=30, gop="lowb",
                weighted_pred=True, search_range=2), 6),
    "pcm": (dict(width=64, height=48, qp=30, pcm=0.5, pcm_bit_depth=6,
                 pcm_loop_filter_disabled=True, deblocking=True), 3),
    "main10_422": (dict(width=64, height=48, qp=30, bit_depth=10,
                        chroma_format_idc=2, gop="ipp"), 3),
    # chroma deblock off the 4:2:0 grid: 4:2:2 rows sample the BS/QP
    # maps at full luma rate, and 4:2:2/4:4:4 QpC = Min(qPi, 51)
    "main10_422_filters": (dict(width=64, height=48, qp=36, bit_depth=10,
                                chroma_format_idc=2, gop="ipp",
                                deblocking=True, sao=True), 3),
    "fmt444_filters": (dict(width=64, height=48, qp=40,
                            chroma_format_idc=3, gop="ipp",
                            deblocking=True, sao=True), 3),
    "scaling": (dict(width=64, height=48, qp=30, scaling_lists="custom",
                     gop="ipp"), 3),
    "amp_qp": (dict(width=64, height=64, qp=30, gop="ra", amp="all",
                    log2_ctb_size=5, cu_qp_delta_depth=1), 8),
    "tiles": (dict(width=96, height=64, qp=30, gop="ipp",
                   tiles=(2, 2)), 3),
    "tmvp": (dict(width=64, height=64, qp=30, gop="lowb", tmvp=True), 6),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pipeline_bitexact(name):
    kw, n = CONFIGS[name]
    stream = _stream(EncoderConfig(**kw), n=n)
    assert os.environ.get("HEVC_TPU_PIPELINE", "1") != "0"
    ref = Decoder(check_md5=True,
                  recon_backend="inline").decode_bytes(stream)
    assert all(f.md5_ok is not False for f in ref)
    got = Decoder(check_md5=True,
                  recon_backend="jax").decode_bytes(stream)
    assert len(ref) == len(got)
    for a, c in zip(ref, got):
        assert c.md5_ok is not False
        for p in range(3):
            assert np.array_equal(a.planes[p], c.planes[p]), \
                f"{name}: plane {p} poc {a.poc}"


def test_pipeline_vs_legacy_jax_path():
    """The pipeline and the per-frame-marshalling jax path agree."""
    kw, n = CONFIGS["ra_filters"]
    stream = _stream(EncoderConfig(**kw), n=n)
    got = Decoder(check_md5=False, recon_backend="jax").decode_bytes(stream)
    os.environ["HEVC_TPU_PIPELINE"] = "0"
    try:
        legacy = Decoder(check_md5=False,
                         recon_backend="jax").decode_bytes(stream)
    finally:
        os.environ.pop("HEVC_TPU_PIPELINE", None)
    for a, c in zip(legacy, got):
        for p in range(3):
            assert np.array_equal(a.planes[p], c.planes[p])
