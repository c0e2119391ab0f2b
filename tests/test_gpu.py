"""Tests that need a CUDA device: they skip (with a reason) where JAX
finds none.  On a GPU machine:  python -m pytest tests/test_gpu.py -m gpu
(with JAX_PLATFORMS unset, so the GPU backend is available)."""
import numpy as np
import pytest

from hevc_tpu.encoder.core import EncoderConfig, IntraEncoder
from hevc_tpu.encoder.generate import synth_frame


@pytest.fixture
def gpu_device():
    import jax
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")


@pytest.mark.gpu
def test_pipeline_on_gpu_matches_inline(gpu_device):
    import jax

    from hevc_tpu.decoder.core import Decoder
    cfg = EncoderConfig(width=128, height=64, qp=30, gop="ipp",
                        deblocking=True, sao=True, search_range=2)
    enc = IntraEncoder(cfg)
    stream = b"".join(enc.encode_frame(synth_frame("noise", 128, 64, t))
                      for t in range(3))
    ref = Decoder(check_md5=True, recon_backend="inline").decode_bytes(
        stream)
    with jax.default_device(gpu_device):
        got = Decoder(check_md5=True, recon_backend="jax").decode_bytes(
            stream)
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert b.md5_ok
        for p in range(3):
            np.testing.assert_array_equal(a.planes[p], b.planes[p])
