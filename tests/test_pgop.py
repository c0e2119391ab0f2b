"""Frame-axis parallel decode of independent B frames.

A parallel-B GOP's n B pictures (encoder/pgop.py) decode concurrently
over a ("frame",) mesh, device k reconstructing frame k+1 end to end
with the anchor reference windows replicated — bit-exact vs the
sequential decode (the device-mesh form of the reference's frame
threads, pthread_frame.c:395/484)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from hevc_tpu.decoder.core import Decoder  # noqa: E402
from hevc_tpu.encoder.core import EncoderConfig  # noqa: E402
from hevc_tpu.encoder.generate import synth_frame  # noqa: E402
from hevc_tpu.encoder.pgop import ParallelBGopEncoder  # noqa: E402
from hevc_tpu.tpu.pgop_frame import decode_bframes_frame_axis  # noqa: E402


def _devs(n):
    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"need {n} cpu devices, have {len(devs)}")
    return devs[:n]


@pytest.mark.parametrize("n", [4, 8])
def test_frame_axis_bit_exact(n):
    got, want = decode_bframes_frame_axis(n, _devs(n), width=96,
                                          height=64)
    assert len(got) == n
    for k, (g3, w3) in enumerate(zip(got, want)):
        for p, (g, w) in enumerate(zip(g3, w3)):
            assert (g == w).all(), f"B{k + 1} plane {p} mismatch"
    # distinct content across the frame axis
    assert any((got[0][0] != g[0]).any() for g in got[1:])


def test_pgop_stream_all_backends():
    """The parallel-B stream itself is a conforming stream: decodes
    bit-exact on every backend (and drops cleanly with -t 0)."""
    n_b = 4
    cfg = EncoderConfig(width=96, height=64, qp=30, log2_ctb_size=5,
                        log2_cu_size=5, gop="ra", deblocking=True,
                        sao=True, seed=2, search_range=2)
    enc = ParallelBGopEncoder(cfg, n_b)
    stream = enc.encode([synth_frame("noise", 96, 64, t, seed=4)
                         for t in range(n_b + 2)])
    recons = dict(enc.recons)
    for backend in ("inline", "plan", "jax"):
        frames = Decoder(recon_backend=backend).decode_bytes(stream)
        assert len(frames) == n_b + 2
        for f in frames:
            assert f.md5_ok, f"poc {f.poc} md5 [{backend}]"
            for a, b in zip(f.planes, recons[f.poc]):
                assert (np.asarray(a) == b).all()
    # temporal scalability: tid1 Bs drop, anchors remain
    anchors = Decoder(temporal_layer=0).decode_bytes(stream)
    assert sorted(f.poc for f in anchors) == [0, n_b + 1]


def test_frame_parallel_normal_ra_stream():
    """The GENERAL frame axis: a NORMAL hierarchical-B
    RA stream from the standard encoder decodes with its dependency
    batches level-parallel over the mesh, bit-exact vs sequential, and
    with at least one batch spanning >= 2 frames."""
    devs = _devs(4)
    from hevc_tpu.encoder.core import RaEncoder
    from hevc_tpu.tpu.pgop_frame import decode_frame_parallel

    cfg = EncoderConfig(width=96, height=64, qp=30, log2_ctb_size=5,
                        log2_cu_size=5, gop="ra", deblocking=True,
                        sao=True, seed=3, search_range=2)
    enc = RaEncoder(cfg)
    frames = [synth_frame("noise", 96, 64, t, seed=5) for t in range(6)]
    stream = enc.encode(frames)
    got, want = decode_frame_parallel(stream, devs)
    assert len(got) == 6
    for k, (g3, w3) in enumerate(zip(got, want)):
        for p, (g, w) in enumerate(zip(g3, w3)):
            assert (np.asarray(g) == np.asarray(w)).all(), \
                f"poc {k} plane {p} mismatch"


def test_ref_batches_shape():
    """The batch schedule itself: a 6-frame RA GOP yields at least one
    multi-frame batch (the independent-B level)."""
    import hevc_tpu.decoder.core as dcore
    from hevc_tpu.tpu.pgop_frame import ref_batches

    from hevc_tpu.encoder.core import RaEncoder
    cfg = EncoderConfig(width=64, height=48, qp=32, gop="ra",
                        seed=1, search_range=2)
    enc = RaEncoder(cfg)
    stream = enc.encode([synth_frame("gradient", 64, 48, t)
                         for t in range(6)])
    captured = []
    orig = dcore.execute_plan_numpy

    def capture(pic, plan):
        captured.append((pic, list(plan), None))
        orig(pic, plan)

    dcore.execute_plan_numpy = capture
    try:
        dcore.Decoder(recon_backend="plan").decode_bytes(stream)
    finally:
        dcore.execute_plan_numpy = orig
    batches = ref_batches(captured)
    assert sum(len(b) for b in batches) == len(captured)
    assert any(len(b) >= 2 for b in batches), \
        [len(b) for b in batches]
