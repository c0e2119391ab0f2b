"""Column-band-sharded full stage-B pipeline vs single-device decode.

decode_gop_banded shards MC + residual + intra wavefront + deblock +
SAO over a ("tile",) device mesh, with per-device DPB reference windows
refreshed by ppermute halo exchange.  Every config must be bit-exact
with the 1-device decode of the same stream (the analogue of the
reference's thread-config MD5 equality, SURVEY §4 point 4; tile jobs
hevcdec.c:3144, inter-frame progress gating pthread_frame.c:570).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from jax.sharding import Mesh  # noqa: E402

from hevc_tpu.encoder.core import EncoderConfig, IntraEncoder, RaEncoder
from hevc_tpu.encoder.generate import synth_frame
from hevc_tpu.tpu.band import prepare_gop_banded
from hevc_tpu.tpu.sharded import decode_gop_banded


def _stream(cfg, n=3, kind="noise"):
    frames = [synth_frame(kind, cfg.width, cfg.height, t, seed=4)
              for t in range(n)]
    if cfg.gop == "ra":
        return bytes(RaEncoder(cfg).encode(frames))
    enc = IntraEncoder(cfg)
    out = bytearray()
    for f in frames:
        out += enc.encode_frame(f)
    return bytes(out)


def _mesh(n):
    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"need {n} cpu devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n]), ("tile",))


def _run(cfg_kw, n_bands, n_frames=3, kind="noise"):
    kw = dict(log2_ctb_size=5, log2_cu_size=5, seed=2,
              tiles=(n_bands, 1))
    kw.update(cfg_kw)
    cfg = EncoderConfig(**kw)
    stream = _stream(cfg, n_frames, kind=kind)
    frames, ref, (hl, hc) = prepare_gop_banded(stream, n_bands)
    outs = decode_gop_banded(_mesh(n_bands), frames, halo_l=hl,
                             halo_c=hc)
    for i, (got3, want3) in enumerate(zip(outs, ref)):
        for p, (got, want) in enumerate(zip(got3, want3)):
            g = np.asarray(got)
            assert g.shape == want.shape
            assert (g == want).all(), \
                f"frame {i} plane {p}: {(g != want).sum()} wrong px"
    return frames


@pytest.mark.parametrize("n_bands", [4, 8])
def test_ipp_gop(n_bands):
    frames = _run(dict(width=32 * n_bands, height=96, qp=30, gop="ipp",
                       deblocking=True, sao=True, search_range=3),
                  n_bands)
    assert any(f["spec"]["mc_shapes"] for f in frames)  # real inter


def test_ipp_no_filters():
    _run(dict(width=128, height=64, qp=30, gop="ipp", search_range=2),
         4)


def test_lowb_gop():
    """B frames: two reference lists, bi-prediction across band seams."""
    frames = _run(dict(width=128, height=64, qp=30, gop="lowb",
                       deblocking=True, search_range=2), 4, n_frames=4)
    bi = any(bi for f in frames
             for _ic, bi, *_rest in f["spec"]["mc_shapes"])
    assert bi, "lowb GOP produced no bi-predicted groups"


def test_1080p_class_compile_once():
    """1080p-class tile stream on the full 8-device mesh: bit-exact AND
    the steady-state P frames reuse ONE compiled step (the shape
    bucketing in band.unify_bands + sharded._step_cache, not a fresh
    shard_map compile per frame)."""
    from hevc_tpu.tpu import sharded
    n_bands = 8
    kw = dict(width=2048, height=1088, qp=34, gop="ipp",
              deblocking=True, sao=True, search_range=3,
              log2_ctb_size=6, log2_cu_size=6, seed=2,
              tiles=(n_bands, 1))
    cfg = EncoderConfig(**kw)
    stream = _stream(cfg, 3, kind="gradient")
    frames, ref, (hl, hc) = prepare_gop_banded(stream, n_bands)
    sharded._step_cache.clear()
    outs = decode_gop_banded(_mesh(n_bands), frames, halo_l=hl,
                             halo_c=hc)
    for i, (got3, want3) in enumerate(zip(outs, ref)):
        for p, (got, want) in enumerate(zip(got3, want3)):
            assert (np.asarray(got) == want).all(), \
                f"frame {i} plane {p} mismatch"
    # I frame -> 1 entry; both P frames must share the second
    assert len(sharded._step_cache) <= 2, \
        f"per-frame recompiles: {len(sharded._step_cache)} specs"


def test_streaming_banded_halo_widen(monkeypatch):
    """Streaming banded decode: frames flow from a
    stage-A worker thread through iter_gop_banded, the halo derives
    PER FRAME, and a mid-GOP widening re-shards the device DPB via
    ppermute — output stays bit-exact vs the sequential decode."""
    import hevc_tpu.tpu.band as B
    from hevc_tpu.tpu.band import iter_gop_banded, prepare_gop_banded
    from hevc_tpu.tpu.sharded import decode_stream_banded

    n_bands = 4
    devs = jax.devices("cpu")
    if len(devs) < n_bands:
        pytest.skip("need 4 cpu devices")
    W, H = 32 * n_bands, 96
    enc = IntraEncoder(EncoderConfig(
        width=W, height=H, qp=30, log2_ctb_size=5, log2_cu_size=5,
        gop="ipp", tiles=(n_bands, 1), deblocking=True, sao=True,
        seed=2, search_range=3))
    stream = bytearray()
    for t in range(4):
        stream += enc.encode_frame(synth_frame("noise", W, H, t, seed=4))
    stream = bytes(stream)

    # sequential reference
    _frames, ref_planes, _h = prepare_gop_banded(stream, n_bands)

    # force a mid-GOP halo widening: later frames report a bigger bound
    orig_rh = B.required_halo_frame
    calls = {"n": 0}

    def bumped(plan, sps, nb):
        hl, hc = orig_rh(plan, sps, nb)
        calls["n"] += 1
        if calls["n"] >= 3:
            hl, hc = hl + 8, hc + 4
        return hl, hc

    monkeypatch.setattr(B, "required_halo_frame", bumped)
    mesh = Mesh(np.asarray(devs[:n_bands]), ("tile",))
    halos = []
    outs = []

    def tap(it):
        for fb, halo in it:
            halos.append(halo)
            yield fb, halo

    outs = decode_stream_banded(mesh, tap(iter_gop_banded(
        stream, n_bands, margin_l=0, margin_c=0)))
    assert len(set(halos)) >= 2, f"halo never widened: {halos}"
    assert len(outs) == len(ref_planes)
    for i, (got3, want3) in enumerate(zip(outs, ref_planes)):
        for p, (got, want) in enumerate(zip(got3, want3)):
            assert (np.asarray(got) == want).all(), \
                f"streaming banded diverged: frame {i} plane {p}"
