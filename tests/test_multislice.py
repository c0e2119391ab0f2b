"""Multi-slice pictures: per-slice filter parameters + boundary gating.

Covers independent multi-slice emission (CTB-row and
whole-tile-run splits), per-slice deblock overrides/disable, per-slice
SAO toggle, slice_loop_filter_across_slices gating, restricted tile
boundaries (pps_loop_filter_across_tiles=0), and dependent segments
combined with WPP/tiles (the former encoder assert).  Every stream is
bit-exact against the openHEVC oracle AND the encoder's own recon on
the decoder backends (reference semantics: hevc_filter.c:264
sao_filter_CTB edges, :525 deblocking_filter_CTB per-CTB params, :989
boundary-gated BS; hevcdsp_template.c:438 sao_edge_restore_1)."""
import os
import subprocess

import numpy as np
import pytest

from hevc_tpu.decoder.core import Decoder
from hevc_tpu.encoder.core import EncoderConfig, IntraEncoder
from hevc_tpu.encoder.generate import synth_frame

ORACLE = "/root/repo/.oracle/build/hevc_nodisplay"
needs_oracle = pytest.mark.skipif(not os.path.exists(ORACLE),
                                  reason="oracle binary not built")

PER_SLICE = (
    dict(beta_offset=4, tc_offset=-2, lf_across=False),
    dict(disable=True),
    dict(beta_offset=-2, tc_offset=4, sao=False, lf_across=True),
)


def encode(w=96, h=96, n=3, **kw):
    cfg = EncoderConfig(width=w, height=h, qp=30, log2_ctb_size=5,
                        log2_cu_size=5, gop="ipp", seed=2,
                        search_range=2, **kw)
    enc = IntraEncoder(cfg)
    stream = bytearray()
    recons = []
    for t in range(n):
        fr = synth_frame("noise", w, h, t, seed=4)
        stream += enc.encode_frame(fr)
        recons.append([p.copy() for p in enc.recon_planes])
    return bytes(stream), recons


def check(stream, recons, backend):
    frames = Decoder(recon_backend=backend).decode_bytes(stream)
    assert len(frames) == len(recons)
    for f in sorted(frames, key=lambda x: x.poc):
        assert f.md5_ok, f"md5 poc {f.poc} [{backend}]"
        for a, b in zip(f.planes, recons[f.poc]):
            assert (np.asarray(a) == b).all(), \
                f"poc {f.poc} [{backend}] recon mismatch"


def oracle_check(stream, recons, w=96, h=96):
    if not os.path.exists(ORACLE):
        return
    sfile, ofile = "/tmp/msl.265", "/tmp/msl.o"
    with open(sfile, "wb") as f:
        f.write(stream)
    r = subprocess.run([ORACLE, "-i", sfile, "-o", ofile],
                       capture_output=True, text=True, timeout=120,
                       check=False)
    out = open(f"{ofile}_{w}x{h}.yuv", "rb").read()
    want = b"".join(p.astype(np.uint8).tobytes()
                    for rec in recons for p in rec)
    assert out == want, "oracle YUV differs"
    assert "Incorrect MD5" not in (r.stdout + r.stderr)


@needs_oracle
def test_multislice_uniform():
    stream, recons = encode(slices=3, deblocking=True, sao=True)
    oracle_check(stream, recons)
    for backend in ("inline", "plan", "jax"):
        check(stream, recons, backend)


@needs_oracle
def test_multislice_per_slice_params():
    stream, recons = encode(slices=3, deblocking=True, sao=True,
                            slice_filter_params=PER_SLICE)
    oracle_check(stream, recons)
    for backend in ("inline", "plan", "jax"):
        check(stream, recons, backend)


@needs_oracle
def test_multislice_wpp():
    stream, recons = encode(slices=3, wpp=True, deblocking=True,
                            sao=True,
                            slice_filter_params=PER_SLICE[:2])
    oracle_check(stream, recons)
    for backend in ("inline", "jax"):
        check(stream, recons, backend)


@needs_oracle
def test_multislice_tiles():
    """Slices = whole-tile runs (2 tiles per slice)."""
    stream, recons = encode(w=128, h=64, slices=2, tiles=(4, 1),
                            deblocking=True, sao=True,
                            slice_filter_params=(dict(beta_offset=2),
                                                 dict(tc_offset=-2)))
    oracle_check(stream, recons, 128, 64)
    for backend in ("inline", "jax"):
        check(stream, recons, backend)


@needs_oracle
def test_tiles_no_loop_filter_across():
    """pps_loop_filter_across_tiles_enabled = 0: deblock/SAO restricted
    at tile boundaries even with a single slice."""
    stream, recons = encode(w=128, h=64, tiles=(2, 2), deblocking=True,
                            sao=True, lf_across_tiles=False)
    oracle_check(stream, recons, 128, 64)
    for backend in ("inline", "jax"):
        check(stream, recons, backend)


@needs_oracle
def test_dependent_with_wpp():
    stream, recons = encode(dependent_slices=2, wpp=True,
                            deblocking=True, sao=True)
    oracle_check(stream, recons)
    check(stream, recons, "inline")


@needs_oracle
def test_dependent_with_tiles():
    stream, recons = encode(w=128, h=64, dependent_slices=3,
                            tiles=(2, 2), deblocking=True, sao=True)
    oracle_check(stream, recons, 128, 64)
    check(stream, recons, "inline")


def test_multislice_inter_gop():
    """P frames with multi-slice + per-slice params (MC + filters)."""
    stream, recons = encode(n=4, slices=2, deblocking=True, sao=True,
                            slice_filter_params=(
                                dict(beta_offset=2, lf_across=False),
                                dict(tc_offset=2)))
    oracle_check(stream, recons)
    for backend in ("inline", "jax"):
        check(stream, recons, backend)


def test_slice_parallel_stage_a_bit_exact():
    """Slice-parallel native stage A (deferred jobs on worker threads;
    SURVEY §2.2 slice parallelism, reference PARALLEL_SLICE
    hevcdec.c:2909): jax-backend decode of a multi-slice inter stream
    equals the sequential decode and the encoder recon."""
    import os
    stream, recons = encode(n=4, slices=4, deblocking=True, sao=True,
                            slice_filter_params=PER_SLICE)
    check(stream, recons, "jax")  # parallel (default HEVC_TPU_SLICE_MT)
    os.environ["HEVC_TPU_SLICE_MT"] = "0"
    try:
        check(stream, recons, "jax")  # sequential reference
    finally:
        os.environ.pop("HEVC_TPU_SLICE_MT", None)
