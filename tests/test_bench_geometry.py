"""Bench-geometry (>=720p) regression: both jax stage-B paths vs oracle.

Round 2 shipped a red bench because no test decoded a bench-sized stream
through the jax device paths: the 1280x720 CTB-64 IPP bench stream uses
SAO, native stage A reports it via pic.has_sao/sao_arrays (not the
sao_map dict), and bench.py's do_sao detection missed it -- every
<=128x80 pipeline test stayed green while the flagship path was wrong.

This decodes the bench's own stream (shared .bench/ cache) through
  (a) finish_frame_jax      (HEVC_TPU_PIPELINE=0, one-jit stage B) and
  (b) the device-resident pipeline (HEVC_TPU_PIPELINE=1, default)
and asserts bit-exactness against the NumPy oracle backend per plane.
Reference contract: verify_md5 /root/reference/libavcodec/hevcdec.c:4035.
"""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@pytest.fixture(scope="module")
def bench_stream():
    import bench
    path = bench.ensure_stream(bench.B720_TAG, 1280, 720, 30, 3,
                               wpp=False)
    return open(path, "rb").read()


@pytest.fixture(scope="module")
def oracle_frames(bench_stream):
    from hevc_tpu.decoder.core import Decoder
    frames = Decoder(recon_backend="plan").decode_bytes(bench_stream)
    assert frames and all(f.md5_ok for f in frames)
    return [[np.asarray(p).copy() for p in f.planes] for f in frames]


@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_bench_geometry_jax_paths(bench_stream, oracle_frames, pipeline):
    from hevc_tpu.decoder.core import Decoder
    old = os.environ.get("HEVC_TPU_PIPELINE")
    os.environ["HEVC_TPU_PIPELINE"] = pipeline
    try:
        frames = Decoder(recon_backend="jax").decode_bytes(bench_stream)
    finally:
        if old is None:
            os.environ.pop("HEVC_TPU_PIPELINE", None)
        else:
            os.environ["HEVC_TPU_PIPELINE"] = old
    assert len(frames) == len(oracle_frames)
    for fi, (got, want) in enumerate(zip(frames, oracle_frames)):
        assert got.md5_ok, f"frame {fi} md5 mismatch (pipeline={pipeline})"
        for p in range(3):
            g = np.asarray(got.planes[p])
            assert (g == want[p]).all(), \
                f"frame {fi} plane {p} mismatch (pipeline={pipeline})"


def test_bench_packed_decode_frame_device(bench_stream):
    """The exact array path bench.py times, asserted bit-exact here."""
    import bench
    bundles = bench.ensure_packed(bench.ensure_stream(
        bench.B720_TAG, 1280, 720, 30, 3, wpp=False))
    import jax.numpy as jnp
    from hevc_tpu.tpu.recon import decode_frame_device, _mc_args
    for bi, b in enumerate(bundles):
        pf = b["pf"]
        log2_ctb, sub_w, sub_h = b["sps"]
        regions = tuple(pf.region[p] for p in range(3))
        sao_t, sao_b, sao_e, sao_c = b["sao"]
        mc_fields, refs_l, refs_c, resid_fields, mc_shapes = _mc_args(pf)
        planes = decode_frame_device(
            jnp.asarray(pf.canvas),
            tuple(jnp.asarray(v) for v in pf.scal),
            tuple(jnp.asarray(v) for v in pf.avail),
            tuple(jnp.asarray(v) for v in pf.levels),
            tuple(jnp.asarray(v) for v in pf.rmeta),
            jnp.asarray(b["qp4"]), jnp.asarray(b["bsv"]),
            jnp.asarray(b["bsh"]),
            b["dbp"]["beta_offset"], b["dbp"]["tc_offset"],
            b["dbp"]["cb_qp_offset"], b["dbp"]["cr_qp_offset"],
            tuple(jnp.asarray(sao_t[p]) for p in range(3)),
            tuple(jnp.asarray(sao_b[p]) for p in range(3)),
            tuple(jnp.asarray(sao_e[p]) for p in range(3)),
            tuple(jnp.asarray(sao_c[p]) for p in range(3)),
            bit_depth=pf.bit_depth, n_chunks=pf.n_chunks,
            regions=regions, do_deblock=b["do_deblock"],
            do_sao=b["do_sao"], ctb_log2=log2_ctb,
            sub_w=sub_w, sub_h=sub_h, mc_shapes=mc_shapes,
            mc_fields=mc_fields, refs_l=refs_l, refs_c=refs_c,
            resid_fields=resid_fields)
        for p, out in enumerate(planes):
            assert (np.asarray(out) == b["ref"][p].astype(np.int32)).all(), \
                f"bundle {bi} plane {p} device pipeline mismatch"
