"""Randomized encoder-config fuzz matrix vs the oracle.

The repo's fixed tests exercise hand-picked configs; this matrix samples
the SYNTAX PRODUCT SPACE (CTB/CU/TU policies x chroma format x bit depth
x slices x tiles x WPP x rext tools x GOP shapes x IRAP patterns x QP
maps x PCM x WP x LT refs) with seeded, reproducible draws, and checks
the full triangle on every stream:

    encoder recon  ==  our decoder (md5-checked)  ==  oracle YUV

plus a decode-only corruption corpus (bit flips, truncation, NAL drops)
asserting the decoder survives arbitrary damage without crashing or
hanging (graceful concealment; reference analogue: the conformance
suite's error streams, /root/reference/README.md:14-21).

Repro: each case prints its config on failure; re-run with
`pytest tests/test_fuzz_matrix.py -k <seed>`.
"""
import os
import subprocess

import numpy as np
import pytest

from hevc_tpu.decoder.core import Decoder
from hevc_tpu.encoder.core import EncoderConfig, IntraEncoder

ORACLE = "/root/repo/.oracle/build/hevc_nodisplay"
needs_oracle = pytest.mark.skipif(not os.path.exists(ORACLE),
                                  reason="oracle binary not built")

N_CONFIGS = 56


def _sample_config(rng):
    """One valid config drawn from the syntax matrix (constraint-repair
    sampler: every draw is independent; illegal combinations are
    repaired the way the encoder's own asserts demand)."""
    log2_ctb = int(rng.choice([4, 5, 6], p=[0.3, 0.4, 0.3]))
    w = int(rng.choice([48, 64, 80, 96, 120]))
    h = int(rng.choice([32, 48, 64, 72]))
    chroma = int(rng.choice([1, 1, 1, 2, 3]))
    bd = int(rng.choice([8, 8, 8, 10, 12]))
    gop = str(rng.choice(["all_intra", "ipp", "ipp", "lowb", "ra"]))
    kw = dict(
        width=w, height=h, qp=int(rng.integers(20, 45)),
        log2_ctb_size=log2_ctb,
        log2_cu_size=int(rng.integers(3, log2_ctb + 1)),
        chroma_format_idc=chroma, bit_depth=bd,
        split_policy=str(rng.choice(["fixed", "variance", "random"])),
        max_transform_hierarchy_depth_intra=int(rng.integers(0, 3)),
        nxn_probability=float(rng.uniform(0.2, 0.8)),
        tu_split_probability=float(rng.uniform(0.2, 0.8)),
        seed=int(rng.integers(0, 1 << 30)),
        transform_skip=bool(rng.random() < 0.3),
        deblocking=bool(rng.random() < 0.5),
        sao=bool(rng.random() < 0.5),
        gop=gop,
        search_range=int(rng.integers(1, 4)),
    )
    inter = gop != "all_intra"
    if inter:
        kw["tmvp"] = bool(rng.random() < 0.4)
        kw["weighted_pred"] = bool(rng.random() < 0.25)
        if gop in ("ipp", "lowb") and rng.random() < 0.25:
            kw["long_term_ref"] = True if rng.random() < 0.5 else "mod"
    if gop == "ra" and rng.random() < 0.4:
        kw["cra_anchors"] = True
    # parallel entropy structures: wpp, tiles, or wpp-in-tiles
    r = rng.random()
    if r < 0.3:
        kw["wpp"] = True
    elif r < 0.55:
        ctb = 1 << log2_ctb
        kw["tiles"] = (min(int(rng.integers(1, 3)), max(1, w // ctb)),
                       min(int(rng.integers(1, 3)), max(1, h // ctb)))
        if kw["tiles"] == (1, 1):
            kw.pop("tiles")
        elif rng.random() < 0.3:
            kw["wpp"] = True
        if "tiles" in kw and rng.random() < 0.3:
            kw["lf_across_tiles"] = False
    if rng.random() < 0.3:
        nt = kw.get("tiles", (1, 1))[0] * kw.get("tiles", (1, 1))[1]
        ctb_rows = max(1, h >> log2_ctb)
        slices = min(int(rng.integers(2, 4)), max(2, ctb_rows))
        if nt > 1:
            slices = nt  # whole-tile runs
        if slices > 1:
            kw["slices"] = slices
        if rng.random() < 0.5:
            kw["slice_filter_params"] = (
                {"beta_offset": 2, "tc_offset": -2},
                {"disable": True},
                {"lf_across": False})
    elif rng.random() < 0.2 and not kw.get("wpp"):
        kw["dependent_slices"] = int(rng.integers(1, 3))
    if rng.random() < 0.2:
        kw["pcm"] = "all" if rng.random() < 0.3 else 0.4
        kw["pcm_bit_depth"] = int(rng.choice([0, max(8, bd - 2)]))
        kw["pcm_loop_filter_disabled"] = bool(rng.random() < 0.5)
    if rng.random() < 0.25:
        kw["cu_qp_delta_depth"] = int(rng.integers(0, 2))
    if inter and log2_ctb <= 5 and rng.random() < 0.25:
        kw["amp"] = 0.6
    if rng.random() < 0.2:
        kw["scaling_lists"] = str(rng.choice(["default", "custom"]))
    # rext tools
    if rng.random() < 0.3:
        if kw["transform_skip"] and rng.random() < 0.5:
            kw["rext_persistent_rice"] = True
            kw["rext_ts_context"] = bool(rng.random() < 0.5)
        if kw["transform_skip"] and not kw.get("scaling_lists") \
                and rng.random() < 0.4:
            kw["rext_ts_rotation"] = True
        if rng.random() < 0.3:
            kw["rext_implicit_rdpcm"] = True
            kw["transform_skip"] = True
        if inter and log2_ctb <= 5 and rng.random() < 0.25:
            kw["rext_explicit_rdpcm"] = True
        if chroma == 3 and rng.random() < 0.4:
            kw["rext_ccp"] = True
        if rng.random() < 0.3:
            kw["rext_chroma_qp_offsets"] = ((2, -2), (0, 3))
    return EncoderConfig(**kw)


def _frames_for(cfg, rng, n):
    sub_w = 2 if cfg.chroma_format_idc in (1, 2) else 1
    sub_h = 2 if cfg.chroma_format_idc == 1 else 1
    w, h = cfg.width, cfg.height
    hi = (1 << cfg.bit_depth) - 1
    base = [rng.integers(0, 256, (h, w)),
            rng.integers(0, 256, (h // sub_h, w // sub_w)),
            rng.integers(0, 256, (h // sub_h, w // sub_w))]
    # smooth half the content so inter prediction + filters engage
    for p in base:
        p[: p.shape[0] // 2] = (p[: p.shape[0] // 2] // 8) * 8
    out = []
    for t in range(n):
        planes = [np.roll(p, (t * 3, t * 5), (0, 1)) for p in base]
        scale = (hi + 1) // 256
        out.append([np.clip(p * scale, 0, hi).astype(
            np.uint8 if cfg.bit_depth == 8 else np.uint16)
            for p in planes])
    return out


def _flatten(recons, bd):
    dt = "u1" if bd == 8 else "<u2"
    return b"".join(np.asarray(p).astype(dt).tobytes()
                    for planes in recons for p in planes)


def _oracle_yuv(stream, w, h, tmp_path):
    sfile = str(tmp_path / "t.265")
    with open(sfile, "wb") as f:
        f.write(stream)
    ofile = str(tmp_path / "o")
    r = subprocess.run([ORACLE, "-i", sfile, "-o", ofile],
                       capture_output=True, text=True, timeout=120,
                       check=False)
    yuv = f"{ofile}_{w}x{h}.yuv"
    if not os.path.exists(yuv):
        raise AssertionError(
            f"oracle produced no output: {r.stdout[-400:]} "
            f"{r.stderr[-400:]}")
    return open(yuv, "rb").read()


@needs_oracle
@pytest.mark.parametrize("seed", range(N_CONFIGS))
def test_fuzz_config(seed, tmp_path):
    rng = np.random.default_rng(911 + seed)
    cfg = _sample_config(rng)
    n = 1 if cfg.gop == "all_intra" else (4 if cfg.gop == "ra" else 3)
    frames = _frames_for(cfg, rng, n)
    try:
        enc = IntraEncoder(cfg)
        stream = bytearray()
        recons = []
        for planes in frames:
            stream += enc.encode_frame(planes)
            recons.append([p.copy() for p in enc.recon_planes])
    except AssertionError as e:
        pytest.fail(f"seed {seed}: encoder rejected config {cfg}: {e}")
    decoded = Decoder().decode_bytes(bytes(stream))
    assert len(decoded) == len(frames), f"seed {seed}: {cfg}"
    for k, (df, rec) in enumerate(zip(decoded, recons)):
        assert df.md5_ok, f"seed {seed} frame {k} md5: {cfg}"
        for a, b in zip(df.planes, rec):
            assert (np.asarray(a) == b).all(), \
                f"seed {seed} frame {k}: {cfg}"
    got = _oracle_yuv(bytes(stream), cfg.width, cfg.height, tmp_path)
    want = _flatten(recons, cfg.bit_depth)
    if cfg.pcm and cfg.pcm_loop_filter_disabled and cfg.sao:
        # ORACLE QUIRK: the openHEVC fork's restore_tqb_pixels only
        # partially restores CHROMA under SAO + pcm_loop_filter_disabled
        # (neither spec-restored nor plain-SAO output); the spec (8.7.3)
        # exempts every component at the co-located luma PCM flag, which
        # is what this repo implements.  Compare luma only here; the
        # enc==dec md5 triangle above still covers chroma.
        b = 2 if cfg.bit_depth > 8 else 1
        sw = 2 if cfg.chroma_format_idc in (1, 2) else 1
        sh = 2 if cfg.chroma_format_idc == 1 else 1
        ysz = cfg.width * cfg.height * b
        csz = (cfg.width // sw) * (cfg.height // sh) * b
        fsz = ysz + 2 * csz
        for t in range(len(recons)):
            assert got[t * fsz:t * fsz + ysz] == \
                want[t * fsz:t * fsz + ysz], \
                f"seed {seed}: oracle luma diverged for {cfg}"
    else:
        assert got == want, f"seed {seed}: oracle diverged for {cfg}"


# ---------------------------------------------------------------------------
# decode-only corruption corpus
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus_stream():
    cfg = EncoderConfig(width=96, height=64, qp=30, gop="ipp",
                        search_range=2, deblocking=True, sao=True,
                        wpp=True, seed=7)
    enc = IntraEncoder(cfg)
    rng = np.random.default_rng(3)
    stream = bytearray()
    for t in range(3):
        y = rng.integers(0, 256, (64, 96)).astype(np.uint8)
        cb = rng.integers(0, 256, (32, 48)).astype(np.uint8)
        cr = rng.integers(0, 256, (32, 48)).astype(np.uint8)
        stream += enc.encode_frame([np.roll(y, t, 0), cb, cr])
    return bytes(stream)


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_bitflip(seed, corpus_stream):
    """Damaged streams must never crash or hang the decoder — any
    outcome in {decoded frames (possibly concealed, md5_ok False),
    controlled exception} is acceptable; a segfault/hang is not
    (reference analogue: hevcdec.c error paths + concealment)."""
    rng = np.random.default_rng(4242 + seed)
    data = bytearray(corpus_stream)
    mode = seed % 4
    if mode == 0:      # flip random bits (skip start-code area)
        for _ in range(int(rng.integers(1, 12))):
            i = int(rng.integers(16, len(data)))
            data[i] ^= 1 << int(rng.integers(0, 8))
    elif mode == 1:    # truncate mid-stream
        data = data[: int(rng.integers(8, len(data)))]
    elif mode == 2:    # drop a whole NAL (resilience / concealment)
        import re as _re
        pos = [m.start() for m in _re.finditer(b"\x00\x00\x01",
                                               bytes(data))]
        k = int(rng.integers(0, len(pos)))
        end = pos[k + 1] if k + 1 < len(pos) else len(data)
        del data[pos[k]:end]
    else:              # garbage tail
        data += bytes(rng.integers(0, 256, 64, dtype=np.uint8))
    try:
        frames = Decoder(check_md5=True).decode_bytes(bytes(data))
        assert isinstance(frames, list)
    except Exception:
        pass  # controlled failure is acceptable; crash/hang is not
