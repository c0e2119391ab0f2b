"""Column-band sharding of the FULL stage-B pipeline over a device mesh.

The device-mesh analogue of the reference's tile parallelism applied to
the whole reconstruction stage, not just the filters (reference:
hevcdec.c:3144 hls_decode_entry_tiles per-tile jobs, :3292 tiles_filters
seam pass, pthread_frame.c:570 ff_thread_report/await_progress row
gating of inter-frame MC reads).  For a tile-coded stream (N column
tiles), the frame splits into N equal bands, one per device:

  * intra prediction / residual / wavefront recon never cross a tile
    edge (availability is tile-masked), so each band's packed chunks
    are fully local;
  * MC *does* cross tile edges (prediction units read any reference
    pixels), so each device's DPB keeps its band of every reference
    frame extended by an MV-range halo: after a frame is decoded, bands
    exchange `halo_l` (luma) / `halo_c` (chroma) edge columns with both
    neighbours over the mesh (jax.lax.ppermute — NVLink between cards)
    before the next frame's MC reads them;
  * deblock + SAO reuse the existing seam halo pass (tpu/sharded.py).

Bit-exactness contract: decode_gop_banded over any mesh size equals the
single-device decode of the same stream (tests/test_band_pipeline.py,
__graft_entry__.dryrun_multichip).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np

from .pack import DUMP, PAD_REF, pack_frame, region_offsets


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _pow2_at_least(x):
    return 1 << max(0, (x - 1).bit_length())


# ---------------------------------------------------------------------------
# band packing (host)
# ---------------------------------------------------------------------------

class _BandSPS:
    """SPS view of one column band (width replaced, rest forwarded)."""

    def __init__(self, sps, band_w):
        self._sps = sps
        self.width = band_w

    def __getattr__(self, name):
        return getattr(self._sps, name)


class _BandPic:
    """PictureState view of one column band for pack_frame: availability
    queries translate band-local luma coords to frame coords."""

    def __init__(self, pic, band_x0, band_w):
        self._pic = pic
        self._x0 = band_x0
        self.sps = _BandSPS(pic.sps, band_w)
        self.scaling = getattr(pic, "scaling", None)
        self.ref_list_l0 = getattr(pic, "ref_list_l0", []) or []
        self.ref_list_l1 = getattr(pic, "ref_list_l1", []) or []

    def available(self, xl, yl, xn, yn):
        return self._pic.available(xl + self._x0, yl, xn + self._x0, yn)


def split_plan_bands(pic, plan, n_bands):
    """Partition a frame's BlockRecords into column bands, band-local x.

    Requires tile columns aligned with the bands so that no intra record
    predicts across a band edge (enforced by the caller encoding the
    stream with tiles=(n_bands, 1))."""
    sps = pic.sps
    band_w = sps.width // n_bands
    assert band_w * n_bands == sps.width
    out = [[] for _ in range(n_bands)]
    for r in plan:
        sx = sps.sub_w if r.plane else 1
        xl = r.x * sx
        k = xl // band_w
        out[k].append(dataclasses.replace(r, x=r.x - k * band_w // sx))
    return out, band_w


def pack_frame_bands(pic, plan, n_bands, halo_l=32, halo_c=16):
    """Per-band PackedFrames with band-windowed reference planes.

    MC row x coords are rebased so each band's reference window is its
    columns extended by halo_l/halo_c on both sides (vertical padding
    stays PAD_REF).  Asserts every MV stays inside the halo — the halo
    is the band-sharded MV-range bound (SURVEY §5: max |MV| + 7/3 tap
    extension)."""
    band_plans, band_w = split_plan_bands(pic, plan, n_bands)
    sps = pic.sps
    pfs = []
    for k in range(n_bands):
        bp = _BandPic(pic, k * band_w, band_w)
        pf = pack_frame(bp, band_plans[k])
        pf = _rebase_band_refs(pf, sps, k, band_w, halo_l, halo_c)
        pfs.append(pf)
    return pfs, band_w


def _rebase_band_refs(pf, sps, k, band_w, halo_l, halo_c):
    """Slice the (globally padded) reference planes to the band window
    and rebase MC row x coords from PAD_REF- to halo-relative."""
    if pf.refs_l is None or not pf.mc_groups:
        return pf
    bw_c = band_w // sps.sub_w
    x0_l = k * band_w
    x0_c = k * bw_c
    refs_l = np.ascontiguousarray(
        pf.refs_l[:, :, x0_l + PAD_REF - halo_l:
                  x0_l + PAD_REF + band_w + halo_l])
    refs_c = np.ascontiguousarray(
        pf.refs_c[:, :, x0_c + PAD_REF - halo_c:
                  x0_c + PAD_REF + bw_c + halo_c])
    groups = []
    for is_ch, bi, w, h, wp, fields in pf.mc_groups:
        f = fields.copy()
        shift = PAD_REF - (halo_c if is_ch else halo_l)
        f[:, 2] -= shift
        if bi:
            f[:, 7] -= shift
        ext = 3 if is_ch else 7
        wp_ = refs_c.shape[2] if is_ch else refs_l.shape[2]
        if not ((f[:, 2] >= 0).all()
                and (f[:, 2] + w + ext <= wp_).all()):
            raise BandHaloExceeded("MV exceeds band halo")
        if bi and not ((f[:, 7] >= 0).all()
                       and (f[:, 7] + w + ext <= wp_).all()):
            raise BandHaloExceeded("MV exceeds band halo")
        groups.append((is_ch, bi, w, h, wp, f))
    return dataclasses.replace(pf, mc_groups=tuple(groups),
                               refs_l=refs_l, refs_c=refs_c)


def unify_bands(pfs):
    """Pad per-band PackedFrames to a common spec and stack on a leading
    band axis — shard_map needs identical per-shard shapes.

    Returns (arrays dict of np stacks, spec dict of statics).  Counts
    are bucketed (pow2 / multiple-of-16) so successive frames of a
    stream usually land on the SAME shapes — together with
    sharded._step_cache this makes the per-frame shard_map compile
    once per geometry instead of once per frame."""
    n = len(pfs)
    n_chunks = _round_up(max(pf.n_chunks for pf in pfs), 16)
    B = [_pow2_at_least(max(pf.scal[c].shape[1] for pf in pfs))
         for c in range(4)]
    nlv = [_round_up(max(pf.levels[c].shape[0] for pf in pfs) + 1, 16)
           for c in range(4)]

    scal, avail, levels, rmeta = [], [], [], []
    for c in range(4):
        a = np.zeros((n, n_chunks, B[c], 8), np.int32)
        a[:, :, :, 0] = DUMP
        a[:, :, :, 1] = DUMP
        a[:, :, :, 2] = 1
        v = np.zeros((n, n_chunks, B[c], 128), bool)
        lv = np.zeros((n, nlv[c], 4 << c, 4 << c), np.int32)
        rm = np.zeros((n, nlv[c], 9), np.int32)
        for k, pf in enumerate(pfs):
            s = pf.scal[c]
            a[k, :s.shape[0], :s.shape[1]] = s
            v[k, :s.shape[0], :s.shape[1]] = pf.avail[c]
            lv[k, :pf.levels[c].shape[0]] = pf.levels[c]
            rm[k, :pf.rmeta[c].shape[0]] = pf.rmeta[c]
        scal.append(a)
        avail.append(v)
        levels.append(lv)
        rmeta.append(rm)

    # MC groups: union of keys, rows padded with DUMP-target lanes
    keys = sorted({(ic, bi, w, h, wp)
                   for pf in pfs
                   for ic, bi, w, h, wp, _ in pf.mc_groups})
    mc_fields = []
    mc_shapes = []
    for key in keys:
        ic, bi, w, h, wp = key
        per_band = []
        for pf in pfs:
            got = None
            for ic2, bi2, w2, h2, wp2, f in pf.mc_groups:
                if (ic2, bi2, w2, h2, wp2) == key:
                    got = f
                    break
            per_band.append(got)
        ncols = next(f.shape[1] for f in per_band if f is not None)
        rows = max(f.shape[0] for f in per_band if f is not None)
        rows = _pow2_at_least(rows)
        stack = np.zeros((n, rows, ncols), np.int32)
        # padding lanes: read ref (0,0), scatter to DUMP (dropped)
        cyx = 10 if bi else 5
        stack[:, :, cyx] = DUMP
        stack[:, :, cyx + 1] = DUMP
        for k, f in enumerate(per_band):
            if f is not None:
                stack[k, :f.shape[0]] = f
        mc_fields.append(stack)
        mc_shapes.append(key)

    resid_fields = []
    for c in range(4):
        rows = max(pf.resid_groups[c].shape[0] if pf.resid_groups else 0
                   for pf in pfs)
        rows = _pow2_at_least(rows) if rows else 0
        g = np.full((n, rows, 3), DUMP, np.int32)
        g[:, :, 2] = 0
        for k, pf in enumerate(pfs):
            if pf.resid_groups:
                r = pf.resid_groups[c]
                g[k, :r.shape[0]] = r
        resid_fields.append(g)

    arrays = dict(
        canvas=np.stack([pf.canvas for pf in pfs]),
        scal=tuple(scal), avail=tuple(avail),
        levels=tuple(levels), rmeta=tuple(rmeta),
        mc_fields=tuple(mc_fields),
        resid_fields=tuple(resid_fields),
        refs_l=np.stack([pf.refs_l for pf in pfs]),
        refs_c=np.stack([pf.refs_c for pf in pfs]),
    )
    spec = dict(
        n_chunks=n_chunks,
        bit_depth=pfs[0].bit_depth,
        regions=tuple(pfs[0].region[p] for p in range(3)),
        mc_shapes=tuple(mc_shapes),
        scale_bank=pfs[0].scale_bank,
        n_refs=pfs[0].refs_l.shape[0] if pfs[0].mc_groups else 0,
    )
    return arrays, spec


class BandHaloExceeded(Exception):
    """A frame's MV bound exceeds the current band halo (or a whole
    band) — streaming consumers catch this and re-shard with a wider
    halo instead of dying."""


def required_halo_frame(plan, sps, n_bands):
    """Per-frame halo bound — required_halo over a single plan, for
    streaming consumers that cannot walk the whole GOP first."""
    return required_halo([plan], sps, n_bands)


def required_halo(plans, sps, n_bands):
    """Derive the band reference-window halo from the stream's actual
    MV bound: for every MC record, how far its qpel/epel read window
    overhangs its band (SURVEY §5: max |MV| + 7/3-tap extension;
    replaces the fixed halo + assert of round 3).  Returns
    (halo_l, halo_c) in luma/chroma columns, 8/4-aligned."""
    band_w = sps.width // n_bands
    hl, hc = 8, 4  # floors: keep ppermute slices non-trivial
    for plan in plans:
        for r in plan:
            if r.kind != "mc":
                continue
            mvs = [r.mv] + ([r.mv1] if r.bi else [])
            if r.plane == 0:
                bwc = band_w
                x0b = (r.x // bwc) * bwc
                for mv in mvs:
                    rx = r.x + (mv[0] >> 2) - 3
                    hl = max(hl, x0b - rx,
                             rx + r.size + 7 - (x0b + bwc))
            else:
                hs = sps.sub_w - 1
                bwc = band_w // sps.sub_w
                x0b = (r.x // bwc) * bwc
                for mv in mvs:
                    rx = r.x + (mv[0] >> (2 + hs)) - 1
                    hc = max(hc, x0b - rx,
                             rx + r.size + 3 - (x0b + bwc))
    hl = _round_up(hl, 8)
    hc = _round_up(hc, 4)
    if hl > band_w or hc > band_w // sps.sub_w:
        raise BandHaloExceeded(
            "MV range exceeds one band: need more halo than a "
            "neighbour has — use fewer/wider bands")
    return hl, hc


def prepare_gop_banded(stream: bytes, n_bands, halo_l="auto",
                       halo_c="auto"):
    """Decode a stream's stage A and build per-frame banded bundles for
    sharded.decode_gop_banded.

    halo_l/halo_c: reference-window halo columns; "auto" derives them
    from the stream's measured MV bound (required_halo).

    Returns (frames, ref_planes, (halo_l, halo_c)): frames = list of
    bundle dicts; ref_planes = the single-device decoded output planes
    (the bit-exactness reference)."""
    import hevc_tpu.decoder.core as dcore
    from .recon import pack_sao_params

    captured = []
    orig = dcore.execute_plan_numpy

    def capture(pic, plan):
        entry = dict(pic=pic, plan=list(plan),
                     ref_pocs_l0=[p for p, _ in
                                  (getattr(pic, "ref_list_l0", []) or [])],
                     ref_pocs_l1=[p for p, _ in
                                  (getattr(pic, "ref_list_l1", []) or [])],
                     dbp=getattr(pic, "deblock_params", None))
        captured.append(entry)
        orig(pic, plan)

    dcore.execute_plan_numpy = capture
    try:
        decoded = dcore.Decoder(recon_backend="plan").decode_bytes(stream)
    finally:
        dcore.execute_plan_numpy = orig
    assert len(decoded) == len(captured)
    if halo_l == "auto" or halo_c == "auto":
        hl, hc = required_halo([e["plan"] for e in captured],
                               captured[0]["pic"].sps, n_bands)
        halo_l = hl if halo_l == "auto" else halo_l
        halo_c = hc if halo_c == "auto" else halo_c
    # decoded is output (display) order; captured is decode order —
    # match by POC (pic.poc is stamped by Decoder._finish_picture)
    by_poc = {fr.poc: fr for fr in decoded}

    frames = [_bundle_frame(ent, n_bands, halo_l, halo_c)
              for ent in captured]
    ref_planes = [[np.asarray(p) for p in by_poc[ent["pic"].poc].planes]
                  for ent in captured]
    return frames, ref_planes, (halo_l, halo_c)


def _bundle_frame(ent, n_bands, halo_l, halo_c):
    """One frame's banded bundle for sharded.decode_gop_banded."""
    from .recon import pack_sao_params
    pic = ent["pic"]
    sps = pic.sps
    pfs, _band_w = pack_frame_bands(pic, ent["plan"], n_bands,
                                    halo_l, halo_c)
    arrays, spec = unify_bands(pfs)
    dbp = ent["dbp"]
    do_deblock = dbp is not None
    if do_deblock:
        pic.compute_bs()
    sao_t, sao_b, sao_o, sao_e = pack_sao_params(pic)
    do_sao = bool(getattr(pic, "has_sao", False)) \
        or bool(getattr(pic, "sao_map", None))
    return dict(
        arrays=arrays, spec=spec, poc=pic.poc,
        ref_pocs_l0=ent["ref_pocs_l0"],
        ref_pocs_l1=ent["ref_pocs_l1"],
        qp4=pic.qp_y.astype(np.int32),
        bs_v=pic.bs_v.astype(np.int32),
        bs_h=pic.bs_h.astype(np.int32),
        dboff=[dbp["beta_offset"], dbp["tc_offset"],
               dbp["cb_qp_offset"], dbp["cr_qp_offset"]]
        if do_deblock else [0, 0, 0, 0],
        sao=(np.asarray(sao_t), np.asarray(sao_b),
             np.asarray(sao_o), np.asarray(sao_e)),
        do_deblock=do_deblock, do_sao=do_sao,
        ctb_log2=sps.log2_ctb_size,
        sub_w=sps.sub_w, sub_h=sps.sub_h,
    )


def iter_gop_banded(stream: bytes, n_bands, margin_l=16, margin_c=8):
    """STREAMING banded stage-A: yield per-frame bundles AS stage A
    finishes each picture (no whole-GOP plan walk).

    The halo is derived PER FRAME (required_halo_frame) and widened
    with a margin whenever a frame's MV bound outgrows it; each yield
    is (bundle, (halo_l, halo_c)) and a consumer re-shards (see
    sharded.decode_stream_banded) on halo change instead of dying.

    Stage A runs on a worker thread feeding a queue, so the consumer
    overlaps device work with parsing — frames stream out before the
    GOP completes."""
    import queue
    import threading

    import hevc_tpu.decoder.core as dcore

    q = queue.Queue(maxsize=4)
    DONE = object()

    def produce():
        orig = dcore.execute_plan_numpy

        def capture(pic, plan):
            orig(pic, plan)
            q.put(dict(pic=pic, plan=list(plan),
                       ref_pocs_l0=[p for p, _ in
                                    (getattr(pic, "ref_list_l0", [])
                                     or [])],
                       ref_pocs_l1=[p for p, _ in
                                    (getattr(pic, "ref_list_l1", [])
                                     or [])],
                       dbp=getattr(pic, "deblock_params", None)))

        dcore.execute_plan_numpy = capture
        try:
            dcore.Decoder(recon_backend="plan").decode_bytes(stream)
            q.put(DONE)
        except BaseException as e:  # noqa: BLE001 — surface to consumer
            q.put(e)
        finally:
            dcore.execute_plan_numpy = orig

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    halo_l = halo_c = 0
    while True:
        ent = q.get()
        if ent is DONE:
            break
        if isinstance(ent, BaseException):
            raise ent
        sps = ent["pic"].sps
        hl, hc = required_halo_frame(ent["plan"], sps, n_bands)
        if hl > halo_l or hc > halo_c:
            band_w = sps.width // n_bands
            halo_l = min(_round_up(max(hl + margin_l, halo_l), 8),
                         band_w)
            halo_c = min(_round_up(max(hc + margin_c, halo_c), 4),
                         band_w // sps.sub_w)
        yield _bundle_frame(ent, n_bands, halo_l, halo_c), \
            (halo_l, halo_c)
    t.join()
