"""Stage-A → stage-B packing: BlockRecords → wavefront-chunked tensors.

Host-side preparation of the symbol tensors the device reconstruction
consumes: a single padded int32 canvas holding Y/Cb/Cr regions, per-
size-class residual level batches, and per-record prediction metadata
grouped into conflict-free wavefront chunks.

Chunking: records are taken in decode order and greedily packed into the
current chunk until a record's reference band (the L-shaped left column +
top row it predicts from) touches a block already written by the chunk —
then a new chunk starts.  Records inside one chunk are therefore
independent: the device vmaps them and commits each class batch with one
scatter.  This is the device analogue of the reference's WPP wavefront
(reference: hevcdec.c:2961 hls_decode_entry_wpp) applied to the
reconstruction stage.

Availability is pure geometry (z-scan order + slice/tile maps), computed
here once and shipped as masks — the device never re-derives syntax
state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..coding.picture import PictureState
from ..ops import reference as R

PAD = 8          # top/left margin of each region
TAIL = 72        # bottom/right slack so 2n-reads never leave the canvas
DUMP = -(1 << 20)  # scatter target for padding lanes (dropped as OOB)


def _round_up(x, m):
    return ((x + m - 1) // m) * m



PAD_REF = 64  # replication padding of reference planes (bounds the MVs
              # the packer accepts; generated streams stay well inside)


@dataclass
class PackedFrame:
    canvas: np.ndarray            # int32 [CH, CW]
    scal: tuple                   # per class: int32 [n_chunks, B, 8]
    avail: tuple                  # per class: bool [n_chunks, B, 128]
    levels: tuple                 # per class: int32 [Nc, s, s]
    rmeta: tuple                  # per class: int32 [Nc, 9] (qp, dst,
                                  # ts, raw, mtx+1, rot, rdpcm, ccp,
                                  # ccp_slot)
    n_chunks: int
    region: dict                  # plane -> (oy, ox, h, w)
    bit_depth: int
    # inter phases
    mc_groups: tuple = ()         # ((is_chroma, bi, w, h, wp, fields), ...)
                                  # fields int32 [N, 7|12 (+5 when wp)]:
                                  # pred cols, cy, cx[, w0, o0, w1, o1,
                                  # log2wd]
    resid_groups: tuple = ()      # per class int32 [N, 3] = (cy, cx, slot)
    refs_l: np.ndarray = None     # int32 [R, Hp, Wp] padded luma refs
    refs_c: np.ndarray = None     # int32 [2R, hp, wp] padded cb+cr refs
    scale_bank: tuple = ()        # per class: int32 [7, s, s] scaling
                                  # matrices (0 = flat, 1..6 = matrix id)


def region_offsets(sps):
    h, w = sps.height, sps.width
    if sps.chroma_format_idc == 0:
        # monochrome: no chroma records ever target the canvas — park
        # two dummy 8x8 regions in the top-left pad margin so the
        # 3-plane plumbing keeps its shape (4:0:0, 7.4.3.2)
        reg = {0: (PAD, PAD, h, w), 1: (0, 0, 8, 8), 2: (0, 8, 8, 8)}
        return reg, PAD + h + TAIL, PAD + w + TAIL + PAD
    h2, w2 = h // sps.sub_h, w // sps.sub_w
    reg = {0: (PAD, PAD, h, w),
           1: (PAD + h + PAD, PAD, h2, w2),
           2: (PAD + h + PAD, PAD + w2 + PAD, h2, w2)}
    ch = PAD + h + PAD + h2 + TAIL
    cw = max(PAD + w, PAD + w2 + PAD + w2) + TAIL + PAD
    return reg, ch, cw


def _schedule_levels(pic: PictureState, plan):
    """Wavefront scheduling: split records into phases + dependency
    levels.

    MC records have no canvas dependencies (phase 1); inter residual
    adds depend only on the MC writes below them (phase 2); intra
    records get level(rec) = 1 + max level over the blocks the L-shaped
    reference band reads from.  Records of one level are mutually
    independent, so any topological reorder is a legal reconstruction
    schedule — this exposes the full anti-diagonal parallelism instead
    of the decode order's left-to-right chain.

    Returns (mc_records, resid_records, chunks)."""
    sps = pic.sps
    shapes = {0: (sps.height, sps.width)}
    shapes[1] = shapes[2] = (sps.height // sps.sub_h, sps.width // sps.sub_w)
    lvl_map = {p: np.full(shapes[p], -1, np.int32) for p in range(3)}
    chunks = []
    mc_records = []
    resid_records = []
    for r in plan:
        m = lvl_map[r.plane]
        if r.kind == "mc":
            m[r.y:r.y + r.h, r.x:r.x + r.size] = \
                np.maximum(m[r.y:r.y + r.h, r.x:r.x + r.size], 0)
            mc_records.append(r)
            continue
        if r.kind == "resid":
            m[r.y:r.y + r.size, r.x:r.x + r.size] = \
                np.maximum(m[r.y:r.y + r.size, r.x:r.x + r.size], 0)
            resid_records.append(r)
            continue
        if r.kind == "pcm":
            # raw samples are pre-filled into the canvas before any chunk
            # runs, so they are readable from level 0 like MC output
            m[r.y:r.y + r.h, r.x:r.x + r.size] = \
                np.maximum(m[r.y:r.y + r.h, r.x:r.x + r.size], 0)
            continue
        h, w = m.shape
        n2 = 2 * r.size
        x0 = max(0, r.x - 1)
        y0 = max(0, r.y - 1)
        col = m[y0:min(h, r.y + n2), x0:r.x] if r.x > 0 else None
        row = m[y0:r.y, x0:min(w, r.x + n2)] if r.y > 0 else None
        lvl = 0
        if col is not None and col.size:
            lvl = max(lvl, int(col.max()) + 1)
        if row is not None and row.size:
            lvl = max(lvl, int(row.max()) + 1)
        m[r.y:r.y + r.size, r.x:r.x + r.size] = lvl
        while len(chunks) <= lvl:
            chunks.append([])
        chunks[lvl].append(r)
    return mc_records, resid_records, chunks


def _pow2_at_least(x):
    return 1 << max(0, (x - 1).bit_length())


def pack_frame(pic: PictureState, plan: List) -> PackedFrame:
    sps = pic.sps
    bd = sps.bit_depth_luma
    reg, ch, cw = region_offsets(sps)
    canvas = np.zeros((ch, cw), np.int32)
    classes = {4: 0, 8: 1, 16: 2, 32: 3}
    chroma444 = sps.chroma_format_idc == 3

    mc_records, resid_records, chunks = _schedule_levels(pic, plan)

    # residual pools (slot 0 = zeros, prepended on device).  rmeta row:
    # (qp, dst, ts, raw, mtx+1, rot, rdpcm, ccp_alpha, ccp_slot) — the
    # last four are the rext residual modifiers (flip / DPCM accumulate /
    # cross-component add) applied on device by recon._residuals.
    lv = [[] for _ in range(4)]
    rmeta = [[] for _ in range(4)]
    slots = {}
    for r in plan:
        if r.kind == "pcm":
            # PCM: raw samples, not transform levels — write them straight
            # into the canvas (no scatter ever targets a PCM block)
            oy, ox, _, _ = reg[r.plane]
            canvas[oy + r.y:oy + r.y + r.h,
                   ox + r.x:ox + r.x + r.size] = r.levels
            continue
        if r.levels is None and not getattr(r, "ccp", 0):
            continue
        c = classes[r.size]
        if r.levels is None:  # CCP-only chroma TU: own zero-level slot
            lv[c].append(np.zeros((r.size, r.size), np.int32))
        else:
            lv[c].append(np.asarray(r.levels, np.int32))
        rmeta[c].append((r.qp, int(r.dst), int(r.ts), int(r.tqb),
                         r.mtx + 1, int(getattr(r, "rot", False)),
                         int(getattr(r, "rdpcm", 0)),
                         int(getattr(r, "ccp", 0)), 0))
        slots[id(r)] = len(lv[c])
    # second pass: resolve CCP luma slots (same size class in 4:4:4)
    for r in plan:
        if getattr(r, "ccp", 0) and r.kind != "pcm":
            c = classes[r.size]
            row = list(rmeta[c][slots[id(r)] - 1])
            row[8] = slots[id(r.ccp_ref)]
            rmeta[c][slots[id(r)] - 1] = tuple(row)

    rec_meta = {}  # id(rec) -> (class, scal fields, avail bits)
    for chk in chunks:
      for r in chk:
        c = classes[r.size]
        n = r.size
        n2 = 2 * n
        sx = sps.sub_w if r.plane else 1
        sy = sps.sub_h if r.plane else 1
        oy, ox, rh, rw = reg[r.plane]
        xl, yl = r.x * sx, r.y * sy
        bits = np.zeros(128, bool)
        for i in range(n2):
            if r.y + i < rh:
                bits[i] = pic.available(xl, yl, xl - sx, (r.y + i) * sy)
            if r.x + i < rw:
                bits[64 + i] = pic.available(xl, yl, (r.x + i) * sx,
                                             yl - sy)
        ac = pic.available(xl, yl, xl - sx, yl - sy)
        filt = (not sps.intra_smoothing_disabled
                and R._filter_flag(r.mode, n, r.plane, chroma444, False))
        strong = bool(sps.strong_intra_smoothing) and n == 32 and filt
        slot = slots.get(id(r), 0)
        rec_meta[id(r)] = (c, (oy + r.y, ox + r.x, r.mode, slot, int(filt),
                               int(strong), int(r.plane == 0 and n < 32),
                               int(ac)), bits)

    # ---- MC + inter-residual phase groups -------------------------------
    refs0 = getattr(pic, "ref_list_l0", []) or []
    refs1 = getattr(pic, "ref_list_l1", []) or []
    refs = list(refs0) + list(refs1)
    nrefs = len(refs)
    r0 = len(refs0)

    hs, vs = sps.sub_w - 1, sps.sub_h - 1

    def _mc_entry(r, plane, mv, ridx, lx):
        """(sel, by, bx, fx, fy) for one prediction of a record."""
        from ..ops.mc import chroma_mv_parts
        if plane:
            ox, fx = chroma_mv_parts(mv[0], hs)
            oy, fy = chroma_mv_parts(mv[1], vs)
            bx = PAD_REF + r.x + ox - 1
            by = PAD_REF + r.y + oy - 1
            sel = (plane - 1) * nrefs + ridx + (r0 if lx else 0)
        else:
            fx, fy = mv[0] & 3, mv[1] & 3
            bx = PAD_REF + r.x + (mv[0] >> 2) - 3
            by = PAD_REF + r.y + (mv[1] >> 2) - 3
            sel = ridx + (r0 if lx else 0)
        assert bx >= 0 and by >= 0, "MV exceeds PAD_REF"
        return (sel, by, bx, fx, fy)

    mc_grp = {}
    for r in mc_records:
        is_ch = r.plane > 0
        has_wp = r.wp is not None
        key = (is_ch, bool(r.bi), r.size, r.h, has_wp)
        oy, ox, _, _ = reg[r.plane]
        if r.bi:
            row = (_mc_entry(r, r.plane, r.mv, r.ref_idx, 0)
                   + _mc_entry(r, r.plane, r.mv1, r.ref_idx1, 1)
                   + (oy + r.y, ox + r.x))
        else:
            row = (_mc_entry(r, r.plane, r.mv, r.ref_idx, r.lx)
                   + (oy + r.y, ox + r.x))
        if has_wp:
            row = row + tuple(r.wp)
        mc_grp.setdefault(key, []).append(row)
    mc_groups = tuple(
        k + (np.asarray(v, np.int32),) for k, v in sorted(mc_grp.items()))
    resid_grp = [[] for _ in range(4)]
    for r in resid_records:
        c = classes[r.size]
        oy, ox, _, _ = reg[r.plane]
        resid_grp[c].append((oy + r.y, ox + r.x, slots[id(r)]))
    resid_groups = tuple(
        np.asarray(g, np.int32) if g else np.zeros((0, 3), np.int32)
        for g in resid_grp)
    if nrefs:
        pad = ((PAD_REF, PAD_REF), (PAD_REF, PAD_REF))
        refs_l = np.stack([np.pad(pl[0], pad, mode="edge")
                           for _, pl in refs]).astype(np.int32)
        refs_c = np.stack(
            [np.pad(pl[1], pad, mode="edge") for _, pl in refs]
            + [np.pad(pl[2], pad, mode="edge") for _, pl in refs]
        ).astype(np.int32)
        for is_ch, bi, w, h, _wp, fields in mc_groups:
            hp, wp = (refs_c.shape[1:] if is_ch else refs_l.shape[1:])
            ext = (3 if is_ch else 7)
            assert ((fields[:, 1] + h + ext <= hp).all()
                    and (fields[:, 2] + w + ext <= wp).all()), \
                "MV exceeds PAD_REF"
    else:
        refs_l = np.zeros((1, 8, 8), np.int32)
        refs_c = np.zeros((1, 8, 8), np.int32)

    # per-class per-chunk arrays, bucketed shapes for jit-cache stability
    n_chunks = _round_up(max(1, len(chunks)), 16)
    counts = [max((sum(1 for r in chk if classes[r.size] == c)
                   for chk in chunks), default=0) for c in range(4)]
    # B = 0 ⇒ class completely unused: the device skips its branch
    B = [_pow2_at_least(c) if c else 0 for c in counts]
    scal = []
    avail = []
    for c in range(4):
        a = np.zeros((n_chunks, B[c], 8), np.int32)
        a[:, :, 0] = DUMP
        a[:, :, 1] = DUMP
        a[:, :, 2] = 1
        scal.append(a)
        avail.append(np.zeros((n_chunks, B[c], 128), bool))
    for k, chk in enumerate(chunks):
        fill = [0, 0, 0, 0]
        for r in chk:
            c, fields, bits = rec_meta[id(r)]
            j = fill[c]
            fill[c] += 1
            scal[c][k, j] = fields
            avail[c][k, j] = bits

    levels = []
    rmetas = []
    for c, s in enumerate((4, 8, 16, 32)):
        nlv = _round_up(max(1, len(lv[c]) + 1), 16)
        padl = nlv - len(lv[c])
        levels.append(np.stack(lv[c] + [np.zeros((s, s), np.int32)] * padl))
        rmetas.append(np.asarray(rmeta[c] + [(0,) * 9] * padl,
                                 np.int32))

    # scaling-list matrix banks: slot 0 = flat 16, 1..6 = matrix ids
    scaling = getattr(pic, "scaling", None)
    bank = []
    for c in range(4):
        s_sz = 4 << c
        b = np.full((7, s_sz, s_sz), 16, np.int32)
        if scaling is not None:
            for mid in range(6):
                b[mid + 1] = scaling.factor(c + 2, mid)[0]
        bank.append(b)

    return PackedFrame(canvas=canvas, scal=tuple(scal), avail=tuple(avail),
                       levels=tuple(levels), rmeta=tuple(rmetas),
                       n_chunks=n_chunks, region=reg, bit_depth=bd,
                       mc_groups=mc_groups, resid_groups=resid_groups,
                       refs_l=refs_l, refs_c=refs_c,
                       scale_bank=tuple(bank))
