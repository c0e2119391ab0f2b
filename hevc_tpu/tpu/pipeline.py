"""Device-resident decode pipeline — the production jax-backend path.

Design (replacing per-frame host round-trips):
  * reference frames live in device memory: each decoded frame's planes
    are replication-padded ON DEVICE and kept in the layer's device DPB,
    so MC never re-uploads references (the host DPB keeps small
    output-dtype copies for md5/output/concealment);
  * the reconstruction canvas starts as a cached device-resident zeros
    array (uploaded once per geometry) — only PCM frames upload one;
  * MC rows are grouped per (kind, bi, wp, w, h) like the reference's
    fixed kernel grid (hevcdsp.h:98) with row counts bucketed to powers
    of two (droppable padding), bounding recompiles;
  * fetches are LAZY: decoded planes stay on device until a consumer
    reads them (output write, md5 check, SHVC upsample), so the decode
    loop runs ahead of the device and transfers overlap compute — the
    asynchronous analogue of the reference's frame threads
    (pthread_frame.c:484);
  * all per-frame metadata (prediction scalars, residual meta, MC/resid
    rows, SAO maps, QP/BS maps) travels in a few dtype-split buffers,
    sliced inside the jit by a static layout spec — a handful of
    host->device copies per frame instead of dozens;
  * residual levels upload as int16 (Main/Main10 coefficients are
    16-bit) and outputs download as uint8/uint16.

Every stage-B phase runs under a jax.named_scope (PHASES) so a profiler
trace attributes device time to it.

Bit-exactness: this path reuses the same device kernels
(reconstruct_wavefront, resid/deblock/SAO) and the native packer's
row semantics; equality vs the inline NumPy oracle is asserted by
tests/test_pipeline.py across the stream matrix.
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .filters import _luma_pass, deblock_jax, sao_plane_jax
from .intra import reconstruct_wavefront
from .mc import EPEL_TAPS, QPEL_TAPS, _interp_raw, resid_phase
from .pack import DUMP, PAD_REF, region_offsets
from .recon import _residuals
from .transforms import residual_batch  # noqa: F401  (re-export surface)

DUMP16 = 30000  # int16-safe OOB scatter sentinel for padding MC rows
# residual pools of at least this many coefficients upload as COO pairs
# when fewer than a third of them are nonzero (pack_frame_pipeline)
COO_MIN_COEFFS = 1 << 16

# named scopes of _pipeline_frame, in program order; a profiler trace's
# device events carry them in their op names
PHASES = ("unpack", "resid_idct", "mc", "inter_resid", "intra_wavefront",
          "deblock", "sao", "output")


def _pow2_at_least(x):
    return 1 << max(0, (x - 1).bit_length())


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _bucket_rows(n):
    """Row-count bucket: multiples of 2^(log2(n)-2), min 16 — bounds
    padding waste to ~25% and distinct shapes to 4 per octave."""
    if n <= 16:
        return 16
    m = 1 << max(2, (n - 1).bit_length() - 2)
    return -(-n // m) * m


# ---------------------------------------------------------------------------
# device program
# ---------------------------------------------------------------------------

def _mc_tile_phase(canvas, refs_l, refs_c, groups, bd):
    """MC over per-PU groups: groups = tuple of (is_ch, bi, wp, kind,
    w, h, rows[N, 17]) with row layout (sel, by, bx, fx, fy, sel1, by1,
    bx1, fx1, fy1, cy, cx, w0, o0, w1, o1, log2wd); padding rows
    scatter to DUMP and are dropped.

    kind specializes the interpolation like the reference's
    [pel|h|v|hv] kernel grid (hevcdsp.h:98): 0 = full-pel copy (both
    refs for bi), 1 = horizontal-only, 2 = vertical-only, 3 = full
    separable.  Specialized kinds read smaller windows and skip the
    identity convolution passes (bit-exact: frac-0 taps are a pure
    64-weight at the centre)."""
    maxv = (1 << bd) - 1
    for is_ch, bi, wp, kind, w, h, rows in groups:
        refs = refs_c if is_ch else refs_l
        ntaps = 4 if is_ch else 8
        pre = ntaps // 2 - 1  # centre-tap offset (3 luma / 1 chroma)
        taps = jnp.asarray(EPEL_TAPS if is_ch else QPEL_TAPS)
        shift1 = bd - 8

        def raw(f, o):
            if kind == 0:      # full-pel: pure window copy, 14-bit
                win = jax.lax.dynamic_slice(
                    refs, (f[o], f[o + 1] + pre, f[o + 2] + pre),
                    (1, h, w))[0]
                return win << (14 - bd)
            if kind == 1:      # horizontal only
                win = jax.lax.dynamic_slice(
                    refs, (f[o], f[o + 1] + pre, f[o + 2]),
                    (1, h, w + ntaps - 1))[0]
                th = taps[f[o + 3]]
                tmp = jnp.zeros((h, w), jnp.int32)
                for i in range(ntaps):
                    tmp = tmp + th[i] * win[:, i:i + w]
                return tmp >> shift1 if shift1 else tmp
            if kind == 2:      # vertical only
                win = jax.lax.dynamic_slice(
                    refs, (f[o], f[o + 1], f[o + 2] + pre),
                    (1, h + ntaps - 1, w))[0]
                t = win << (6 - shift1)
                tv = taps[f[o + 4]]
                out = jnp.zeros((h, w), jnp.int32)
                for i in range(ntaps):
                    out = out + tv[i] * t[i:i + h, :]
                return out >> 6
            win = jax.lax.dynamic_slice(
                refs, (f[o], f[o + 1], f[o + 2]),
                (1, h + ntaps - 1, w + ntaps - 1))[0]
            return _interp_raw(win, taps[f[o + 3]], taps[f[o + 4]],
                               w, h, ntaps, bd)

        if bi:
            def one(f):
                p0 = raw(f, 0)
                p1 = raw(f, 5)
                if wp:
                    w0, o0, w1, o1, lwd = (f[12], f[13], f[14], f[15],
                                           f[16])
                    return jnp.clip(
                        (p0 * w0 + p1 * w1 + ((o0 + o1 + 1) << lwd))
                        >> (lwd + 1), 0, maxv)
                shift = 15 - bd
                return jnp.clip((p0 + p1 + (1 << (shift - 1))) >> shift,
                                0, maxv)
        else:
            def one(f):
                p = raw(f, 0)
                if wp:
                    w0, o0, lwd = f[12], f[13], f[16]
                    v = jnp.where(
                        lwd >= 1,
                        ((p * w0 + (1 << jnp.maximum(lwd - 1, 0))) >> lwd)
                        + o0,
                        p * w0 + o0)
                    return jnp.clip(v, 0, maxv)
                shift = 14 - bd
                return jnp.clip((p + (1 << (shift - 1))) >> shift, 0, maxv)

        blk = jax.vmap(one)(rows)
        cy, cx = rows[:, 10], rows[:, 11]
        ii = jax.lax.broadcasted_iota(jnp.int32, (1, h, w), 1)
        jj = jax.lax.broadcasted_iota(jnp.int32, (1, h, w), 2)
        canvas = canvas.at[cy[:, None, None] + ii,
                           cx[:, None, None] + jj].set(blk, mode="drop")
    return canvas


@partial(jax.jit, static_argnames=("spec",))
def _pipeline_frame(meta, meta16, meta8, avail_u8, levels16, scale_bank,
                    canvas0, refs_y, refs_cb, refs_cr, spec):
    """One frame's full stage B from the packed metadata buffers.

    meta: int32 (prediction scalars / residual meta / SAO / dboff);
    meta16: int16 MC rows; meta8: int8 QP + BS maps — split by dtype to
    minimise host->device bytes.

    spec (static): dict-as-tuple — see pack_frame_pipeline.  Returns
    (fused output buffer, pad_y, pad_cb, pad_cr [int32, PAD_REF
    replication-padded])."""
    S = dict(spec)
    bd = S["bd"]
    n_chunks = S["n_chunks"]
    h4, w4 = S["h4"], S["w4"]
    cth, ctw = S["ctb_h"], S["ctb_w"]

    pos = 0

    def take(n, shape):
        nonlocal pos
        out = jax.lax.dynamic_slice(meta, (pos,), (max(n, 1),))
        pos += n
        return out[:n].reshape(shape) if n else jnp.zeros(shape, jnp.int32)

    scal = []
    for c in range(4):
        B = S["B"][c]
        scal.append(take(n_chunks * B * 8, (n_chunks, B, 8)))
    rmeta = []
    for c in range(4):
        nlv = S["nlv"][c]
        rmeta.append(take(nlv * 9, (nlv, 9)))
    pos16 = 0
    mc_groups = []
    for (is_ch, bi, wp, kind, w, h, nrow) in S["mc_groups"]:
        rows16 = jax.lax.dynamic_slice(meta16, (pos16,),
                                       (max(nrow * 17, 1),))
        pos16 += nrow * 17
        if nrow:
            mc_groups.append((is_ch, bi, wp, kind, w, h,
                              rows16[:nrow * 17].reshape(nrow, 17)
                              .astype(jnp.int32)))
    resid_fields = []
    for c in range(4):
        nrow = S["resid_rows"][c]
        resid_fields.append(take(nrow * 3, (nrow, 3)))
    sao_t = take(3 * cth * ctw, (3, cth, ctw))
    sao_b = take(3 * cth * ctw, (3, cth, ctw))
    sao_e = take(3 * cth * ctw, (3, cth, ctw))
    sao_o = take(3 * cth * ctw * 4, (3, cth, ctw, 4))
    pos8 = 0

    def take8(n, shape):
        nonlocal pos8
        out = jax.lax.dynamic_slice(meta8, (pos8,), (max(n, 1),))
        pos8 += n
        return out[:n].reshape(shape).astype(jnp.int32)

    qp4 = take8(h4 * w4, (h4, w4))
    bs_v = take8(h4 * w4, (h4, w4))
    bs_h = take8(h4 * w4, (h4, w4))
    beta4 = tc4 = sao_flags = None
    if S["per_slice"]:
        beta4 = take8(h4 * w4, (h4, w4))
        tc4 = take8(h4 * w4, (h4, w4))
        sao_flags = take8(cth * ctw, (cth, ctw)) & 0xFF
    nf_y = nf_c = None
    if S.get("nf"):
        # PCM/TQB loop-filter exemption masks, per-pixel (8.7.2/8.7.3)
        nf4 = take8(h4 * w4, (h4, w4)) != 0
        oy0, ox0, hl, wl = S["regions"][0]
        nf_l = jnp.repeat(jnp.repeat(nf4, 4, axis=0), 4, axis=1)
        nf_y = nf_l[:hl, :wl]
        _oyc, _oxc, hc, wc = S["regions"][1]
        nf_c = nf_l[::S["sub_h"], ::S["sub_w"]][:hc, :wc]
    dboff = take(4, (4,))

    # avail bitmaps (uint8 -> bool), per class
    apos = 0
    avail = []
    for c in range(4):
        B = S["B"][c]
        n = n_chunks * B * 128
        a = jax.lax.dynamic_slice(avail_u8, (apos,), (max(n, 1),))
        apos += n
        avail.append((a[:n].reshape(n_chunks, B, 128) != 0)
                     if n else jnp.zeros((n_chunks, B, 128), bool))

    # residual levels (int16 -> int32), per class; COO uploads
    # rebuild the dense pool with one scatter (padding indices drop)
    with jax.named_scope("unpack"):
        coo_n, coo_total = S["coo"]
        if coo_n:
            idx, val = levels16
            levels16 = jnp.zeros(coo_total, jnp.int16).at[idx].set(
                val, mode="drop")
        lpos = 0
        levels = []
        for c, s in enumerate((4, 8, 16, 32)):
            n = S["nlv"][c] * s * s
            lv = jax.lax.dynamic_slice(levels16, (lpos,), (max(n, 1),))
            lpos += n
            levels.append(
                lv[:n].reshape(S["nlv"][c], s, s).astype(jnp.int32)
                if n else jnp.zeros((S["nlv"][c], s, s), jnp.int32))

    with jax.named_scope("resid_idct"):
        resids = _residuals(tuple(levels), tuple(rmeta), bd,
                            tuple(scale_bank))

    canvas = canvas0.astype(jnp.int32)
    mono = S.get("mono", False)
    if S["n_refs"]:
        with jax.named_scope("mc"):
            refs_l = jnp.stack(refs_y)
            # monochrome: no chroma MC rows exist; alias the luma stack
            # so the (never-indexed) chroma side keeps a valid operand
            refs_c = refs_l if mono else jnp.stack(refs_cb + refs_cr)
            canvas = _mc_tile_phase(canvas, refs_l, refs_c,
                                    tuple(mc_groups), bd)
    with jax.named_scope("inter_resid"):
        canvas = resid_phase(canvas, tuple(resid_fields), resids, bd)
    with jax.named_scope("intra_wavefront"):
        out = reconstruct_wavefront(canvas, tuple(scal), avail, resids,
                                    bd, n_chunks)
        planes = []
        for oy, ox, h, w in S["regions"]:
            planes.append(jax.lax.dynamic_slice(out, (oy, ox), (h, w)))
    y, cb, cr = planes
    if S["do_deblock"]:
        with jax.named_scope("deblock"):
            bo = beta4 if S["per_slice"] else dboff[0]
            to = tc4 if S["per_slice"] else dboff[1]
            if mono:
                # luma-only deblock (4:0:0): vertical + transposed pass
                y_in = y
                y = _luma_pass(y, qp4, bs_v, bo, to, bd)
                if S.get("nf"):
                    y = jnp.where(nf_y, y_in, y)
                bo_t = bo.T if getattr(bo, "ndim", 0) == 2 else bo
                to_t = to.T if getattr(to, "ndim", 0) == 2 else to
                y = _luma_pass(y.T, qp4.T, bs_h.T, bo_t, to_t, bd).T
                if S.get("nf"):
                    y = jnp.where(nf_y, y_in, y)
            else:
                y, cb, cr = deblock_jax(y, cb, cr, qp4, bs_v, bs_h, bo,
                                        to, dboff[2], dboff[3], bd=bd,
                                        sub_w=S["sub_w"],
                                        sub_h=S["sub_h"],
                                        has_nf=bool(S.get("nf")),
                                        nf_y=nf_y, nf_c=nf_c)
    if S["do_sao"]:
        with jax.named_scope("sao"):
            outp = []
            for plane, p in enumerate((y,) if mono else (y, cb, cr)):
                sw, sh = (1, 1) if plane == 0 else (S["sub_w"], S["sub_h"])
                lg = S["ctb_log2"]
                outp.append(sao_plane_jax(
                    p, sao_t[plane], sao_b[plane], sao_o[plane],
                    sao_e[plane], lg - (sw.bit_length() - 1), bd,
                    edge_flags=sao_flags,
                    nf=nf_y if plane == 0 else nf_c,
                    ctb_log2_h=lg - (sh.bit_length() - 1)))
            if mono:
                y = outp[0]
            else:
                y, cb, cr = outp
    with jax.named_scope("output"):
        odt = jnp.uint8 if bd <= 8 else jnp.uint16
        srcs = (y,) if mono else (y, cb, cr)
        pads = [jnp.pad(p, PAD_REF, mode="edge") for p in srcs]
        while len(pads) < 3:  # fixed return arity; dummies never read
            pads.append(pads[0])
        # one fused output buffer: a single device->host copy per frame
        flat = jnp.concatenate([p.astype(odt).ravel() for p in srcs])
    return (flat, pads[0], pads[1], pads[2])


# ---------------------------------------------------------------------------
# host-side assembly
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _zero_canvas(ch, cw):
    """Device-resident zero canvas, uploaded once per geometry."""
    return jax.device_put(np.zeros((ch, cw), np.int16))


_FLAT_BANK_DEV = None


def _dev_scale_bank(pic):
    """Device copies of the scaling-matrix banks, cached on the active
    ScalingListData (a module cache keyed by object id would alias
    garbage-collected banks)."""
    global _FLAT_BANK_DEV
    from ..native import _scale_bank
    scaling = getattr(pic, "scaling", None)
    if scaling is None:
        if _FLAT_BANK_DEV is None:
            _FLAT_BANK_DEV = tuple(jnp.asarray(b)
                                   for b in _scale_bank(pic))
        return _FLAT_BANK_DEV
    got = getattr(scaling, "_native_bank_dev", None)
    if got is None:
        got = tuple(jnp.asarray(b) for b in _scale_bank(pic))
        scaling._native_bank_dev = got
    return got


def pad_dev_refs(planes):
    """Device-side PAD_REF padding of (possibly cropped) planes to the
    DPB reference shape — the device mirror of _pad_np, used to seed a
    layer's dpb_dev with the inter-layer reference without any
    host round-trip."""
    return tuple(jnp.pad(jnp.asarray(p).astype(jnp.int32), PAD_REF,
                         mode="edge") for p in planes)


def _pad_np(planes):
    return tuple(jax.device_put(np.pad(p, PAD_REF, mode="edge")
                                .astype(np.int32)) for p in planes)


def _saturate_mc_windows(mcrow, nm, sps):
    """EXACT saturation of MC reference windows overhanging the PAD_REF
    replication band.

    HEVC clamps every reference sample coordinate into the picture
    (8.5.3.3.3.2), so MVs may point arbitrarily far outside the frame —
    merge + per-CU MVD chains legitimately drift past 64 px (seen on
    SHVC EL streams).  Every pad row replicates the edge row (and every
    pad column the edge column), so:
      * a window lying entirely beyond the frame on an axis reads
        constant rows/cols: its origin may be clamped into the pad with
        bit-identical output;
      * a window that still violates the padded bounds after clamping
        (only possible for 64-wide/tall luma blocks straddling the far
        pad edge) splits in half along the offending axis until its
        children qualify.
    Returns (mcrow, nm) with split rows appended."""
    mr = mcrow[:nm]
    # vectorized fast path: touch rows only when something violates
    # the padded bounds (normal streams never do — the python loop
    # below would otherwise cost ~20 ms/frame at 1080p)
    is_ch = mr[:, 0] == 1
    ext_h = mr[:, 3] + np.where(is_ch, 3, 7)
    ext_w = mr[:, 2] + np.where(is_ch, 3, 7)
    hp = np.where(is_ch, sps.height // sps.sub_h, sps.height) \
        + 2 * PAD_REF
    wp = np.where(is_ch, sps.width // sps.sub_w, sps.width) \
        + 2 * PAD_REF
    ok = (mr[:, 5] >= 0) & (mr[:, 6] >= 0) \
        & (mr[:, 5] + ext_h <= hp) & (mr[:, 6] + ext_w <= wp)
    bi = mr[:, 1] == 1
    ok &= np.where(bi, (mr[:, 10] >= 0) & (mr[:, 11] >= 0)
                   & (mr[:, 10] + ext_h <= hp)
                   & (mr[:, 11] + ext_w <= wp), True)
    if ok.all():
        return mcrow, nm
    good = [r for r in mr[ok]]
    rows = list(mr[~ok])
    out = good
    while rows:
        r = rows.pop()
        is_ch = r[0] == 1
        ntap = 3 if is_ch else 7
        hp = (sps.height // (sps.sub_h if is_ch else 1)) + 2 * PAD_REF
        wp = (sps.width // (sps.sub_w if is_ch else 1)) + 2 * PAD_REF
        wins = [(5, 6)] + ([(10, 11)] if r[1] == 1 else [])
        split_axis = None
        for cby, cbx in wins:
            for c, ext, lim, size_col in ((cby, r[3] + ntap, hp, 3),
                                          (cbx, r[2] + ntap, wp, 2)):
                v = r[c]
                if 0 <= v and v + ext <= lim:
                    continue
                if v + ext <= PAD_REF:           # fully before the frame
                    if ext <= PAD_REF:
                        r[c] = PAD_REF - ext
                        continue
                elif v >= lim - PAD_REF:         # fully after the frame
                    if ext <= PAD_REF:
                        r[c] = lim - PAD_REF
                        continue
                elif 0 <= v and v + ext <= lim:
                    continue
                split_axis = size_col
                break
            if split_axis is not None:
                break
        if split_axis is not None and r[split_axis] > 4:
            half = int(r[split_axis]) // 2
            r2 = r.copy()
            r[split_axis] = half
            r2[split_axis] = half
            if split_axis == 3:   # vertical: by/by1/cy shift
                for c in (5, 10) if r[1] == 1 else (5,):
                    r2[c] += half
                r2[14] += half
            else:                 # horizontal: bx/bx1/cx shift
                for c in (6, 11) if r[1] == 1 else (6,):
                    r2[c] += half
                r2[15] += half
            rows.append(r)
            rows.append(r2)
            continue
        out.append(r)
    if len(out) == nm:
        mcrow[:nm] = np.asarray(out)
        return mcrow, nm
    arr = np.asarray(out, np.int32)
    return arr, arr.shape[0]


def pack_frame_pipeline(pic):
    """Native pack (tiled MC) -> (meta buffer, avail, levels16, spec)."""
    import ctypes as C

    from .. import native as N
    from .. import trace
    sps = pic.sps
    reg, chh, cww = region_offsets(sps)
    with trace.span("pack.concat"):
        rec, lvl = N._concat_chunks(pic.native_chunks)
    n_rec = rec.shape[0]
    refs0 = getattr(pic, "ref_list_l0", []) or []
    refs1 = getattr(pic, "ref_list_l1", []) or []
    n_refs = len(refs0) + len(refs1)

    P = N.PackParams()
    P.width, P.height = sps.width, sps.height
    P.sub_w, P.sub_h = sps.sub_w, sps.sub_h
    P.h4, P.w4 = pic.h4, pic.w4
    P.log2_ctb = sps.log2_ctb_size
    P.ctb_w, P.ctb_h = sps.ctb_w, sps.ctb_h
    P.chroma444 = int(sps.chroma_format_idc == 3)
    P.smoothing_disabled = int(sps.intra_smoothing_disabled)
    P.strong_smoothing = int(sps.strong_intra_smoothing)
    P.nrefs, P.r0 = n_refs, len(refs0)
    P.pad_ref = PAD_REF
    P.tile_mc = 0  # per-PU rows: fewer, larger device blocks
    for p in range(3):
        for k in range(4):
            P.reg[p * 4 + k] = reg[p][k]

    cap_mc = max(1, n_rec)
    imeta = np.empty((max(1, n_rec), 11), np.int32)
    iavail = np.zeros((max(1, n_rec), 128), np.uint8)
    lmeta = np.empty((max(1, n_rec), 11), np.int32)
    mcrow = np.empty((cap_mc, 21), np.int32)
    residr = np.empty((max(1, n_rec), 4), np.int32)
    pcmrow = np.empty((max(1, n_rec), 6), np.int32)
    counts = np.zeros(8, np.int64)
    tabs = N._pps_tables(pic.pps)
    with trace.span("pack.native"):
        rc = N._pack_fn()(
            np.ascontiguousarray(rec).reshape(-1), n_rec, C.byref(P),
            pic.z_order.reshape(-1), pic.slice_idx.reshape(-1), tabs[3],
            imeta.reshape(-1), iavail.reshape(-1), lmeta.reshape(-1),
            mcrow.reshape(-1), residr.reshape(-1), pcmrow.reshape(-1),
            counts)
    if rc != 0:
        raise RuntimeError(f"native pipeline pack failed (rc={rc})")
    ni, nl, nm, nr, npcm, n_chunks_raw = (int(v) for v in counts[:6])

    # MV-range guard (the equivalent of pack_frame's PAD_REF asserts):
    # padded ref dims bound every block's read window
    _t_guard = trace.span("pack.guard")
    _t_guard.__enter__()
    if nm:
        mcrow, nm = _saturate_mc_windows(mcrow, nm, sps)
        mr = mcrow[:nm]
        hp_l = sps.height + 2 * PAD_REF
        wp_l = sps.width + 2 * PAD_REF
        hp_c = sps.height // sps.sub_h + 2 * PAD_REF
        wp_c = sps.width // sps.sub_w + 2 * PAD_REF
        is_ch = mr[:, 0] == 1
        ext_h = mr[:, 3] + np.where(is_ch, 3, 7)
        ext_w = mr[:, 2] + np.where(is_ch, 3, 7)
        hp = np.where(is_ch, hp_c, hp_l)
        wp = np.where(is_ch, wp_c, wp_l)
        ok = (mr[:, 5] >= 0) & (mr[:, 6] >= 0) \
            & (mr[:, 5] + ext_h <= hp) & (mr[:, 6] + ext_w <= wp)
        bi_rows = mr[:, 1] == 1
        ok &= np.where(bi_rows, (mr[:, 10] >= 0) & (mr[:, 11] >= 0)
                       & (mr[:, 10] + ext_h <= hp)
                       & (mr[:, 11] + ext_w <= wp), True)
        if not ok.all():
            bad = mr[~ok][:3]
            raise AssertionError(
                f"MV exceeds PAD_REF after saturation: pic "
                f"{sps.width}x{sps.height} "
                f"padded l={hp_l}x{wp_l} c={hp_c}x{wp_c}; "
                f"rows (is_ch,bi,w,h,sel,by,bx,...): {bad.tolist()}")

    _t_guard.__exit__(None, None, None)
    # canvas: device zeros unless PCM samples need pre-filling
    if npcm:
        canvas = np.zeros((chh, cww), np.int16)
        for plane, cy, cx, w, h, off in pcmrow[:npcm].tolist():
            canvas[cy:cy + h, cx:cx + w] = lvl[off:off + w * h].reshape(
                h, w)
        canvas0 = jnp.asarray(canvas)
    else:
        canvas0 = _zero_canvas(chh, cww)

    n_chunks = _round_up(max(1, n_chunks_raw), 16)
    im, iv, lm = imeta[:ni], iavail[:ni], lmeta[:nl]
    cls_i = im[:, 0]
    parts = []        # int32 meta blocks, in _pipeline_frame order
    avail_parts = []
    B = []
    _t_intra = trace.span("pack.intra")
    _t_intra.__enter__()
    for c in range(4):
        sel = np.nonzero(cls_i == c)[0]
        cnt = int(im[sel, 2].max()) + 1 if sel.size else 0
        Bc = _pow2_at_least(cnt) if cnt else 0
        B.append(Bc)
        a = np.zeros((n_chunks, Bc, 8), np.int32)
        a[:, :, 0] = DUMP
        a[:, :, 1] = DUMP
        a[:, :, 2] = 1
        v = np.zeros((n_chunks, Bc, 128), np.uint8)
        if sel.size:
            a[im[sel, 1], im[sel, 2]] = im[sel, 3:11]
            v[im[sel, 1], im[sel, 2]] = iv[sel]
        parts.append(a.reshape(-1))
        avail_parts.append(v.reshape(-1))

    _t_intra.__exit__(None, None, None)
    lvl_parts = []
    _t_lvl = trace.span("pack.levels")
    _t_lvl.__enter__()
    # native one-pass gather: per-class (rmeta, int16 levels); padding
    # rows (and the CCP zero slot) stay zeroed
    cls_counts = np.bincount(lm[:, 0], minlength=4) if nl else \
        np.zeros(4, np.int64)
    nlv = [_round_up(int(cls_counts[c]) + 1, 16) for c in range(4)]
    rms = [np.zeros((nlv[c], 9), np.int32) for c in range(4)]
    lv16s = [np.zeros((nlv[c], (4 << c) * (4 << c)), np.int16)
             for c in range(4)]
    if nl:
        N._gather_levels_fn()(
            lvl, np.ascontiguousarray(lm).reshape(-1), nl,
            rms[0].reshape(-1), rms[1].reshape(-1),
            rms[2].reshape(-1), rms[3].reshape(-1),
            lv16s[0].reshape(-1), lv16s[1].reshape(-1),
            lv16s[2].reshape(-1), lv16s[3].reshape(-1))
    for c in range(4):
        parts.append(rms[c].reshape(-1))
        lvl_parts.append(lv16s[c].reshape(-1))
    _t_lvl.__exit__(None, None, None)
    # MC groups keyed (is_ch, bi, wp, kind, w, h): kind = the
    # reference's pel/h/v/hv kernel-grid class (hevcdsp.h:98); rows
    # bucketed to <=25% padding (4 shape classes per octave)
    _t_mc = trace.span("pack.mc")
    _t_mc.__enter__()
    mcr = mcrow[:nm]
    parts16 = []      # int16 meta (MC rows)
    mc_groups = []
    if nm:
        wp_flag = (mcr[:, 20] >= 0).astype(np.int32)
        uni_kind = ((mcr[:, 7] != 0) + 2 * (mcr[:, 8] != 0))
        bi_zero = (mcr[:, 7] | mcr[:, 8]
                   | mcr[:, 12] | mcr[:, 13]) == 0
        kind = np.where(mcr[:, 1] == 1, np.where(bi_zero, 0, 3),
                        uni_kind).astype(np.int32)
        # fold sparse specializations back into the generic kernel:
        # per-kernel launch overhead outweighs the specialized win
        # for small groups (kind 3 is correct for every frac)
        base = (mcr[:, 0] * 8 + mcr[:, 1] * 4 + wp_flag) * (1 << 20) \
            + mcr[:, 2] * 1024 + mcr[:, 3]
        for k in (0, 1, 2):
            sel = kind == k
            if not sel.any():
                continue
            ids, cnt = np.unique(base[sel], return_counts=True)
            small = set(ids[cnt < 256].tolist())
            if small:
                fold = sel & np.isin(base, list(small))
                kind[fold] = 3
        order = np.lexsort((mcr[:, 3], mcr[:, 2], kind, wp_flag,
                            mcr[:, 1], mcr[:, 0]))
        srt = mcr[order]
        keys = np.column_stack([srt[:, :2], wp_flag[order],
                                kind[order], srt[:, 2:4]])
        bounds = [0] + (np.nonzero(np.any(np.diff(keys, axis=0) != 0,
                                          axis=1))[0] + 1).tolist() + [nm]
        for a, b in zip(bounds[:-1], bounds[1:]):
            is_ch, bi, wp, knd, w, h = (int(v) for v in keys[a])
            n_g = _bucket_rows(b - a)
            rows = np.zeros((n_g, 17), np.int16)
            rows[:b - a] = srt[a:b][:, 4:21]
            # padding rows scatter out of canvas bounds (dropped);
            # int16-safe sentinel (canvas dims stay far below it)
            rows[b - a:, 10] = DUMP16
            rows[b - a:, 11] = DUMP16
            mc_groups.append((bool(is_ch), bool(bi), bool(wp), knd,
                              w, h, n_g))
            parts16.append(rows.reshape(-1))

    _t_mc.__exit__(None, None, None)
    rr = residr[:nr]
    resid_rows = []
    for c in range(4):
        sel = np.nonzero(rr[:, 0] == c)[0]
        n_g = _pow2_at_least(len(sel)) if len(sel) else 0
        rows = np.full((n_g, 3), DUMP, np.int32)
        rows[:, 2] = 0
        if len(sel):
            rows[:len(sel)] = rr[sel][:, 1:4]
        resid_rows.append(n_g)
        parts.append(rows.reshape(-1))

    # SAO maps + QP/BS + deblock offsets
    if getattr(pic, "sao_arrays", None) is not None:
        sao_t, sao_b, sao_o, sao_e = pic.sao_arrays
    else:
        ct = (3, sps.ctb_h, sps.ctb_w)
        sao_t = np.zeros(ct, np.int32)
        sao_b = np.zeros(ct, np.int32)
        sao_o = np.zeros(ct + (4,), np.int32)
        sao_e = np.zeros(ct, np.int32)
    parts += [sao_t.reshape(-1), sao_b.reshape(-1), sao_e.reshape(-1),
              sao_o.reshape(-1)]
    dbp = getattr(pic, "deblock_params", None)
    slice_params = getattr(pic, "slice_params", None) or []
    pps = pic.pps
    per_slice = len(slice_params) > 1 or (
        pps.tiles_enabled and not pps.loop_filter_across_tiles)
    if per_slice:
        # multi-slice filter semantics: gated BS + per-4x4 offset maps
        # + per-CTB SAO edge-restriction flags travel in meta8
        from ..ops.boundaries import (gate_bs, sao_edge_flag_map,
                                      slice_param_arrays, upsample4)
        cs = 1 << sps.log2_ctb_size
        beta_c, tc_c, dis_c, lfa_c = slice_param_arrays(
            pic.slice_idx, slice_params or [{}])
        tiles_m = np.asarray(pps.tile_of_ctb) if pps.tiles_enabled \
            else np.zeros_like(pic.slice_idx)
        do_deblock = not (dis_c == 1).all()
        if do_deblock:
            pic.compute_bs()
            gv, gh = gate_bs(pic.bs_v, pic.bs_h, pic.slice_idx,
                             tiles_m, lfa_c, dis_c,
                             bool(pps.loop_filter_across_tiles), cs)
        else:
            gv = gh = np.zeros((pic.h4, pic.w4), np.int8)
        flags = sao_edge_flag_map(pic.slice_idx, tiles_m, lfa_c,
                                  bool(pps.loop_filter_across_tiles),
                                  bool(pps.tiles_enabled))
        parts8 = [pic.qp_y.astype(np.int8).reshape(-1),
                  gv.astype(np.int8).reshape(-1),
                  gh.astype(np.int8).reshape(-1),
                  upsample4(beta_c, cs, pic.h4, pic.w4)
                  .astype(np.int8).reshape(-1),
                  upsample4(tc_c, cs, pic.h4, pic.w4)
                  .astype(np.int8).reshape(-1),
                  flags.view(np.int8).reshape(-1)]
        parts.append(np.array([0, 0, pps.cb_qp_offset,
                               pps.cr_qp_offset], np.int32))
    elif dbp is not None:
        do_deblock = True
        pic.compute_bs()
        parts8 = [pic.qp_y.astype(np.int8).reshape(-1),
                  pic.bs_v.astype(np.int8).reshape(-1),
                  pic.bs_h.astype(np.int8).reshape(-1)]
        parts.append(np.array([dbp["beta_offset"], dbp["tc_offset"],
                               dbp["cb_qp_offset"], dbp["cr_qp_offset"]],
                              np.int32))
    else:
        do_deblock = False
        parts8 = [np.zeros(pic.h4 * pic.w4 * 3, np.int8)]
        parts.append(np.zeros(4, np.int32))
    nfmap = getattr(pic, "no_filter", None)
    nf_any = bool(nfmap is not None and nfmap.any())
    if nf_any:
        parts8.append(np.ascontiguousarray(nfmap).astype(np.int8)
                      .reshape(-1))

    # meta order matches _pipeline_frame's reads: scal0..3, rmeta0..3,
    # mc groups, resid groups, sao (t, b, e, o), qp4, bs_v, bs_h, dboff
    with trace.span("pack.cat"):
        meta = np.concatenate(parts)
        meta16 = np.concatenate(parts16) if parts16 \
            else np.zeros(1, np.int16)
        meta8 = np.concatenate(parts8)
        avail_u8 = np.concatenate(avail_parts) if any(B) \
            else np.zeros(1, np.uint8)
        levels16 = np.concatenate(lvl_parts)
        # adaptive sparse upload: residual pools are mostly zero on
        # typical content — ship (int32 idx, int16 val) pairs when they
        # cost less than the dense buffer (6 bytes/nonzero vs 2
        # bytes/coeff) and rebuild the dense pool with one device
        # scatter
        coo_n = 0
        if levels16.size >= COO_MIN_COEFFS:
            nz = np.nonzero(levels16)[0]
            if nz.size * 3 < levels16.size:
                coo_n = _pow2_at_least(max(int(nz.size), 1))
                idx = np.full(coo_n, levels16.size, np.int32)  # drop
                idx[:nz.size] = nz
                val = np.zeros(coo_n, np.int16)
                val[:nz.size] = levels16[nz]
                levels16 = (idx, val)

    do_sao = bool(getattr(pic, "has_sao", False)) \
        or bool(getattr(pic, "sao_map", None))
    spec = (
        ("per_slice", per_slice),
        ("bd", sps.bit_depth_luma),
        ("n_chunks", n_chunks),
        ("B", tuple(B)),
        ("nlv", tuple(nlv)),
        ("mc_groups", tuple(mc_groups)),
        ("resid_rows", tuple(resid_rows)),
        ("regions", tuple(reg[p] for p in range(3))),
        ("h4", pic.h4), ("w4", pic.w4),
        ("ctb_h", sps.ctb_h), ("ctb_w", sps.ctb_w),
        ("ctb_log2", sps.log2_ctb_size),
        ("sub_w", sps.sub_w), ("sub_h", sps.sub_h),
        ("do_deblock", do_deblock), ("do_sao", do_sao),
        ("n_refs", n_refs),
        ("nf", nf_any),
        ("mono", sps.chroma_format_idc == 0),
        ("coo", (coo_n, sum(len(v) for v in lvl_parts))),
    )
    return meta, meta16, meta8, avail_u8, levels16, canvas0, spec


class LazyPlanes:
    """List-like deferred fetch of device planes.

    Materializes (and caches) the numpy planes on first element access;
    until then the decode loop never blocks on the device.  Accepts
    either a sequence of per-plane device arrays, the pipeline's
    fused form (flat_buffer, ((h, w), ...)), or a concurrent.futures
    Future resolving to either (the async pack worker's handle).
    `crop` is the SPS for conformance-window cropping of output frames;
    `dtype` converts on materialization (the DPB wants int32)."""

    __slots__ = ("_dev", "_np", "_crop", "_dtype", "_lock")

    def __init__(self, dev_planes, crop=None, dtype=None):
        import threading
        self._dev = dev_planes
        self._np = None
        self._crop = crop
        self._dtype = dtype
        self._lock = threading.Lock()

    def device_ready(self):
        """Block until the frame's device computation is enqueued and
        complete, WITHOUT transferring pixels to the host (the
        compute-side synchronization point for benchmarks)."""
        dev = self._dev
        if hasattr(dev, "result"):
            dev = dev.result()
        if dev is None:
            return  # already materialized
        jax.block_until_ready(dev[0])

    def device_planes(self):
        """The frame's planes as DEVICE arrays, with no host transfer
        (SHVC: the EL's inter-layer upsampling consumes the BL frame
        device-to-device, so layers overlap on the device queue instead
        of rendezvousing through the host — the il_progress analogue,
        pthread_frame.c:613-738).  Returns None once materialized."""
        dev = self._dev
        if hasattr(dev, "result"):
            dev = dev.result()
        if dev is None:
            return None
        fused = (len(dev) == 2 and isinstance(dev[1], tuple)
                 and dev[1] and isinstance(dev[1][0], tuple))
        if not fused:
            return list(dev)
        buf = dev[0]
        planes, off = [], 0
        for h, w in dev[1]:
            planes.append(buf[off:off + h * w].reshape(h, w))
            off += h * w
        return planes

    def _mat(self):
        with self._lock:
            return self._mat_locked()

    def _mat_locked(self):
        if self._np is None:
            from .. import trace
            dev = self._dev
            if hasattr(dev, "result"):  # pack-worker Future
                dev = dev.result()
            fused = (len(dev) == 2 and isinstance(dev[1], tuple)
                     and dev[1] and isinstance(dev[1][0], tuple))
            with trace.span("fetch"):
                if fused:
                    buf = np.asarray(dev[0])
                    planes, off = [], 0
                    for h, w in dev[1]:
                        planes.append(buf[off:off + h * w]
                                      .reshape(h, w))
                        off += h * w
                else:
                    planes = [np.asarray(d) for d in dev]
            if self._dtype is not None:
                planes = [p.astype(self._dtype) for p in planes]
            if self._crop is not None:
                from ..coding.picture import crop_conf_win
                planes = crop_conf_win(planes, self._crop)
            self._np = planes
            self._dev = None
        return self._np

    def __getitem__(self, i):
        return self._mat()[i]

    def __len__(self):
        if self._np is not None:
            return len(self._np)
        dev = self._dev
        if hasattr(dev, "result"):
            dev = dev.result()
        fused = (len(dev) == 2 and isinstance(dev[1], tuple)
                 and dev[1] and isinstance(dev[1][0], tuple))
        return len(dev[1]) if fused else len(dev)

    def __iter__(self):
        return iter(self._mat())


def finish_frame_pipeline(pic, lay, poc: int):
    """Launch one frame's stage B on device (asynchronously).

    Updates the layer's device DPB with HBM-resident padded reference
    planes and returns the output planes as device handles — the caller
    wraps them in LazyPlanes instead of blocking on a fetch."""
    from .. import trace
    with trace.span("pack_native"):
        (meta, meta16, meta8, avail_u8, levels16, canvas0,
         spec) = pack_frame_pipeline(pic)
    dpb_dev = getattr(lay, "dpb_dev", None)
    if dpb_dev is None:
        dpb_dev = lay.dpb_dev = {}

    def dev_ref(entry, dev):
        if dev is not None:
            return dev
        pads = _pad_np([np.asarray(p) for p in entry[1]])
        if len(pads) == 1:  # monochrome: alias luma into the arity
            pads = (pads[0], pads[0], pads[0])
        return pads

    # device ref resolution happens HERE (on the ordered pack worker):
    # by the time frame n packs, every preceding frame's device DPB
    # entry exists; the current poc (inter-layer ref) is never in
    # dpb_dev yet, so IL refs correctly fall back to the host planes
    refs_y, refs_cb, refs_cr = [], [], []
    for lst in (getattr(pic, "ref_list_l0", []) or [],
                getattr(pic, "ref_list_l1", []) or []):
        for entry in lst:
            py, pcb, pcr = dev_ref(entry, dpb_dev.get(entry[0]))
            refs_y.append(py)
            refs_cb.append(pcb)
            refs_cr.append(pcr)

    with trace.span("device_dispatch"):
        out = _pipeline_frame(jnp.asarray(meta), jnp.asarray(meta16),
                              jnp.asarray(meta8), jnp.asarray(avail_u8),
                              jax.tree_util.tree_map(
                                  jnp.asarray, levels16),
                              _dev_scale_bank(pic),
                              canvas0, tuple(refs_y), tuple(refs_cb),
                              tuple(refs_cr), spec)
    flat, pad_y, pad_cb, pad_cr = out
    dpb_dev[poc] = (pad_y, pad_cb, pad_cr)
    # filters applied on device
    pic.deblock_params = None
    if hasattr(pic, "sao_map"):
        pic.sao_map = {}
    pic.has_sao = False
    pic.sao_arrays = None
    regions = dict(spec)["regions"]
    if dict(spec)["mono"]:
        regions = regions[:1]
    shapes = tuple((h, w) for _oy, _ox, h, w in regions)
    return (flat, shapes)
