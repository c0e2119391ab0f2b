"""Device-side in-loop filters (JAX/XLA), bit-exact.

Deblocking (8.7.2): each pass (vertical then horizontal) is fully
data-parallel — filtered edges are 8 samples apart, reads ≤4 and writes
≤3 per side, so segment windows are disjoint and the whole pass is one
vectorized computation over the [segments, edges] grid (the reshape
trick keeps windows contiguous: columns 4..W-5 fold into [.., nE, 8]).

SAO (8.7.3): pure per-pixel selects driven by per-CTB parameter maps
upsampled to pixel resolution; band offsets via a per-CTB 32-entry LUT.

Replaces the reference's hevc_deblock.asm / hevc_sao_sse.c kernel family
(reference: libavcodec/hevcdsp_template.c:310-496, :3377-3536) with a
data-parallel design.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.deblock import BETA_TABLE, TC_TABLE

_BETA = np.asarray(BETA_TABLE, np.int32)
_TC = np.asarray(TC_TABLE, np.int32)

# chroma QP mapping table for 4:2:0 (8.6.1 Table 8-10) as a full LUT
_QPC_LUT = np.arange(58, dtype=np.int32)
for _q in range(58):
    if _q < 30:
        _QPC_LUT[_q] = _q
    elif _q <= 43:
        _QPC_LUT[_q] = (29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36,
                        37, 37)[_q - 30]
    else:
        _QPC_LUT[_q] = _q - 6


def _luma_filter_segments(win, beta, tc, maxv):
    """Vectorized 8.7.2.5.3 luma edge filter.

    win: int32 [..., 4, 8] (p3 p2 p1 p0 q0 q1 q2 q3 per line);
    beta/tc: int32 [...]. Returns filtered windows."""
    p3, p2, p1, p0 = (win[..., 0], win[..., 1], win[..., 2], win[..., 3])
    q0, q1, q2, q3 = (win[..., 4], win[..., 5], win[..., 6], win[..., 7])
    dp = jnp.abs(p2 - 2 * p1 + p0)
    dq = jnp.abs(q2 - 2 * q1 + q0)
    dpq0 = dp[..., 0] + dq[..., 0]
    dpq3 = dp[..., 3] + dq[..., 3]
    d = dpq0 + dpq3
    do_filter = d < beta

    def strong_line(i, dpq):
        return ((2 * dpq < (beta >> 2))
                & (jnp.abs(p3[..., i] - p0[..., i])
                   + jnp.abs(q0[..., i] - q3[..., i]) < (beta >> 3))
                & (jnp.abs(p0[..., i] - q0[..., i])
                   < ((5 * tc + 1) >> 1)))

    strong = strong_line(0, dpq0) & strong_line(3, dpq3)
    t2 = (2 * tc)[..., None]
    c3 = lambda lo, hi, v: jnp.clip(v, lo, hi)
    sp0 = c3(p0 - t2, p0 + t2, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
    sp1 = c3(p1 - t2, p1 + t2, (p2 + p1 + p0 + q0 + 2) >> 2)
    sp2 = c3(p2 - t2, p2 + t2, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
    sq0 = c3(q0 - t2, q0 + t2, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3)
    sq1 = c3(q1 - t2, q1 + t2, (p0 + q0 + q1 + q2 + 2) >> 2)
    sq2 = c3(q2 - t2, q2 + t2, (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3)
    # weak filter
    tcw = tc[..., None]
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wmask = jnp.abs(delta) < 10 * tcw
    delta = jnp.clip(delta, -tcw, tcw)
    wp0 = jnp.clip(p0 + delta, 0, maxv)
    wq0 = jnp.clip(q0 - delta, 0, maxv)
    side_thr = (beta + (beta >> 1)) >> 3
    dep = (dp[..., 0] + dp[..., 3] < side_thr)[..., None]
    deq = (dq[..., 0] + dq[..., 3] < side_thr)[..., None]
    tc2 = tcw >> 1
    dp1 = jnp.clip((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1, -tc2, tc2)
    wp1 = jnp.clip(p1 + dp1, 0, maxv)
    dq1 = jnp.clip((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1, -tc2, tc2)
    wq1 = jnp.clip(q1 + dq1, 0, maxv)

    strong_b = strong[..., None]
    out = win
    sel = lambda s_, w_, orig, extra=True: jnp.where(
        do_filter[..., None],
        jnp.where(strong_b, s_, jnp.where(wmask & extra, w_, orig)), orig)
    out = out.at[..., 1].set(jnp.where(do_filter[..., None],
                                       jnp.where(strong_b, sp2, p2), p2))
    out = out.at[..., 2].set(sel(sp1, wp1, p1, dep))
    out = out.at[..., 3].set(sel(sp0, wp0, p0))
    out = out.at[..., 4].set(sel(sq0, wq0, q0))
    out = out.at[..., 5].set(sel(sq1, wq1, q1, deq))
    out = out.at[..., 6].set(jnp.where(do_filter[..., None],
                                       jnp.where(strong_b, sq2, q2), q2))
    return out


def _chroma_filter_segments(win, tc, maxv):
    """8.7.2.5.5 chroma filter.  win: [..., L, 4] (p1 p0 q0 q1)."""
    p1, p0, q0, q1 = win[..., 0], win[..., 1], win[..., 2], win[..., 3]
    tcw = tc[..., None]
    delta = jnp.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tcw, tcw)
    out = win.at[..., 1].set(jnp.clip(p0 + delta, 0, maxv))
    out = out.at[..., 2].set(jnp.clip(q0 - delta, 0, maxv))
    return out


def _luma_pass(y, qp4, bs4, beta_off, tc_off, bd):
    """One directional luma pass over plane y (filter along axis 1)."""
    h, w = y.shape
    # edges at x = 8(j+1); the filter reads/writes p3..q3 = cols
    # edge-4 .. edge+3, so the last edge is the largest 8k <= w-4
    # (w % 8 == 4 puts one more edge than w // 8 - 1 — e.g. chroma-
    # subsampled 1080p transposed passes)
    n_e = (w - 4) // 8
    maxv = (1 << bd) - 1
    if n_e <= 0:
        return y
    s = h // 4
    win = y[:, 4:4 + 8 * n_e].reshape(s, 4, n_e, 8).transpose(0, 2, 1, 3)
    bs = bs4[:, 2::2][:, :n_e]                     # [s, n_e]
    qp_p = qp4[:, 1::2][:, :n_e]
    qp_q = qp4[:, 2::2][:, :n_e]
    qp = (qp_p + qp_q + 1) >> 1
    # per-slice offsets: [h4, w4] maps sampled at the edge's q position
    # (multi-slice; scalars otherwise)
    if getattr(beta_off, "ndim", 0) == 2:
        beta_off = beta_off[:, 2::2][:, :n_e]
    if getattr(tc_off, "ndim", 0) == 2:
        tc_off = tc_off[:, 2::2][:, :n_e]
    beta = jnp.asarray(_BETA)[jnp.clip(qp + beta_off, 0, 51)] << (bd - 8)
    tc = jnp.asarray(_TC)[jnp.clip(qp + 2 * (bs - 1) + tc_off, 0, 53)] \
        << (bd - 8)
    outw = _luma_filter_segments(win, beta, tc, maxv)
    outw = jnp.where((bs > 0)[..., None, None], outw, win)
    y = y.at[:, 4:4 + 8 * n_e].set(
        outw.transpose(0, 2, 1, 3).reshape(h, 8 * n_e))
    return y


def _chroma_pass(c, qp4, bs4, tc_off, qp_off, bd, sub, sub_x=None):
    """One directional chroma pass: edges every 8 chroma cols.

    sub: chroma subsampling along the filtered axis; sub_x: across it
    (default sub).  4:2:0 maps QpC through Table 8-10, other formats
    take Min(qPi, 51) (8.7.2.5.5)."""
    sub_x = sub if sub_x is None else sub_x
    ch, cw = c.shape
    # edges at x = 8(j+1); the filter touches p1..q1 = cols
    # edge-2 .. edge+1, so the last edge is the largest 8k <= cw-2
    # (cw % 8 == 4: one more edge than cw // 8 - 1, e.g. 540 rows of
    # 1080p chroma in the transposed pass)
    n_e = (cw - 2) // 8
    maxv = (1 << bd) - 1
    if n_e <= 0:
        return c
    s = ch // 4
    # window cols 8j+6 .. 8j+13 → take first 4 (xc-2..xc+1); pad right
    # so the final edge's (unused) tail columns exist
    cpad = jnp.pad(c, ((0, 0), (0, 8)))
    win = cpad[:, 6:6 + 8 * n_e].reshape(s, 4, n_e, 8).transpose(0, 2, 1, 3)
    seg = win[..., :4]
    # bs/qp at luma coords: edge x = 8*sub*(j+1), row y = 4*sub*m
    bs = bs4[:: sub_x, :][: s, :][:, 2 * sub:: 2 * sub][:, :n_e]
    qp_p = qp4[:: sub_x, :][: s, :][:, 2 * sub - 1:: 2 * sub][:, :n_e]
    qp_q = qp4[:: sub_x, :][: s, :][:, 2 * sub:: 2 * sub][:, :n_e]
    qpi = jnp.clip(((qp_p + qp_q + 1) >> 1) + qp_off, 0, 57)
    if sub == 2 and sub_x == 2:
        qpc = jnp.asarray(_QPC_LUT)[qpi]
    else:
        qpc = jnp.minimum(qpi, 51)
    if getattr(tc_off, "ndim", 0) == 2:
        tc_off = tc_off[:: sub_x, :][: s, :][:, 2 * sub:: 2 * sub][:, :n_e]
    tc = jnp.asarray(_TC)[jnp.clip(qpc + 2 + tc_off, 0, 53)] << (bd - 8)
    outs = _chroma_filter_segments(seg, tc, maxv)
    outs = jnp.where((bs == 2)[..., None, None], outs, seg)
    outw = win.at[..., :4].set(outs)
    cpad = cpad.at[:, 6:6 + 8 * n_e].set(
        outw.transpose(0, 2, 1, 3).reshape(ch, 8 * n_e))
    return cpad[:, :cw]


@partial(jax.jit, static_argnames=("bd", "sub_w", "sub_h", "has_nf"))
def deblock_jax(y, cb, cr, qp4, bs_v4, bs_h4, beta_off, tc_off,
                cb_qp_off, cr_qp_off, bd=8, sub_w=2, sub_h=2,
                has_nf=False, nf_y=None, nf_c=None):
    """Full-frame deblocking: vertical pass then horizontal pass.

    nf_y/nf_c (with has_nf=True): bool pixel masks — samples of PCM
    CUs with pcm_loop_filter_disabled / transquant-bypass CUs are never
    modified (8.7.2 nDp/nDq = 0), restored after EACH directional pass
    so the horizontal pass reads the original values."""
    y_in, cb_in, cr_in = y, cb, cr
    # vertical edges
    y = _luma_pass(y, qp4, bs_v4, beta_off, tc_off, bd)
    cb = _chroma_pass(cb, qp4, bs_v4, tc_off, cb_qp_off, bd, sub_w, sub_h)
    cr = _chroma_pass(cr, qp4, bs_v4, tc_off, cr_qp_off, bd, sub_w, sub_h)
    if has_nf:
        y = jnp.where(nf_y, y_in, y)
        cb = jnp.where(nf_c, cb_in, cb)
        cr = jnp.where(nf_c, cr_in, cr)
    # horizontal edges = vertical pass on the transposed plane
    bo_t = beta_off.T if getattr(beta_off, "ndim", 0) == 2 else beta_off
    to_t = tc_off.T if getattr(tc_off, "ndim", 0) == 2 else tc_off
    y = _luma_pass(y.T, qp4.T, bs_h4.T, bo_t, to_t, bd).T
    cb = _chroma_pass(cb.T, qp4.T, bs_h4.T, to_t, cb_qp_off, bd, sub_h,
                      sub_w).T
    cr = _chroma_pass(cr.T, qp4.T, bs_h4.T, to_t, cr_qp_off, bd, sub_h,
                      sub_w).T
    if has_nf:
        y = jnp.where(nf_y, y_in, y)
        cb = jnp.where(nf_c, cb_in, cb)
        cr = jnp.where(nf_c, cr_in, cr)
    return y, cb, cr


# ---------------------------------------------------------------------------
# SAO
# ---------------------------------------------------------------------------

_EO = ((0, -1, 0, 1), (-1, 0, 1, 0), (-1, -1, 1, 1), (1, -1, -1, 1))


def _upsample(m, cs, h, w, cs_h=None):
    """Per-CTB map [cty, ctx, ...] → per-pixel [h, w, ...] (CTBs cs_h x
    cs samples; cs_h defaults to cs)."""
    cs_h = cs if cs_h is None else cs_h
    return jnp.repeat(jnp.repeat(m, cs_h, axis=0), cs, axis=1)[:h, :w]


@partial(jax.jit, static_argnames=("ctb_log2", "bd", "ctb_log2_h"))
def sao_plane_jax(plane, type_map, band_pos, offs4, eo_class, ctb_log2,
                  bd, edge_flags=None, nf=None, ctb_log2_h=None):
    """SAO for one plane — gather-free (masked sums over upsampled maps).

    plane: int32 [h, w]; type_map: int32 [cty, ctx] (0 off / 1 band /
    2 edge); band_pos: int32 [cty, ctx]; offs4: int32 [cty, ctx, 4]
    (band offsets k=0..3, or signed edge offsets for categories 1..4);
    eo_class: int32 [cty, ctx]; ctb_log2 (ctb_log2_h, default the same)
    = log2 of the CTB width (height) in plane samples — they differ for
    4:2:2 chroma.

    edge_flags (optional): per-CTB int32 of ops.boundaries.SAO_* bits —
    restricted slice/tile borders whose edge-SAO pixels stay unfiltered
    (reference: hevcdsp_template.c:438 sao_edge_restore_1)."""
    h, w = plane.shape
    lg_h = ctb_log2 if ctb_log2_h is None else ctb_log2_h
    cs, cs_h = 1 << ctb_log2, 1 << lg_h
    maxv = (1 << bd) - 1
    t = _upsample(type_map, cs, h, w, cs_h)
    pos = _upsample(band_pos, cs, h, w, cs_h)
    offs = _upsample(offs4, cs, h, w, cs_h)          # [h, w, 4]
    cls = _upsample(eo_class, cs, h, w, cs_h)
    # ---- band: offset where band(v) matches pos+k ----
    band = plane >> (bd - 5)
    band_off = jnp.zeros_like(plane)
    for k in range(4):
        band_off = band_off + jnp.where(band == ((pos + k) & 31),
                                        offs[..., k], 0)
    band_out = jnp.clip(plane + band_off, 0, maxv)
    # ---- edge: compute all 4 classes, select, category-mask offsets ----
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    pad = jnp.pad(plane, 1, mode="edge")

    def shifted(dy, dx):
        return jax.lax.dynamic_slice(pad, (1 + dy, 1 + dx), (h, w))

    if edge_flags is not None:
        fl = _upsample(edge_flags, cs, h, w, cs_h)
        xm, ym = xx % cs, yy % cs_h
        cond_l = xm == 0
        cond_r = (xm == cs - 1) | (xx == w - 1)
        cond_t = ym == 0
        cond_b = (ym == cs_h - 1) | (yy == h - 1)
        at_l = xx < cs
        at_t = yy < cs_h
        at_r = (xx >> ctb_log2) == ((w - 1) >> ctb_log2)
        at_b = (yy >> lg_h) == ((h - 1) >> lg_h)
        bit = [(fl & (1 << i)) != 0 for i in range(8)]
        ve0, ve1, he0, he1, d0, d1, d2, d3 = bit

    edge_out = plane
    for k, (ay, ax, by, bx) in enumerate(_EO):
        a = shifted(ay, ax)
        b = shifted(by, bx)
        idx = 2 + jnp.sign(plane - a) + jnp.sign(plane - b)
        cat = jnp.where(idx == 2, 0, jnp.where(idx < 2, idx + 1, idx))
        off = jnp.zeros_like(plane)
        for c in range(4):
            off = off + jnp.where(cat == c + 1, offs[..., c], 0)
        valid = ((yy + ay >= 0) & (yy + ay < h) & (xx + ax >= 0)
                 & (xx + ax < w) & (yy + by >= 0) & (yy + by < h)
                 & (xx + bx >= 0) & (xx + bx < w))
        if edge_flags is not None:
            # restricted borders: the reference restores full border
            # rows/columns except corners whose diagonal class stays
            # legal (sao_edge_restore_1 save_upper_left etc.)
            s_ul = (k == 2) & ~d0 & ~at_l & ~at_t
            s_ur = (k == 3) & ~d1 & ~at_t & ~at_r
            s_lr = (k == 2) & ~d2 & ~at_r & ~at_b
            s_ll = (k == 3) & ~d3 & ~at_l & ~at_b
            restr = jnp.zeros((h, w), bool)
            if k != 1:
                restr |= ve0 & cond_l & ~(cond_t & s_ul) \
                    & ~(cond_b & s_ll)
                restr |= ve1 & cond_r & ~(cond_t & s_ur) \
                    & ~(cond_b & s_lr)
            if k != 0:
                restr |= he0 & cond_t & ~(cond_l & s_ul) \
                    & ~(cond_r & s_ur)
                restr |= he1 & cond_b & ~(cond_l & s_ll) \
                    & ~(cond_r & s_lr)
            if k == 2:
                restr |= d0 & cond_t & cond_l
                restr |= d2 & cond_b & cond_r
            if k == 3:
                restr |= d1 & cond_t & cond_r
                restr |= d3 & cond_b & cond_l
            valid = valid & ~restr
        res = jnp.where(valid, jnp.clip(plane + off, 0, maxv), plane)
        edge_out = jnp.where(cls == k, res, edge_out)
    out = jnp.where(t == 1, band_out,
                    jnp.where(t == 2, edge_out, plane))
    if nf is not None:
        # PCM / transquant-bypass samples stay unmodified (8.7.3)
        out = jnp.where(nf, plane, out)
    return out
