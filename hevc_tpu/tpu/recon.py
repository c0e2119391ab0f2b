"""Stage-B orchestrator: packed frame → reconstructed planes on device.

Pipeline (all inside one jit):
 1. batched dequant + inverse transform per TU size class (int32 matmuls)
 2. sequential intra predict/add replay over the canvas (lax.scan)

The result is bit-exact with the NumPy stage-B oracle
(decoder.core.execute_plan_numpy); tests enforce this on the CPU backend.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .intra import reconstruct_wavefront
from .pack import PackedFrame, pack_frame
from .transforms import residual_batch


def _wrap16(v):
    """int16 wraparound — the reference's coefficient buffers are int16
    (reference: hevcdsp_template.c transform_rdpcm / hevcdec.c:1441)."""
    return ((v + 32768) & 65535) - 32768


def _residuals(levels, rmeta, bit_depth, scale_bank=None):
    """Per-class residual batches with a zeros slot prepended.

    rmeta: per class int32 [Nc, >=5] = (qp, dst, ts, raw, mtx+1
    [, rot, rdpcm, ccp_alpha, ccp_slot]); the optional rext columns
    apply the 4x4-skip rotation, the RDPCM accumulate, and the
    cross-component residual add (slot indexes the same class pool,
    zero-slot included).  scale_bank: optional per-class int32
    [7, S, S] scale-matrix banks (0 = flat, 1..6 = matrix ids)."""
    pre = []
    for c, log2 in enumerate((2, 3, 4, 5)):
        m = rmeta[c]
        sm = None
        if scale_bank is not None:
            sm = jnp.take(scale_bank[c], m[:, 4], axis=0)
        r = residual_batch(levels[c], m[:, 0], m[:, 1] != 0, m[:, 2] != 0,
                           log2, bit_depth, sm)
        r = jnp.where((m[:, 3] != 0)[:, None, None], levels[c], r)
        if m.shape[1] > 5:
            rot = (m[:, 5] != 0)[:, None, None]
            r = jnp.where(rot, r[:, ::-1, ::-1], r)
            rd = m[:, 6]
            if True:  # rdpcm accumulate (mod-2^16 exact under wrap)
                h = _wrap16(jnp.cumsum(r, axis=2))
                v = _wrap16(jnp.cumsum(r, axis=1))
                r = jnp.where((rd == 1)[:, None, None], h,
                              jnp.where((rd == 2)[:, None, None], v, r))
        pre.append(r)
    out = []
    for c in range(4):
        m = rmeta[c]
        r = pre[c]
        zero = jnp.zeros((1,) + r.shape[1:], r.dtype)
        if m.shape[1] > 5:
            pool = jnp.concatenate([zero, r])
            alpha = m[:, 7]
            add = (alpha[:, None, None] * pool[m[:, 8]]) >> 3
            r = jnp.where((alpha != 0)[:, None, None],
                          _wrap16(r + add), r)
        out.append(jnp.concatenate([zero, r]))
    return tuple(out)


@partial(jax.jit, static_argnames=("bit_depth", "n_chunks", "mc_shapes"))
def reconstruct_device(canvas, scal, avail, levels, rmeta,
                       mc_fields, refs_l, refs_c, resid_fields,
                       bit_depth, n_chunks, mc_shapes=(), scale_bank=None):
    resids = _residuals(levels, rmeta, bit_depth, scale_bank)
    canvas = _inter_phases(canvas, refs_l, refs_c, resids, bit_depth,
                           mc_fields, resid_fields, mc_shapes)
    return reconstruct_wavefront(canvas, scal, avail, resids, bit_depth,
                                 n_chunks)


def _mc_args(pf: PackedFrame):
    mc_shapes = tuple((ic, bi, w, h, wp)
                      for ic, bi, w, h, wp, _ in pf.mc_groups)
    mc_fields = tuple(jnp.asarray(f) for *_k, f in pf.mc_groups)
    resid_fields = tuple(jnp.asarray(g) for g in pf.resid_groups) \
        if pf.resid_groups else tuple(
            jnp.zeros((0, 3), jnp.int32) for _ in range(4))
    return (mc_fields, jnp.asarray(pf.refs_l), jnp.asarray(pf.refs_c),
            resid_fields, mc_shapes)


def _inter_phases(canvas, refs_l, refs_c, resids, bit_depth,
                  mc_fields, resid_fields, mc_shapes):
    """MC + inter-residual phases."""
    from .mc import mc_phase, resid_phase
    groups = tuple((ic, bi, w, h, wp, f)
                   for (ic, bi, w, h, wp), f in zip(mc_shapes, mc_fields))
    canvas = mc_phase(canvas, refs_l, refs_c, groups, bit_depth)
    return resid_phase(canvas, resid_fields, resids, bit_depth)


def run_packed(pf: PackedFrame):
    """Execute a packed frame; returns the reconstructed canvas (np)."""
    mc_fields, refs_l, refs_c, resid_fields, mc_shapes = _mc_args(pf)
    canvas = reconstruct_device(
        jnp.asarray(pf.canvas),
        tuple(jnp.asarray(v) for v in pf.scal),
        tuple(jnp.asarray(v) for v in pf.avail),
        tuple(jnp.asarray(v) for v in pf.levels),
        tuple(jnp.asarray(v) for v in pf.rmeta),
        mc_fields, refs_l, refs_c, resid_fields,
        pf.bit_depth, pf.n_chunks, mc_shapes,
        tuple(jnp.asarray(b) for b in pf.scale_bank))
    return np.asarray(canvas)


def reconstruct_plan_jax(pic, plan) -> None:
    """Decoder hook: reconstruct a frame's plan on device into pic.planes."""
    pf = pack_frame(pic, plan)
    canvas = run_packed(pf)
    for plane, (oy, ox, h, w) in pf.region.items():
        pic.planes[plane][:] = canvas[oy:oy + h, ox:ox + w].astype(
            pic.planes[plane].dtype)


# ---------------------------------------------------------------------------
# Full device pipeline: recon + deblock + SAO in one jit
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("bit_depth", "n_chunks", "regions",
                                   "do_deblock", "do_sao", "ctb_log2",
                                   "sub_w", "sub_h", "mc_shapes"))
def decode_frame_device(canvas, scal, avail, levels, rmeta, qp4, bs_v, bs_h,
                        beta_off, tc_off, cb_qp_off, cr_qp_off,
                        sao_type, sao_band_pos, sao_offs4, sao_eo_class,
                        bit_depth, n_chunks, regions, do_deblock, do_sao,
                        ctb_log2, sub_w, sub_h,
                        mc_fields=(), refs_l=None, refs_c=None,
                        resid_fields=(), mc_shapes=(), scale_bank=None):
    """Stage B end-to-end: returns (y, cb, cr) int32 planes.

    regions: static tuple ((oy, ox, h, w) per plane); sao_* are
    per-plane tuples of per-CTB parameter maps."""
    from .filters import deblock_jax, sao_plane_jax

    resids = _residuals(levels, rmeta, bit_depth, scale_bank)
    canvas = _inter_phases(canvas, refs_l, refs_c, resids, bit_depth,
                           mc_fields, resid_fields, mc_shapes)
    out = reconstruct_wavefront(canvas, scal, avail, resids, bit_depth,
                                n_chunks)
    planes = []
    for plane, (oy, ox, h, w) in enumerate(regions):
        planes.append(jax.lax.dynamic_slice(out, (oy, ox), (h, w)))
    y, cb, cr = planes
    if do_deblock:
        y, cb, cr = deblock_jax(y, cb, cr, qp4, bs_v, bs_h, beta_off,
                                tc_off, cb_qp_off, cr_qp_off,
                                bd=bit_depth, sub_w=sub_w, sub_h=sub_h)
    if do_sao:
        outp = []
        for plane, p in enumerate((y, cb, cr)):
            sw, sh = (1, 1) if plane == 0 else (sub_w, sub_h)
            outp.append(sao_plane_jax(p, sao_type[plane],
                                      sao_band_pos[plane],
                                      sao_offs4[plane],
                                      sao_eo_class[plane],
                                      ctb_log2 - (sw.bit_length() - 1),
                                      bit_depth,
                                      ctb_log2_h=ctb_log2
                                      - (sh.bit_length() - 1)))
        y, cb, cr = outp
    return y, cb, cr


def pack_sao_params(pic):
    """Per-CTB SAO parameter maps for the device filters (3 planes).

    Returns (type, band_pos, offs4, eo_class) — offs4 carries the 4
    signed offsets for either band (k=0..3) or edge (categories 1..4)."""
    if getattr(pic, "sao_arrays", None) is not None:
        return pic.sao_arrays  # native stage A fills these directly
    sps = pic.sps
    cty, ctx = sps.ctb_h, sps.ctb_w
    sao_map = getattr(pic, "sao_map", None) or {}
    t = np.zeros((3, cty, ctx), np.int32)
    pos = np.zeros((3, cty, ctx), np.int32)
    offs = np.zeros((3, cty, ctx, 4), np.int32)
    ec = np.zeros((3, cty, ctx), np.int32)
    for (xc, yc), prm in sao_map.items():
        for p in range(3):
            ti = prm.type_idx[p]
            t[p, yc, xc] = ti
            if ti:
                offs[p, yc, xc] = prm.offsets[p]
                pos[p, yc, xc] = prm.band_position[p]
                ec[p, yc, xc] = prm.eo_class[p]
    return t, pos, offs, ec


def finish_frame_jax(pic, plan) -> None:
    """Full device stage B (recon + filters) into pic.planes."""
    sps = pic.sps
    if getattr(pic, "native_chunks", None) is not None:
        from ..native import pack_frame_native
        pf = pack_frame_native(pic)
    else:
        pf = pack_frame(pic, plan)
    dbp = getattr(pic, "deblock_params", None)
    do_deblock = dbp is not None
    if do_deblock:
        pic.compute_bs()
    sao_t, sao_b, sao_e, sao_c = pack_sao_params(pic)
    do_sao = bool(getattr(pic, "sao_map", None)) \
        or bool(getattr(pic, "has_sao", False))
    regions = tuple(pf.region[p] for p in range(3))
    y, cb, cr = decode_frame_device(
        jnp.asarray(pf.canvas),
        tuple(jnp.asarray(v) for v in pf.scal),
        tuple(jnp.asarray(v) for v in pf.avail),
        tuple(jnp.asarray(v) for v in pf.levels),
        tuple(jnp.asarray(v) for v in pf.rmeta),
        jnp.asarray(pic.qp_y.astype(np.int32)),
        jnp.asarray(pic.bs_v.astype(np.int32)),
        jnp.asarray(pic.bs_h.astype(np.int32)),
        dbp["beta_offset"] if do_deblock else 0,
        dbp["tc_offset"] if do_deblock else 0,
        dbp["cb_qp_offset"] if do_deblock else 0,
        dbp["cr_qp_offset"] if do_deblock else 0,
        tuple(jnp.asarray(sao_t[p]) for p in range(3)),
        tuple(jnp.asarray(sao_b[p]) for p in range(3)),
        tuple(jnp.asarray(sao_e[p]) for p in range(3)),
        tuple(jnp.asarray(sao_c[p]) for p in range(3)),
        pf.bit_depth, pf.n_chunks, regions, do_deblock, do_sao,
        sps.log2_ctb_size, sps.sub_w, sps.sub_h,
        *_mc_args(pf)[:4], mc_shapes=_mc_args(pf)[4],
        scale_bank=tuple(jnp.asarray(b) for b in pf.scale_bank))
    for plane, arr in enumerate((y, cb, cr)):
        pic.planes[plane][:] = np.asarray(arr).astype(
            pic.planes[plane].dtype)
    # filters already applied on device
    pic.deblock_params = None
    if hasattr(pic, "sao_map"):
        pic.sao_map = {}
    pic.has_sao = False
    pic.sao_arrays = None
