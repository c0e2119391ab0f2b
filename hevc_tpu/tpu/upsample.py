"""Device-side SHVC inter-layer upsampling (JAX/XLA), bit-exact.

Vectorized re-design of the reference's SIMD upsamplers (reference:
libavcodec/x86/hevc_il_pred_sse.c): both separable passes become
per-tap shifted multiply-accumulates with per-output-coordinate phase
taps gathered once from 16-entry tables — fully vectorized elementwise work,
no per-sample gathers (source columns/rows are selected by a
precomputed index vector, a single gather per tap)."""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import upsample as U


@partial(jax.jit, static_argnames=("el_h", "el_w", "bl_bd", "el_bd",
                                   "chroma"))
def resample_plane_jax(src, ref_x, ph_x, ref_y, ph_y, el_h, el_w,
                       bl_bd, el_bd, chroma=False):
    """src: int32 [bl_h, bl_w]; ref/ph: precomputed position vectors."""
    taps = jnp.asarray(U.UP_FILTER_CHROMA if chroma else U.UP_FILTER_LUMA)
    ntaps = 4 if chroma else 8
    center = ntaps // 2 - 1
    bl_h, bl_w = src.shape
    shift_up = bl_bd - 8
    n_shift = 20 - el_bd
    tmp = jnp.zeros((bl_h, el_w), jnp.int32)
    tx = taps[ph_x]  # [el_w, ntaps]
    for t in range(ntaps):
        cols = jnp.clip(ref_x + t - center, 0, bl_w - 1)
        tmp = tmp + tx[:, t][None, :] * src[:, cols]
    if shift_up:
        tmp = tmp >> shift_up
    out = jnp.zeros((el_h, el_w), jnp.int32)
    ty = taps[ph_y]
    for t in range(ntaps):
        rows = jnp.clip(ref_y + t - center, 0, bl_h - 1)
        out = out + ty[:, t][:, None] * tmp[rows, :]
    out = (out + (1 << (n_shift - 1))) >> n_shift
    return jnp.clip(out, 0, (1 << el_bd) - 1)


def upsample_frame_jax(bl_planes, el_w, el_h, *, sub_w=2, sub_h=2,
                       bl_bit_depth=8, el_bit_depth=8):
    """Device mirror of ops.upsample.upsample_frame."""
    bl_h, bl_w = bl_planes[0].shape
    sx = U.scale_factor(bl_w, el_w)
    sy = U.scale_factor(bl_h, el_h)
    out = []
    rx, px = U._positions(el_w, sx, U.phase_add(0, sx))
    ry, py = U._positions(el_h, sy, U.phase_add(0, sy))
    out.append(resample_plane_jax(
        jnp.asarray(bl_planes[0], jnp.int32), jnp.asarray(rx),
        jnp.asarray(px), jnp.asarray(ry), jnp.asarray(py),
        el_h, el_w, bl_bit_depth, el_bit_depth, chroma=False))
    ph_v = (4 * el_h + (bl_h >> 1)) // bl_h - 4 if sub_h == 2 else 0
    rxc, pxc = U._positions(el_w // sub_w, sx, U.phase_add(0, sx))
    ryc, pyc = U._positions(el_h // sub_h, sy, U.phase_add(ph_v, sy))
    for c in (1, 2):
        out.append(resample_plane_jax(
            jnp.asarray(bl_planes[c], jnp.int32), jnp.asarray(rxc),
            jnp.asarray(pxc), jnp.asarray(ryc), jnp.asarray(pyc),
            el_h // sub_h, el_w // sub_w, bl_bit_depth, el_bit_depth,
            chroma=True))
    return out


# ---------------------------------------------------------------------------
# CGS colour mapping (device mirror of ops.cgs.color_map_frame)
# ---------------------------------------------------------------------------

def color_map_frame_jax(cgs, planes):
    """Device 3D-LUT colour mapping for 4:2:0 (reference:
    hevcdsp_template.c:4511 map_color_block semantics — see
    ops/cgs.py).  cgs: ops.cgs.CgsLut; planes: int arrays.  The LUT is
    tiny (<= 16x4x4 cuboids); per-pixel cuboid selection is a flat
    gather of the 12 vertex coefficients."""
    import jax.numpy as jnp

    y = jnp.asarray(planes[0], jnp.int32)
    u = jnp.asarray(planes[1], jnp.int32)
    v = jnp.asarray(planes[2], jnp.int32)

    lut = jnp.asarray(cgs.lut.reshape(-1, 4, 3))  # [Y*C*C, 4, 3]
    csz = cgs.c_size

    def cub_index(y_val, u_val, v_val):
        yi = y_val >> cgs.y_shift2idx
        if cgs.octant_depth == 1:
            ui = (u_val >= cgs.adapt_threshold_u).astype(jnp.int32)
            vi = (v_val >= cgs.adapt_threshold_v).astype(jnp.int32)
        else:
            ui = u_val >> cgs.c_shift2idx
            vi = v_val >> cgs.c_shift2idx
        return (yi * csz + ui) * csz + vi

    def map_comp(comp, y_val, u_val, v_val):
        cub = lut[cub_index(y_val, u_val, v_val)]    # [..., 4, 3]
        p = cub[..., comp]
        return ((p[..., 0] * y_val + p[..., 1] * u_val
                 + p[..., 2] * v_val + cgs.mapping_offset)
                >> cgs.mapping_shift) + p[..., 3]

    def wrap16(x):
        return ((x + (1 << 15)) & 0xFFFF) - (1 << 15)

    up = jnp.concatenate([u[:1], u[:-1]], 0)
    vp = jnp.concatenate([v[:1], v[:-1]], 0)
    un = jnp.concatenate([u[1:], u[-1:]], 0)
    vn = jnp.concatenate([v[1:], v[-1:]], 0)
    ur = jnp.concatenate([u[:, 1:], u[:, -1:]], 1)
    vr = jnp.concatenate([v[:, 1:], v[:, -1:]], 1)
    upr = jnp.concatenate([up[:, 1:], up[:, -1:]], 1)
    vpr = jnp.concatenate([vp[:, 1:], vp[:, -1:]], 1)
    unr = jnp.concatenate([un[:, 1:], un[:, -1:]], 1)
    vnr = jnp.concatenate([vn[:, 1:], vn[:, -1:]], 1)
    a_u, a_v = ur + u, vr + v
    tmp = [
        ((up + 3 * u + 2) >> 2, (vp + 3 * v + 2) >> 2),
        ((3 * a_u + up + upr + 4) >> 3, (3 * a_v + vp + vpr + 4) >> 3),
        ((un + 3 * u + 2) >> 2, (vn + 3 * v + 2) >> 2),
        ((3 * a_u + un + unr + 4) >> 3, (3 * a_v + vn + vnr + 4) >> 3),
    ]
    max_y = (1 << cgs.out_bd_y) - 1
    quads = []
    for quad, (tu, tv) in enumerate(tmp):
        yy, xx = quad >> 1, quad & 1
        val = y[yy::2, xx::2]
        quads.append(jnp.clip(wrap16(map_comp(0, val, tu, tv)),
                              0, max_y))
    ch, cw = u.shape
    # interleave the quadrants: order (0,0),(0,1),(1,0),(1,1)
    out_y = jnp.zeros((ch * 2, cw * 2), jnp.int32)
    out_y = out_y.at[0::2, 0::2].set(quads[0])
    out_y = out_y.at[0::2, 1::2].set(quads[1])
    out_y = out_y.at[1::2, 0::2].set(quads[2])
    out_y = out_y.at[1::2, 1::2].set(quads[3])
    y_aver = (y[0::2, 0::2] + y[1::2, 0::2] + 1) >> 1
    max_c = (1 << cgs.out_bd_c) - 1
    out_u = jnp.clip(wrap16(map_comp(1, y_aver, u, v)), 0, max_c)
    out_v = jnp.clip(wrap16(map_comp(2, y_aver, u, v)), 0, max_c)
    return [out_y, out_u, out_v]
