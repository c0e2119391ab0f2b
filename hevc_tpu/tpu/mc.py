"""Device-side motion compensation (JAX/XLA), bit-exact.

Stage-B replacement for the reference's qpel/epel SIMD kernel grid
(reference: libavcodec/hevcdsp_template.c:2359-3375, x86/hevc_mc.asm) —
Re-designed for the accelerator: all PBs of one (plane-kind, w, h) group across a frame are
vmapped; interpolation runs as a unified two-stage separable filter
(full-pel positions use a unit tap, which reproduces the spec's shift
algebra exactly), reads come from replication-padded reference stacks
via dynamic_slice, and each group commits with one scatter.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import mc as M

# unified tap tables: row 0 = unit (full-pel)
QPEL_TAPS = np.zeros((4, 8), np.int32)
QPEL_TAPS[0, 3] = 64
for f in (1, 2, 3):
    QPEL_TAPS[f] = M.QPEL_FILTERS[f]
EPEL_TAPS = np.zeros((8, 4), np.int32)
EPEL_TAPS[0, 1] = 64
for f in range(1, 8):
    EPEL_TAPS[f] = M.EPEL_FILTERS[f]


def _interp_raw(win, th, tv, w, h, ntaps, bd):
    """14-bit predSamples.  win: [h+ntaps-1, w+ntaps-1] int32."""
    shift1 = bd - 8
    tmp = jnp.zeros((h + ntaps - 1, w), jnp.int32)
    for i in range(ntaps):
        tmp = tmp + th[i] * win[:, i:i + w]
    tmp = tmp >> shift1 if shift1 else tmp
    out = jnp.zeros((h, w), jnp.int32)
    for i in range(ntaps):
        out = out + tv[i] * tmp[i:i + h, :]
    return out >> 6


def make_mc_group_fn(is_chroma: bool, bi: bool, w: int, h: int, bd: int,
                     wp: bool = False):
    """Build the vmapped MC for one (kind, bi, w, h, wp) group.

    Uni fields (int32 [N,7]): ref_sel, base_y, base_x, frac_x, frac_y,
    cy, cx.  Bi fields ([N,12]): two (sel, by, bx, fx, fy) sets + cy, cx.
    Explicit-WP groups (wp=True) append (w0, o0, w1, o1, log2wd) per row
    (8.5.4.3.3; offsets pre-scaled by << (bd - 8)).  Base coords are
    padded-ref window origins."""
    ntaps = 4 if is_chroma else 8
    taps = jnp.asarray(EPEL_TAPS if is_chroma else QPEL_TAPS)
    maxv = (1 << bd) - 1
    base = 10 if bi else 5  # first col after the prediction fields

    def raw(refs, sel, by, bx, fx, fy):
        win = jax.lax.dynamic_slice(
            refs, (sel, by, bx), (1, h + ntaps - 1, w + ntaps - 1))[0]
        return _interp_raw(win, taps[fx], taps[fy], w, h, ntaps, bd)

    if bi:
        def one(refs, f):
            p0 = raw(refs, f[0], f[1], f[2], f[3], f[4])
            p1 = raw(refs, f[5], f[6], f[7], f[8], f[9])
            if wp:
                w0, o0 = f[base + 2], f[base + 3]
                w1, o1 = f[base + 4], f[base + 5]
                lwd = f[base + 6]
                return jnp.clip(
                    (p0 * w0 + p1 * w1 + ((o0 + o1 + 1) << lwd))
                    >> (lwd + 1), 0, maxv)
            shift = 15 - bd
            return jnp.clip((p0 + p1 + (1 << (shift - 1))) >> shift,
                            0, maxv)
    else:
        def one(refs, f):
            p = raw(refs, f[0], f[1], f[2], f[3], f[4])
            if wp:
                w0, o0, lwd = f[base + 2], f[base + 3], f[base + 6]
                v = jnp.where(lwd >= 1,
                              ((p * w0 + (1 << jnp.maximum(lwd - 1, 0)))
                               >> lwd) + o0,
                              p * w0 + o0)
                return jnp.clip(v, 0, maxv)
            shift = 14 - bd
            return jnp.clip((p + (1 << (shift - 1))) >> shift, 0, maxv)

    return jax.vmap(one, in_axes=(None, 0))


def mc_phase(canvas, refs_l, refs_c, groups, bd):
    """Apply all MC predictions.  groups: tuple of
    (is_chroma, bi, w, h, wp, fields)."""
    for is_chroma, bi, w, h, wp, fields in groups:
        refs = refs_c if is_chroma else refs_l
        fn = make_mc_group_fn(is_chroma, bi, w, h, bd, wp)
        blk = fn(refs, fields)
        base = 10 if bi else 5
        cy, cx = fields[:, base], fields[:, base + 1]
        ii = jax.lax.broadcasted_iota(jnp.int32, (1, h, w), 1)
        jj = jax.lax.broadcasted_iota(jnp.int32, (1, h, w), 2)
        canvas = canvas.at[cy[:, None, None] + ii,
                           cx[:, None, None] + jj].set(blk, mode="drop")
    return canvas


def resid_phase(canvas, groups, resids, bd):
    """Add inter residuals onto the canvas.  groups: tuple per size class
    of int32 [N, 3] = (cy, cx, slot); resids: per-class pools."""
    maxv = (1 << bd) - 1
    for c, fields in enumerate(groups):
        if fields.shape[0] == 0:
            continue
        s = 4 << c
        cy, cx, slot = fields[:, 0], fields[:, 1], fields[:, 2]

        def read(canvas, y, x):
            return jax.lax.dynamic_slice(canvas, (y, x), (s, s))

        base = jax.vmap(read, in_axes=(None, 0, 0))(canvas, cy, cx)
        rec = jnp.clip(base + resids[c][slot], 0, maxv)
        ii = jax.lax.broadcasted_iota(jnp.int32, (1, s, s), 1)
        jj = jax.lax.broadcasted_iota(jnp.int32, (1, s, s), 2)
        canvas = canvas.at[cy[:, None, None] + ii,
                           cx[:, None, None] + jj].set(rec, mode="drop")
    return canvas
