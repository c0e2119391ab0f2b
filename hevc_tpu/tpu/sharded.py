"""Tile-sharded stage-B filtering: deblock + SAO over a device mesh.

The device-mesh analogue of the reference's tile parallelism + seam pass
(reference: hevcdec.c:3144-3194 per-tile jobs, :3292-3328 tiles_filters
cross-tile deblock/SAO; SURVEY.md §2.2).  The frame is sharded in column
bands over a ("tile",) mesh axis; the cross-tile dependency becomes an
explicit halo exchange (jax.lax.ppermute between devices):

- deblock: a 16-luma-pixel halo of the unfiltered plane (and the 4x4 QP /
  boundary-strength maps) — a vertical-edge filter segment reads 4 and
  writes 3 pixels on each side of an edge, and the 8-pixel edge grid must
  stay aligned across the band boundary for both luma and subsampled
  chroma;
- SAO: a 1-pixel halo of the *deblocked* plane (SAO edge classification
  reads the 8-neighbourhood after deblocking).

Bit-exactness contract: for any shard count whose band width is a
multiple of the CTB size, the result equals the single-device
deblock_jax + sao_plane_jax output (tests/test_sharded.py), which is
itself bit-exact vs the openHEVC oracle.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .filters import _luma_pass, _chroma_pass, _upsample, _EO


def _halo(x, hw: int, n: int, axis_name: str):
    """Exchange hw columns with both neighbours along `axis_name`.

    Returns (left_halo, right_halo) for the local shard; shards at the
    frame boundary receive zeros (never read: boundary edges carry bs=0
    and SAO validity masks use global coordinates)."""
    send_r = [(i, i + 1) for i in range(n - 1)]
    send_l = [(i + 1, i) for i in range(n - 1)]
    left = jax.lax.ppermute(x[:, -hw:], axis_name, send_r)
    right = jax.lax.ppermute(x[:, :hw], axis_name, send_l)
    return left, right


def _sao_local(ext, tmap, pos, offs4, cls, ctb_log2: int, bd: int,
               x0, w_global: int):
    """SAO over one column band given a 1-pixel column halo.

    ext: int32 [h, wb+2] deblocked band with halo; maps are the band's
    per-CTB parameters; x0 = global column of the band start (traced).
    Mirrors filters.sao_plane_jax exactly, with validity computed in
    global frame coordinates."""
    h = ext.shape[0]
    wb = ext.shape[1] - 2
    cs = 1 << ctb_log2
    maxv = (1 << bd) - 1
    plane = ext[:, 1:-1]
    t = _upsample(tmap, cs, h, wb)
    posm = _upsample(pos, cs, h, wb)
    offs = _upsample(offs4, cs, h, wb)
    clsm = _upsample(cls, cs, h, wb)

    band = plane >> (bd - 5)
    band_off = jnp.zeros_like(plane)
    for k in range(4):
        band_off = band_off + jnp.where(band == ((posm + k) & 31),
                                        offs[..., k], 0)
    band_out = jnp.clip(plane + band_off, 0, maxv)

    yy = jax.lax.broadcasted_iota(jnp.int32, (h, wb), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, wb), 1) + x0
    padv = jnp.pad(ext, ((1, 1), (0, 0)), mode="edge")

    def shifted(dy, dx):
        return jax.lax.dynamic_slice(padv, (1 + dy, 1 + dx), (h, wb))

    edge_out = plane
    for k, (ay, ax, by, bx) in enumerate(_EO):
        a = shifted(ay, ax)
        b = shifted(by, bx)
        idx = 2 + jnp.sign(plane - a) + jnp.sign(plane - b)
        cat = jnp.where(idx == 2, 0, jnp.where(idx < 2, idx + 1, idx))
        off = jnp.zeros_like(plane)
        for c in range(4):
            off = off + jnp.where(cat == c + 1, offs[..., c], 0)
        valid = ((yy + ay >= 0) & (yy + ay < h)
                 & (xx + ax >= 0) & (xx + ax < w_global)
                 & (yy + by >= 0) & (yy + by < h)
                 & (xx + bx >= 0) & (xx + bx < w_global))
        res = jnp.where(valid, jnp.clip(plane + off, 0, maxv), plane)
        edge_out = jnp.where(clsm == k, res, edge_out)
    return jnp.where(t == 1, band_out, jnp.where(t == 2, edge_out, plane))


def _filters_in_shard(y, cb, cr, qp4, bs_v, bs_h, beta_off, tc_off,
                      cb_qp_off, cr_qp_off, st, sp, so, sc, *, n, axis,
                      bit_depth, ctb_log2, sub_w, sub_h, do_deblock,
                      do_sao):
    """Deblock + SAO on one column band inside a shard_map body.

    Vertical-edge deblock exchanges a 16-luma-pixel halo; SAO a 1-pixel
    halo of the deblocked planes.  Shared by filter_frame_sharded and
    the full banded pipeline (decode_gop_banded)."""
    if do_deblock:
        hl = 16                       # luma halo (8-grid aligned)
        hm = hl // 4                  # 4x4-map halo
        hc = hl // sub_w              # chroma halo
        parts = {}
        for name, arr, hw in (("y", y, hl), ("qp", qp4, hm),
                              ("bv", bs_v, hm),
                              ("cb", cb, hc), ("cr", cr, hc)):
            lft, rgt = _halo(arr, hw, n, axis)
            parts[name] = jnp.concatenate([lft, arr, rgt], axis=1)
        ey = _luma_pass(parts["y"], parts["qp"], parts["bv"],
                        beta_off, tc_off, bit_depth)[:, hl:-hl]
        ecb = _chroma_pass(parts["cb"], parts["qp"], parts["bv"],
                           tc_off, cb_qp_off, bit_depth,
                           sub_w, sub_h)[:, hc:-hc]
        ecr = _chroma_pass(parts["cr"], parts["qp"], parts["bv"],
                           tc_off, cr_qp_off, bit_depth,
                           sub_w, sub_h)[:, hc:-hc]
        # horizontal edges: column-independent → local transpose pass
        y = _luma_pass(ey.T, qp4.T, bs_h.T, beta_off, tc_off,
                       bit_depth).T
        cb = _chroma_pass(ecb.T, qp4.T, bs_h.T, tc_off, cb_qp_off,
                          bit_depth, sub_h, sub_w).T
        cr = _chroma_pass(ecr.T, qp4.T, bs_h.T, tc_off, cr_qp_off,
                          bit_depth, sub_h, sub_w).T
    if do_sao:
        idx = jax.lax.axis_index(axis)
        outs = []
        for plane_i, p in enumerate((y, cb, cr)):
            lg = ctb_log2 - (0 if plane_i == 0
                             else (sub_w.bit_length() - 1))
            lft, rgt = _halo(p, 1, n, axis)
            ext = jnp.concatenate([lft, p, rgt], axis=1)
            wb = p.shape[1]
            outs.append(_sao_local(
                ext, st[plane_i], sp[plane_i], so[plane_i],
                sc[plane_i], lg, bit_depth, idx * wb, wb * n))
        y, cb, cr = outs
    return y, cb, cr


def filter_frame_sharded(mesh: Mesh, y, cb, cr, qp4, bs_v, bs_h,
                         beta_off, tc_off, cb_qp_off, cr_qp_off,
                         sao_type, sao_band_pos, sao_offs4, sao_eo_class,
                         *, bit_depth: int, ctb_log2: int,
                         sub_w: int = 2, sub_h: int = 2,
                         do_deblock: bool = True, do_sao: bool = True,
                         axis: str = "tile"):
    """Deblock + SAO one frame, column-band-sharded over `mesh`.

    Planes are int32 [h, w] (luma) / subsampled (chroma); qp4/bs_* are
    the per-4x4 luma-grid maps; sao_* are 3-tuples of per-CTB maps as
    produced by recon.pack_sao_params.  Returns (y, cb, cr) with the
    same shardings as the inputs."""
    n = mesh.shape[axis]
    h, w = y.shape
    assert w % (n << ctb_log2) == 0, \
        f"band width {w}/{n} must be a multiple of the CTB size"
    band = w // n

    col = NamedSharding(mesh, P(None, axis))
    col3 = NamedSharding(mesh, P(None, axis, None))

    def run(y, cb, cr, qp4, bs_v, bs_h, st, sp, so, sc):
        return _filters_in_shard(
            y, cb, cr, qp4, bs_v, bs_h, beta_off, tc_off, cb_qp_off,
            cr_qp_off, st, sp, so, sc, n=n, axis=axis,
            bit_depth=bit_depth, ctb_log2=ctb_log2, sub_w=sub_w,
            sub_h=sub_h, do_deblock=do_deblock, do_sao=do_sao)

    spec = P(None, axis)
    kw = dict(mesh=mesh,
              in_specs=(spec,) * 6 + ((spec,) * 3,) * 2
              + ((P(None, axis, None),) * 3,) + ((spec,) * 3,),
              out_specs=(spec, spec, spec))
    fn = shard_map(run, **kw)
    args = tuple(jax.device_put(a, col) for a in
                 (y, cb, cr, qp4, bs_v, bs_h))
    sao_args = (tuple(jax.device_put(a, col) for a in sao_type),
                tuple(jax.device_put(a, col) for a in sao_band_pos),
                tuple(jax.device_put(a, col3) for a in sao_offs4),
                tuple(jax.device_put(a, col) for a in sao_eo_class))
    return jax.jit(fn)(*args, *sao_args)


# ---------------------------------------------------------------------------
# Full banded stage-B pipeline: MC + residual + intra recon + filters
# ---------------------------------------------------------------------------

def _make_ref_band(p, halo, n, axis):
    """Extend a decoded band into its reference window: exchange `halo`
    edge columns with both mesh neighbours (the MC-window halo exchange;
    reference analogue: inter-frame MC gated on producer rows,
    pthread_frame.c:570/592), replicate at frame borders, and add the
    PAD_REF vertical replication the MC read windows assume."""
    from .pack import PAD_REF
    left, right = _halo(p, halo, n, axis)
    idx = jax.lax.axis_index(axis)
    first = jnp.repeat(p[:, :1], halo, axis=1)
    last = jnp.repeat(p[:, -1:], halo, axis=1)
    left = jnp.where(idx == 0, first, left)
    right = jnp.where(idx == n - 1, last, right)
    ext = jnp.concatenate([left, p, right], axis=1)
    return jnp.pad(ext, ((PAD_REF, PAD_REF), (0, 0)), mode="edge")


def _step_in_specs(axis, n_mc, R):
    """Input PartitionSpecs of the banded per-frame step (one entry per
    arg of _gop_step's body, nested to match)."""
    b = P(axis)       # leading band axis
    c2 = P(None, axis)
    return (b, (b,) * 4, (b,) * 4, (b,) * 4, (b,) * 4,
            (b,) * n_mc, (b,) * 4,
            (c2,) * R, (c2,) * R, (c2,) * R,
            (P(),) * 4,
            c2, c2, c2, P(),
            P(None, None, axis), P(None, None, axis),
            P(None, None, axis, None), P(None, None, axis))


def _globalize(mesh, arg, spec):
    """Make a process-spanning global jax.Array for `arg` under `spec`
    (multi-host path: every process holds the full host value and
    contributes its addressable shards).  Existing jax.Arrays (device
    DPB entries from previous frames) pass through."""
    if isinstance(arg, (list, tuple)):
        return tuple(_globalize(mesh, a, s) for a, s in zip(arg, spec))
    if isinstance(arg, jax.Array):
        return arg
    a = np.asarray(arg)
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(a.shape, sh,
                                        lambda idx: a[idx])


# compiled per-frame step cache: (mesh, statics) -> jitted shard_map.
# A fresh closure per frame would recompile every frame; with bucketed
# shapes (band.unify_bands) successive frames of a stream hit this
# cache and compile ONCE per geometry.
_step_cache = {}


def _gop_step(mesh, axis, n, R, bd, n_chunks, regions, mc_shapes,
              do_deblock, do_sao, ctb_log2, sub_w, sub_h,
              halo_l, halo_c):
    from .intra import reconstruct_wavefront
    from .mc import mc_phase, resid_phase
    from .recon import _residuals

    key = (id(mesh), axis, n, R, bd, n_chunks, regions, mc_shapes,
           do_deblock, do_sao, ctb_log2, sub_w, sub_h, halo_l, halo_c)
    got = _step_cache.get(key)
    if got is not None:
        return got

    def body(canvas, scal, avail, levels, rmeta, mc_fields,
             resid_fields, refs_yt, refs_cbt, refs_crt, bank,
             qp4, bs_v, bs_h, dboff, sao_t, sao_b, sao_o, sao_e):
        canvas = canvas[0].astype(jnp.int32)
        scal = tuple(s[0] for s in scal)
        avail = tuple(a[0] for a in avail)
        levels = tuple(v[0] for v in levels)
        rmeta = tuple(m[0] for m in rmeta)
        resids = _residuals(levels, rmeta, bd, bank)
        if R:
            refs_l = jnp.stack(refs_yt)
            refs_c = jnp.stack(list(refs_cbt) + list(refs_crt))
            groups = tuple(k + (f[0],) for k, f in zip(mc_shapes,
                                                       mc_fields))
            canvas = mc_phase(canvas, refs_l, refs_c, groups, bd)
        canvas = resid_phase(canvas,
                             tuple(g[0] for g in resid_fields),
                             resids, bd)
        out = reconstruct_wavefront(canvas, scal, avail, resids, bd,
                                    n_chunks)
        planes = [jax.lax.dynamic_slice(out, (oy, ox), (h, w))
                  for oy, ox, h, w in regions]
        y, cb, cr = planes
        y, cb, cr = _filters_in_shard(
            y, cb, cr, qp4, bs_v, bs_h, dboff[0], dboff[1],
            dboff[2], dboff[3], sao_t, sao_b, sao_o, sao_e,
            n=n, axis=axis, bit_depth=bd, ctb_log2=ctb_log2,
            sub_w=sub_w, sub_h=sub_h, do_deblock=do_deblock,
            do_sao=do_sao)
        ry = _make_ref_band(y, halo_l, n, axis)
        rcb = _make_ref_band(cb, halo_c, n, axis)
        rcr = _make_ref_band(cr, halo_c, n, axis)
        return y, cb, cr, ry, rcb, rcr

    in_specs = _step_in_specs(axis, len(mc_shapes), R)
    c2 = P(None, axis)
    out_specs = (c2, c2, c2, c2, c2, c2)
    kw = dict(mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    fn = shard_map(body, **kw)
    fn = jax.jit(fn)
    _step_cache[key] = fn
    return fn


def decode_gop_banded(mesh: Mesh, frames, halo_l=32, halo_c=16,
                      axis: str = "tile", globalize: bool = False,
                      dpb=None):
    """Decode a GOP with every stage-B phase column-band-sharded.

    globalize=True: the mesh spans multiple PROCESSES (jax.distributed
    multi-host) — inputs are converted to global arrays via
    make_array_from_callback (each process contributes its addressable
    shards); outputs come back as global arrays whose addressable
    shards each process checks locally.

    frames: list of per-frame bundles as built by
    band.prepare_gop_banded —
      {"arrays", "spec" (unify_bands output), "poc", "ref_pocs_l0/_l1",
       "qp4", "bs_v", "bs_h", "dboff", "sao" (t, b, o, e stacks),
       "do_deblock", "do_sao", "ctb_log2", "sub_w", "sub_h"}.
    The device DPB holds halo-extended band reference windows; each
    frame's MC reads only its band window (refs never leave the
    device), and windows refresh with one ppermute halo exchange per
    plane after the filters.  Returns [(y, cb, cr)] global arrays."""
    n = mesh.shape[axis]
    dpb = {} if dpb is None else dpb
    outs = []
    for fb in frames:
        A, S = fb["arrays"], fb["spec"]
        mc_shapes = S["mc_shapes"]
        pocs = list(fb["ref_pocs_l0"]) + list(fb["ref_pocs_l1"])
        R = len(pocs) if mc_shapes else 0
        refs_y = tuple(dpb[p][0] for p in pocs) if R else ()
        refs_cb = tuple(dpb[p][1] for p in pocs) if R else ()
        refs_cr = tuple(dpb[p][2] for p in pocs) if R else ()
        fn = _gop_step(mesh, axis, n, R, S["bit_depth"], S["n_chunks"],
                       S["regions"], mc_shapes, fb["do_deblock"],
                       fb["do_sao"], fb["ctb_log2"], fb["sub_w"],
                       fb["sub_h"], halo_l, halo_c)
        sao_t, sao_b, sao_o, sao_e = fb["sao"]
        args = (A["canvas"], tuple(A["scal"]), tuple(A["avail"]),
                tuple(A["levels"]), tuple(A["rmeta"]),
                tuple(A["mc_fields"]) if mc_shapes else (),
                tuple(A["resid_fields"]),
                refs_y, refs_cb, refs_cr,
                tuple(np.asarray(bk) for bk in S["scale_bank"]),
                fb["qp4"], fb["bs_v"], fb["bs_h"],
                np.asarray(fb["dboff"], np.int32),
                sao_t, sao_b, sao_o, sao_e)
        if globalize:
            specs = _step_in_specs(axis, len(mc_shapes), R)
            args = tuple(_globalize(mesh, a, s)
                         for a, s in zip(args, specs))
        y, cb, cr, ry, rcb, rcr = fn(*args)
        dpb[fb["poc"]] = (ry, rcb, rcr)
        outs.append((y, cb, cr))
    return outs


def _rewiden_dpb(mesh, axis, n, dpb, old_halo, new_halo):
    """Re-shard the device DPB's band reference windows to a wider
    halo: slice each window back to its band core and re-run the
    ppermute halo exchange at the new width (no host round-trip)."""
    from .pack import PAD_REF
    (ol, oc), (nl, nc) = old_halo, new_halo

    def body(y, cb, cr):
        def one(w, oh, nh):
            core = w[PAD_REF:w.shape[0] - PAD_REF,
                     oh:w.shape[1] - oh]
            return _make_ref_band(core, nh, n, axis)
        return one(y, ol, nl), one(cb, oc, nc), one(cr, oc, nc)

    f = jax.jit(shard_map(body, mesh=mesh,
                          in_specs=(P(None, axis),) * 3,
                          out_specs=(P(None, axis),) * 3))
    return {poc: f(*w3) for poc, w3 in dpb.items()}


def decode_stream_banded(mesh: Mesh, frame_iter, axis: str = "tile"):
    """STREAMING banded decode: consume band.iter_gop_banded's
    (bundle, halo) pairs as stage A produces them, re-sharding the
    device DPB whenever the per-frame MV bound widens the halo
    (frames decode before the GOP's stage A
    completes, and a growing MV range degrades to a re-shard instead
    of an assert).  Returns [(y, cb, cr)] like decode_gop_banded."""
    n = mesh.shape[axis]
    dpb = {}
    cur = None
    outs = []
    for fb, halo in frame_iter:
        if cur is not None and halo != cur:
            dpb2 = _rewiden_dpb(mesh, axis, n, dpb, cur, halo)
            dpb.clear()
            dpb.update(dpb2)
        cur = halo
        outs += decode_gop_banded(mesh, [fb], halo_l=halo[0],
                                  halo_c=halo[1], axis=axis, dpb=dpb)
    return outs
