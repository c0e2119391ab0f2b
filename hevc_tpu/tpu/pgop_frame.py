"""Frame-axis parallel decode of B frames over a device mesh.

Two entry points:

  * decode_bframes_frame_axis — the original harness: a bespoke
    parallel-B GOP (encoder/pgop.py) with structurally-independent Bs.
  * decode_frame_parallel — the GENERAL path: consumes
    ANY stream through the public decoder, groups decode-order
    pictures into dependency batches (a picture joins the current
    batch iff every reference lies in an EARLIER batch — the static
    form of pthread_frame.c:570/592's per-row progress gating), and
    reconstructs each multi-picture batch level-parallel over the
    ("frame",) mesh axis, references sharded per frame.  Hierarchical-B
    RA GOPs from the NORMAL encoder batch their B levels automatically.

This is the reference's frame-thread wavefront (pthread_frame.c:395/484
keeps N decoder clones in flight gated by row-progress counters)
re-expressed as SPMD sharding: every device runs the same compiled
program on different per-frame metadata, with each frame's reference
windows in its own shard.  Bit-exactness: each device's output equals
the sequential single-chip decode of its frame
(__graft_entry__.dryrun_multichip frame axis, tests/test_pgop.py).
"""
from __future__ import annotations

import numpy as np


def ref_batches(captured):
    """Group decode-order (pic, ...) items into maximal batches whose
    references all lie in EARLIER batches.

    This is the static dependency schedule of the reference's frame
    threads: a picture may start once its refs' progress allows
    (pthread_frame.c:570); with whole-frame granularity that means
    "refs fully decoded", i.e. in a previous batch."""
    batches, cur = [], []
    done, cur_pocs = set(), set()
    for item in captured:
        pic = item[0]
        refs = {e[0] for e in (getattr(pic, "ref_list_l0", []) or [])} \
            | {e[0] for e in (getattr(pic, "ref_list_l1", []) or [])}
        if cur and refs <= done:
            cur.append(item)
            cur_pocs.add(pic.poc)
        else:
            if cur:
                batches.append(cur)
                done |= cur_pocs
            cur, cur_pocs = [item], {pic.poc}
            assert refs <= done or not batches, \
                "decode order violates ref availability"
    if cur:
        batches.append(cur)
    return batches


def decode_frame_parallel(stream, devs, max_width=None):
    """Decode ANY stream with batch-of-frames stage B over a ("frame",)
    mesh; returns (got, want) pairs per picture in poc order:
    got = mesh-parallel planes, want = sequential-decode planes.

    Stage A runs in decode order on the host (entropy decode is
    inherently serial per picture here); stage B of each dependency
    batch runs SPMD over min(len(batch), len(devs)) devices.  Output
    is asserted identical to the sequential decode by the caller
    (tests/test_pgop.py, __graft_entry__.dryrun_multichip)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    import hevc_tpu.decoder.core as dcore
    from .band import unify_bands
    from .filters import deblock_jax, sao_plane_jax
    from .intra import reconstruct_wavefront
    from .mc import mc_phase, resid_phase
    from .pack import pack_frame
    from .recon import _residuals, pack_sao_params

    captured = []
    orig = dcore.execute_plan_numpy

    def capture(pic, plan):
        captured.append((pic, list(plan),
                         getattr(pic, "deblock_params", None)))
        orig(pic, plan)

    dcore.execute_plan_numpy = capture
    try:
        decoded = dcore.Decoder(recon_backend="plan").decode_bytes(
            stream)
    finally:
        dcore.execute_plan_numpy = orig
    by_poc = {f.poc: f for f in decoded}

    out = {}
    for batch in ref_batches(captured):
        # uniform filter flags / ref-presence per sub-batch (static in
        # the program; a mid-stream CRA's empty ref stack cannot mix
        # with inter frames' full-size stacks)
        def sig(item):
            pic, _plan, dbp = item
            return (dbp is not None,
                    bool(getattr(pic, "has_sao", False))
                    or bool(getattr(pic, "sao_map", None)),
                    bool(getattr(pic, "ref_list_l0", None)
                         or getattr(pic, "ref_list_l1", None)))
        while batch:
            flags0 = sig(batch[0])
            k = 1
            while k < len(batch) and k < len(devs) \
                    and sig(batch[k]) == flags0:
                k += 1
            sub, batch = batch[:k], batch[k:]
            out.update(_run_batch(sub, devs, flags0, by_poc,
                                  jax, jnp, Mesh, P, shard_map,
                                  unify_bands, deblock_jax,
                                  sao_plane_jax, reconstruct_wavefront,
                                  mc_phase, resid_phase, pack_frame,
                                  _residuals, pack_sao_params))
    pocs = sorted(out)
    got = [out[p] for p in pocs]
    want = [[np.asarray(pl) for pl in by_poc[p].planes] for p in pocs]
    return got, want


def _run_batch(sub, devs, flags, by_poc, jax, jnp, Mesh, P, shard_map,
               unify_bands, deblock_jax, sao_plane_jax,
               reconstruct_wavefront, mc_phase, resid_phase, pack_frame,
               _residuals, pack_sao_params):
    """Stage B of one dependency batch, SPMD when len(sub) > 1."""
    do_deblock, do_sao, _has_refs = flags
    n = len(sub)
    pfs, qp4s, bss_v, bss_h, dboffs, saos = [], [], [], [], [], []
    for pic, plan, dbp in sub:
        pfs.append(pack_frame(pic, plan))
        pic.compute_bs()
        qp4s.append(pic.qp_y.astype(np.int32))
        bss_v.append(pic.bs_v.astype(np.int32))
        bss_h.append(pic.bs_h.astype(np.int32))
        dboffs.append([dbp["beta_offset"], dbp["tc_offset"],
                       dbp["cb_qp_offset"], dbp["cr_qp_offset"]]
                      if dbp else [0, 0, 0, 0])
        saos.append(tuple(np.asarray(a) for a in pack_sao_params(pic)))
    # pad per-frame ref stacks to a common count (repeat last plane;
    # sel indices never reach the padding)
    rmax = max((pf.refs_l.shape[0] for pf in pfs), default=0)
    for pf in pfs:
        for attr in ("refs_l", "refs_c"):
            r = getattr(pf, attr)
            want_n = rmax if attr == "refs_l" else 2 * rmax
            if r.shape[0] < want_n and r.shape[0]:
                pad = np.repeat(r[-1:], want_n - r.shape[0], axis=0)
                setattr(pf, attr, np.concatenate([r, pad]))
    arrays, spec = unify_bands(pfs)
    bd = spec["bit_depth"]
    n_chunks = spec["n_chunks"]
    regions = spec["regions"]
    mc_shapes = spec["mc_shapes"]
    sps = sub[0][0].sps

    def body(canvas, scal, avail, levels, rmeta, mc_fields,
             resid_fields, refs_l, refs_c, bank, qp4, bs_v, bs_h,
             dboff, sao_t, sao_b, sao_o, sao_e):
        canvas = canvas[0].astype(jnp.int32)
        resids = _residuals(tuple(v[0] for v in levels),
                            tuple(m[0] for m in rmeta), bd, bank)
        groups = tuple(k + (f[0],)
                       for k, f in zip(mc_shapes, mc_fields))
        canvas = mc_phase(canvas, refs_l[0], refs_c[0], groups, bd)
        canvas = resid_phase(canvas, tuple(g[0] for g in resid_fields),
                             resids, bd)
        outc = reconstruct_wavefront(canvas, tuple(s[0] for s in scal),
                                     tuple(a[0] for a in avail),
                                     resids, bd, n_chunks)
        y, cb, cr = [jax.lax.dynamic_slice(outc, (oy, ox), (h, w))
                     for oy, ox, h, w in regions]
        if do_deblock:
            d = dboff[0]
            y, cb, cr = deblock_jax(y, cb, cr, qp4[0], bs_v[0], bs_h[0],
                                    d[0], d[1], d[2], d[3], bd=bd,
                                    sub_w=sps.sub_w, sub_h=sps.sub_h)
        if do_sao:
            planes = []
            for i, p in enumerate((y, cb, cr)):
                lg = sps.log2_ctb_size - (
                    0 if i == 0 else sps.sub_w.bit_length() - 1)
                planes.append(sao_plane_jax(
                    p, sao_t[0][i], sao_b[0][i], sao_o[0][i],
                    sao_e[0][i], lg, bd))
            y, cb, cr = planes
        return y[None], cb[None], cr[None]

    n_dev = min(len(devs), max(n, 1))
    n_pad = -(-n // n_dev) * n_dev

    def pad_n(a):  # pad the batch axis to a device multiple (dropped)
        a = np.asarray(a)
        if a.shape[0] < n_pad:
            a = np.concatenate([a] + [a[-1:]] * (n_pad - a.shape[0]))
        return a

    # frame-stacked leaves (everything except the replicated scale bank)
    stacked = [arrays["canvas"], *arrays["scal"], *arrays["avail"],
               *arrays["levels"], *arrays["rmeta"],
               *arrays["mc_fields"], *arrays["resid_fields"],
               arrays["refs_l"], arrays["refs_c"],
               np.stack(qp4s), np.stack(bss_v), np.stack(bss_h),
               np.asarray(dboffs, np.int32),
               np.stack([s[0] for s in saos]),
               np.stack([s[1] for s in saos]),
               np.stack([s[2] for s in saos]),
               np.stack([s[3] for s in saos])]
    stacked = [pad_n(a) for a in stacked]
    bank = tuple(jnp.asarray(b) for b in spec["scale_bank"])

    def rebuild(parts):
        it = iter(parts)

        def take(k):
            return tuple(next(it) for _ in range(k))
        canvas = next(it)
        scal, avail = take(4), take(4)
        levels, rmeta = take(4), take(4)
        mc_fields = take(len(mc_shapes))
        resid_fields = take(4)
        refs_l, refs_c = next(it), next(it)
        qp4, bs_v, bs_h, dboff = next(it), next(it), next(it), next(it)
        sao_t, sao_b, sao_o, sao_e = next(it), next(it), next(it), \
            next(it)
        return (canvas, scal, avail, levels, rmeta, mc_fields,
                resid_fields, refs_l, refs_c, bank, qp4, bs_v, bs_h,
                dboff, sao_t, sao_b, sao_o, sao_e)

    if n_dev > 1:
        mesh = Mesh(np.asarray(devs[:n_dev]), ("frame",))
        f = P("frame")
        in_specs = (f, (f,) * 4, (f,) * 4, (f,) * 4, (f,) * 4,
                    (f,) * len(mc_shapes), (f,) * 4,
                    f, f, (P(),) * 4,
                    f, f, f, f, f, f, f, f)
        kw = dict(mesh=mesh, in_specs=in_specs, out_specs=(f, f, f))
        fn = shard_map(body, **kw)
        ys, cbs, crs = jax.jit(fn)(*rebuild(stacked))
    else:
        ys, cbs, crs = [], [], []
        for k in range(n):
            y, cb, cr = jax.jit(body)(*rebuild(
                [a[k:k + 1] for a in stacked]))
            ys.append(y[0])
            cbs.append(cb[0])
            crs.append(cr[0])
    return {pic.poc: (np.asarray(ys[k]), np.asarray(cbs[k]),
                      np.asarray(crs[k]))
            for k, (pic, _pl, _d) in enumerate(sub)}


def decode_bframes_frame_axis(n_devices, devs, width=128, height=64,
                              qp=30):
    """Encode a parallel-B GOP, decode its n B frames concurrently over
    a ("frame",) mesh, and return (got, want): per-B (y, cb, cr) from
    the sharded decode and from the sequential (plan-backend) decode."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    import hevc_tpu.decoder.core as dcore
    from hevc_tpu.encoder.core import EncoderConfig
    from hevc_tpu.encoder.generate import synth_frame
    from hevc_tpu.encoder.pgop import ParallelBGopEncoder
    from .band import unify_bands
    from .filters import deblock_jax, sao_plane_jax
    from .intra import reconstruct_wavefront
    from .mc import mc_phase, resid_phase
    from .pack import pack_frame
    from .recon import _residuals, pack_sao_params

    n_b = n_devices
    cfg = EncoderConfig(width=width, height=height, qp=qp,
                        log2_ctb_size=5, log2_cu_size=5, gop="ra",
                        deblocking=True, sao=True, seed=2,
                        search_range=2)
    enc = ParallelBGopEncoder(cfg, n_b)
    stream = enc.encode([synth_frame("noise", width, height, t, seed=4)
                         for t in range(n_b + 2)])

    captured = []
    orig = dcore.execute_plan_numpy

    def capture(pic, plan):
        captured.append((pic, list(plan),
                         getattr(pic, "deblock_params", None)))
        orig(pic, plan)

    dcore.execute_plan_numpy = capture
    try:
        decoded = dcore.Decoder(recon_backend="plan").decode_bytes(stream)
    finally:
        dcore.execute_plan_numpy = orig
    by_poc = {f.poc: f for f in decoded}
    assert all(f.md5_ok for f in decoded)

    # B pictures are decode order 2.. (after the I and P anchors)
    bees = [(pic, plan, dbp) for pic, plan, dbp in captured
            if 1 <= pic.poc <= n_b]
    assert len(bees) == n_b
    pfs, qp4s, bss_v, bss_h, dboffs, saos = [], [], [], [], [], []
    for pic, plan, dbp in bees:
        pfs.append(pack_frame(pic, plan))
        pic.compute_bs()
        qp4s.append(pic.qp_y.astype(np.int32))
        bss_v.append(pic.bs_v.astype(np.int32))
        bss_h.append(pic.bs_h.astype(np.int32))
        dboffs.append([dbp["beta_offset"], dbp["tc_offset"],
                       dbp["cb_qp_offset"], dbp["cr_qp_offset"]]
                      if dbp else [0, 0, 0, 0])
        saos.append(tuple(np.asarray(a) for a in pack_sao_params(pic)))
    arrays, spec = unify_bands(pfs)  # leading axis = frame here
    bd = spec["bit_depth"]
    n_chunks = spec["n_chunks"]
    regions = spec["regions"]
    mc_shapes = spec["mc_shapes"]
    pic0 = bees[0][0]
    sps = pic0.sps
    do_deblock = bees[0][2] is not None
    do_sao = bool(getattr(pic0, "has_sao", False)) \
        or bool(getattr(pic0, "sao_map", None))

    # every B shares the same (I, P) anchor refs -> replicate
    refs_l = jnp.asarray(pfs[0].refs_l)
    refs_c = jnp.asarray(pfs[0].refs_c)
    for pf in pfs[1:]:
        assert (pf.refs_l == pfs[0].refs_l).all(), \
            "B frames disagree on anchor refs"

    mesh = Mesh(np.asarray(devs[:n_devices]), ("frame",))

    def body(canvas, scal, avail, levels, rmeta, mc_fields,
             resid_fields, refs_l, refs_c, bank, qp4, bs_v, bs_h,
             dboff, sao_t, sao_b, sao_o, sao_e):
        canvas = canvas[0].astype(jnp.int32)
        scal = tuple(s[0] for s in scal)
        avail = tuple(a[0] for a in avail)
        levels = tuple(v[0] for v in levels)
        rmeta = tuple(m[0] for m in rmeta)
        resids = _residuals(levels, rmeta, bd, bank)
        groups = tuple(k + (f[0],) for k, f in zip(mc_shapes, mc_fields))
        canvas = mc_phase(canvas, refs_l, refs_c, groups, bd)
        canvas = resid_phase(canvas, tuple(g[0] for g in resid_fields),
                             resids, bd)
        out = reconstruct_wavefront(canvas, scal, avail, resids, bd,
                                    n_chunks)
        y, cb, cr = [jax.lax.dynamic_slice(out, (oy, ox), (h, w))
                     for oy, ox, h, w in regions]
        if do_deblock:
            d = dboff[0]
            y, cb, cr = deblock_jax(y, cb, cr, qp4[0], bs_v[0], bs_h[0],
                                    d[0], d[1], d[2], d[3], bd=bd,
                                    sub_w=sps.sub_w, sub_h=sps.sub_h)
        if do_sao:
            planes = []
            for i, p in enumerate((y, cb, cr)):
                lg = sps.log2_ctb_size - (0 if i == 0
                                          else sps.sub_w.bit_length() - 1)
                planes.append(sao_plane_jax(
                    p, sao_t[0][i], sao_b[0][i], sao_o[0][i],
                    sao_e[0][i], lg, bd))
            y, cb, cr = planes
        return y[None], cb[None], cr[None]

    f = P("frame")
    in_specs = (f, (f,) * 4, (f,) * 4, (f,) * 4, (f,) * 4,
                (f,) * len(mc_shapes), (f,) * 4,
                P(), P(), (P(),) * 4,
                f, f, f, f,
                f, f, f, f)
    out_specs = (f, f, f)
    kw = dict(mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    fn = shard_map(body, **kw)

    args = (arrays["canvas"], tuple(arrays["scal"]),
            tuple(arrays["avail"]), tuple(arrays["levels"]),
            tuple(arrays["rmeta"]), tuple(arrays["mc_fields"]),
            tuple(arrays["resid_fields"]), refs_l, refs_c,
            tuple(jnp.asarray(b) for b in spec["scale_bank"]),
            np.stack(qp4s), np.stack(bss_v), np.stack(bss_h),
            np.asarray(dboffs, np.int32),
            np.stack([s[0] for s in saos]),
            np.stack([s[1] for s in saos]),
            np.stack([s[2] for s in saos]),
            np.stack([s[3] for s in saos]))
    ys, cbs, crs = jax.jit(fn)(*args)
    got = [(np.asarray(ys[k]), np.asarray(cbs[k]), np.asarray(crs[k]))
           for k in range(n_b)]
    want = [[np.asarray(p) for p in by_poc[k + 1].planes]
            for k in range(n_b)]
    return got, want
