"""Device-side intra prediction + reconstruction (JAX/XLA), bit-exact.

Stage-B replacement for the reference's hevcpred_template.c (intra_pred
:30, planar :360, dc :389, angular :420) — re-designed for the accelerator: the
frame's predicted blocks are replayed as a `lax.scan` over a packed
record stream against a single padded canvas holding all three planes,
with a `lax.switch` over transform-size classes.  All arithmetic is
int32; reference substitution uses an associative prefix-max instead of
the spec's sequential scan (identical result).

The sequential scan is the correctness baseline for the wavefront-
batched schedule (records grouped into dependency levels).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import reference as R

ANGLE_TAB = np.zeros(35, np.int32)
ANGLE_TAB[2:] = np.asarray(R.INTRA_PRED_ANGLE, np.int32)
INVANGLE_TAB = np.zeros(35, np.int32)
INVANGLE_TAB[11:26] = np.asarray(R.INV_ANGLE, np.int32)


def _substitute(vals, avail, bd):
    """8.4.4.2.2 reference substitution, vectorized.

    vals/avail are in substitution scan order (left bottom→top, corner,
    top left→right)."""
    L = vals.shape[0]
    idx = jnp.where(avail, jax.lax.broadcasted_iota(jnp.int32, (L, 1), 0)[:, 0],
                    -1)
    last = jax.lax.associative_scan(jnp.maximum, idx)
    first_avail = jnp.argmax(avail)  # first True (0 if none)
    src = jnp.where(last >= 0, last, first_avail)
    out = vals[src]
    return jnp.where(avail.any(), out, 1 << (bd - 1))


def _filter_refs(left, top, corner, n, bd, strong):
    """8.4.4.2.3 [1 2 1] smoothing; bilinear strong smoothing for 32."""
    n2 = 2 * n
    fl = jnp.empty_like(left)
    ft = jnp.empty_like(top)
    lm1 = jnp.concatenate([jnp.array([corner], jnp.int32), left[:-1]])
    lp1 = jnp.concatenate([left[1:], left[-1:]])
    f = (lm1 + 2 * left + lp1 + 2) >> 2
    fl = jnp.where(jax.lax.broadcasted_iota(jnp.int32, (n2, 1), 0)[:, 0]
                   < n2 - 1, f, left)
    tm1 = jnp.concatenate([jnp.array([corner], jnp.int32), top[:-1]])
    tp1 = jnp.concatenate([top[1:], top[-1:]])
    f = (tm1 + 2 * top + tp1 + 2) >> 2
    ft = jnp.where(jax.lax.broadcasted_iota(jnp.int32, (n2, 1), 0)[:, 0]
                   < n2 - 1, f, top)
    fc = (left[0] + 2 * corner + top[0] + 2) >> 2
    if n == 32:
        i = jax.lax.broadcasted_iota(jnp.int32, (n2, 1), 0)[:, 0]
        bl = ((63 - (i + 1)) * corner + (i + 1) * left[63] + 32) >> 6
        bt = ((63 - (i + 1)) * corner + (i + 1) * top[63] + 32) >> 6
        cond = ((jnp.abs(corner + top[n2 - 1] - 2 * top[n - 1])
                 < (1 << (bd - 5)))
                & (jnp.abs(corner + left[n2 - 1] - 2 * left[n - 1])
                   < (1 << (bd - 5))) & strong)
        last_mask = jax.lax.broadcasted_iota(jnp.int32, (n2, 1), 0)[:, 0] \
            < n2 - 1
        fl = jnp.where(cond, jnp.where(last_mask, bl, left), fl)
        ft = jnp.where(cond, jnp.where(last_mask, bt, top), ft)
        fc = jnp.where(cond, corner, fc)
    return fl, ft, fc


def predict_block(left, top, corner, n, mode, bd, edge_tweak):
    """Compute the nxn prediction for any mode (compute-all, select)."""
    n2 = 2 * n
    log2n = n.bit_length() - 1
    maxv = (1 << bd) - 1
    ii = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)  # row index y
    jj = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)  # col index x
    # ---- planar ----
    planar = ((n - 1 - jj) * left[ii] + (jj + 1) * top[n]
              + (n - 1 - ii) * top[jj] + (ii + 1) * left[n] + n) >> (log2n + 1)
    # ---- DC ----
    dc = (jnp.sum(top[:n]) + jnp.sum(left[:n]) + n) >> (log2n + 1)
    dcp = jnp.full((n, n), dc, jnp.int32)
    if n < 32:
        corner_v = (left[0] + 2 * dc + top[0] + 2) >> 2
        row0 = (top[jj[0]] + 3 * dc + 2) >> 2
        col0 = (left[ii[:, 0]] + 3 * dc + 2) >> 2
        dcf = dcp.at[0, :].set(row0).at[:, 0].set(col0).at[0, 0].set(corner_v)
        dcp = jnp.where(edge_tweak, dcf, dcp)
    # ---- angular ----
    angle = jnp.asarray(ANGLE_TAB)[mode]
    inv = jnp.asarray(INVANGLE_TAB)[mode]
    vertical = mode >= 18
    main = jnp.where(vertical, top, left)
    side = jnp.where(vertical, left, top)
    # extended reference: ref[off + k], k in [-n .. 2n+1]
    off = n
    ref = jnp.zeros(3 * n + 3, jnp.int32)
    ref = ref.at[off].set(corner)
    ref = ref.at[off + 1:off + 1 + n2].set(main)
    ref = ref.at[off + 1 + n2].set(main[n2 - 1])
    # negative extension (values only read when valid)
    k = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0] + 1  # 1..n
    sidx = ((-k * inv + 128) >> 8) - 1
    ext = jnp.where(sidx < 0, corner, side[jnp.clip(sidx, 0, n2 - 1)])
    ref = ref.at[off - k].set(ext)
    coor = jnp.where(vertical, ii, jj) + 1
    other = jnp.where(vertical, jj, ii)
    iidx = (coor * angle) >> 5
    ifact = (coor * angle) & 31
    base = other + iidx + 1
    a = ref[off + base]
    b = ref[off + base + 1]
    ang = ((32 - ifact) * a + ifact * b + 16) >> 5
    # pure horizontal/vertical edge gradient tweak (modes 10 / 26)
    v26 = jnp.clip(top[0] + ((left[ii[:, 0]] - corner) >> 1), 0, maxv)
    h10 = jnp.clip(left[0] + ((top[jj[0]] - corner) >> 1), 0, maxv)
    ang = jnp.where((mode == 26) & edge_tweak,
                    ang.at[:, 0].set(v26), ang)
    ang = jnp.where((mode == 10) & edge_tweak,
                    ang.at[0, :].set(h10), ang)
    return jnp.where(mode == R.INTRA_PLANAR, planar,
                     jnp.where(mode == R.INTRA_DC, dcp, ang))


def _recon_one(canvas, cy, cx, mode, av_l, av_t, av_c, filt, strong,
               edge_tweak, res, n, bd):
    """Predict + add one block; returns the nxn reconstructed tile."""
    n2 = 2 * n
    maxv = (1 << bd) - 1
    left = jax.lax.dynamic_slice(canvas, (cy, cx - 1), (n2, 1))[:, 0]
    top = jax.lax.dynamic_slice(canvas, (cy - 1, cx), (1, n2))[0]
    corner = jax.lax.dynamic_slice(canvas, (cy - 1, cx - 1), (1, 1))[0, 0]
    vals = jnp.concatenate([left[::-1], corner[None], top])
    avs = jnp.concatenate([av_l[:n2][::-1], av_c[None], av_t[:n2]])
    sub = _substitute(vals, avs, bd)
    left_s = sub[:n2][::-1]
    corner_s = sub[n2]
    top_s = sub[n2 + 1:]
    fl, ft, fc = _filter_refs(left_s, top_s, corner_s, n, bd, strong)
    left_u = jnp.where(filt, fl, left_s)
    top_u = jnp.where(filt, ft, top_s)
    corner_u = jnp.where(filt, fc, corner_s)
    pred = predict_block(left_u, top_u, corner_u, n, mode, bd, edge_tweak)
    return jnp.clip(pred + res, 0, maxv)


# scal field indices (see pack.pack_frame)
F_CY, F_CX, F_MODE, F_RESID, F_FILT, F_STRONG, F_EDGE, F_AVC = range(8)


def make_chunk_body(bd: int, scal: tuple, avail: tuple, resids: tuple,
                    sizes=(4, 8, 16, 32)):
    """Scan body processing one wavefront chunk.

    scal[c]: int32 [n_chunks, B_c, 8] per-record fields; avail[c]: bool
    [n_chunks, B_c, 128] (left||top masks); resids[c]: [Nc, s, s]
    residual pool (slot 0 = zeros).  Records within a chunk are
    conflict-free by construction, so each class batch is vmapped and
    written with one scatter (padding lanes target out-of-bounds and are
    dropped)."""

    def body(canvas, chunk_idx):
        all_rows, all_cols, all_vals = [], [], []
        for c, n in enumerate(sizes):
            if scal[c].shape[1] == 0:
                continue  # class unused in this frame (packed empty)
            s = scal[c][chunk_idx]
            av = avail[c][chunk_idx]
            cy, cx = s[:, F_CY], s[:, F_CX]
            res = resids[c][s[:, F_RESID]]
            blk = jax.vmap(
                _recon_one,
                in_axes=(None, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, None, None),
            )(canvas, cy, cx, s[:, F_MODE], av[:, :64], av[:, 64:],
              s[:, F_AVC] != 0, s[:, F_FILT] != 0, s[:, F_STRONG] != 0,
              s[:, F_EDGE] != 0, res, n, bd)
            ii = jax.lax.broadcasted_iota(jnp.int32, (1, n, n), 1)
            jj = jax.lax.broadcasted_iota(jnp.int32, (1, n, n), 2)
            all_rows.append((cy[:, None, None] + ii).reshape(-1))
            all_cols.append((cx[:, None, None] + jj).reshape(-1))
            all_vals.append(blk.reshape(-1))
        # one fused scatter per chunk (disjoint by construction; padding
        # lanes target out-of-bounds coordinates and are dropped)
        rows = jnp.concatenate(all_rows)
        cols = jnp.concatenate(all_cols)
        vals = jnp.concatenate(all_vals)
        canvas = canvas.at[rows, cols].set(vals, mode="drop")
        return canvas, None

    return body


@partial(jax.jit, static_argnames=("bd", "n_chunks"))
def reconstruct_wavefront(canvas, scal, avail, resids, bd, n_chunks):
    """Replay all wavefront chunks sequentially; batches inside each
    chunk run data-parallel."""
    if all(s.shape[1] == 0 for s in scal):
        return canvas  # no intra records (pure-inter frame)
    body = make_chunk_body(bd, scal, avail, resids)
    canvas, _ = jax.lax.scan(body, canvas,
                             jnp.arange(n_chunks, dtype=jnp.int32))
    return canvas
