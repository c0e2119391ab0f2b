"""Production MC and inter-residual phases vs the NumPy reference.

`_mc_tile_phase` (tpu/pipeline.py) is the stage-B MC of the decode path:
per-PU rows grouped by (is_chroma, bi, wp, kind, w, h), kind being the
reference's pel/h/v/hv kernel grid (hevcdsp.h:98).  Each case builds
random non-overlapping rows for one group, with bucket-padding rows that
must be dropped, and checks every block against the spec-derived
interpolation and weighting of hevc_tpu/ops/mc.py.  `resid_phase`
(tpu/mc.py) adds the inter residuals, checked per TU size class.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hevc_tpu.ops import mc as M
from hevc_tpu.tpu.mc import resid_phase
from hevc_tpu.tpu.pack import DUMP, PAD_REF
from hevc_tpu.tpu.pipeline import DUMP16, _mc_tile_phase

RH, RW = 96, 160          # reference planes (before PAD_REF padding)
CH, CW = 160, 260         # canvas
N_REF = 2

# (is_chroma, bi, w, h, bd, wp): the block shapes, bit depths and
# weighting modes of the production groups
CASES = [
    (False, False, 16, 8, 8, False),
    (False, True, 8, 16, 8, False),
    (False, False, 4, 4, 10, False),
    (True, False, 8, 4, 8, False),
    (True, True, 4, 8, 10, False),
    (False, True, 32, 24, 8, False),
    (False, False, 16, 8, 8, True),
    (False, True, 8, 8, 8, True),
    (True, False, 8, 4, 10, True),
    (True, True, 4, 8, 8, True),
]
# uni groups take every kind; bi groups are full-pel (0) or generic (3),
# as pack_frame_pipeline assigns them
PARAMS = [c + (k,) for c in CASES for k in ((0, 3) if c[1] else
                                             (0, 1, 2, 3))]


def _fracs(rng, kind, nfrac):
    if kind == 0:
        return 0, 0
    if kind == 1:
        return int(rng.integers(1, nfrac)), 0
    if kind == 2:
        return 0, int(rng.integers(1, nfrac))
    return int(rng.integers(0, nfrac)), int(rng.integers(0, nfrac))


def _rows(rng, is_ch, bi, wp, kind, w, h, bd, n_blk=7, n_pad=2):
    """Production 17-column rows (sel, by, bx, fx, fy, sel1, by1, bx1,
    fx1, fy1, cy, cx, w0, o0, w1, o1, log2wd); by/bx are the origins of
    the full (h+ntaps-1) x (w+ntaps-1) window in the padded reference."""
    ntaps = 4 if is_ch else 8
    nfrac = 8 if is_ch else 4
    cols = CW // (w + 8)
    rows = np.zeros((n_blk + n_pad, 17), np.int32)
    for i in range(n_blk):
        r = rows[i]
        for p in range(2 if bi else 1):
            fx, fy = _fracs(rng, kind, nfrac)
            # windows inside the picture, some reaching into the
            # replicated border band
            r[5 * p:5 * p + 5] = (
                rng.integers(0, N_REF),
                rng.integers(PAD_REF - 12, PAD_REF + RH - h - ntaps + 12),
                rng.integers(PAD_REF - 12, PAD_REF + RW - w - ntaps + 12),
                fx, fy)
        r[10] = 8 + (i // cols) * (h + 8)
        r[11] = 8 + (i % cols) * (w + 8)
        assert r[10] + h < CH and r[11] + w < CW
        if wp:
            r[12:17] = (rng.integers(50, 80),
                        int(rng.integers(-8, 8)) << (bd - 8),
                        rng.integers(50, 80),
                        int(rng.integers(-8, 8)) << (bd - 8),
                        6 + 14 - bd)
    rows[n_blk:, 10:12] = DUMP16        # bucket padding: dropped
    return rows


def _reference(canvas, planes, rows, is_ch, bi, wp, w, h, bd):
    pre = 1 if is_ch else 3
    out = canvas.copy()
    for r in rows:
        if r[10] == DUMP16:
            continue
        preds = []
        for p in range(2 if bi else 1):
            sel, by, bx, fx, fy = (int(v) for v in r[5 * p:5 * p + 5])
            yi, xi = by + pre - PAD_REF, bx + pre - PAD_REF
            if is_ch:
                preds.append(M.mc_chroma(planes[sel], xi, yi, w, h, fx, fy,
                                         bd))
            else:
                preds.append(M.mc_luma(planes[sel], xi, yi, w, h, fx, fy,
                                       bd))
        w0, o0, w1, o1, lwd = (int(v) for v in r[12:17])
        if bi and wp:
            blk = M.weighted_bi_explicit(preds[0], preds[1], w0, o0, w1, o1,
                                         lwd, bd)
        elif bi:
            blk = M.weighted_bi(preds[0], preds[1], bd)
        elif wp:
            blk = M.weighted_uni_explicit(preds[0], w0, o0, lwd, bd)
        else:
            blk = M.weighted_uni(preds[0], bd)
        out[r[10]:r[10] + h, r[11]:r[11] + w] = blk
    return out


@pytest.mark.parametrize("is_ch,bi,w,h,bd,wp,kind", PARAMS)
def test_mc_tile_phase_matches_reference(is_ch, bi, w, h, bd, wp, kind):
    rng = np.random.default_rng(
        [int(is_ch), int(bi), w, h, bd, int(wp), kind])
    planes = rng.integers(0, 1 << bd, (N_REF, RH, RW)).astype(np.int32)
    refs = np.stack([np.pad(p, PAD_REF, mode="edge") for p in planes])
    rows = _rows(rng, is_ch, bi, wp, kind, w, h, bd)
    canvas = rng.integers(0, 1 << bd, (CH, CW)).astype(np.int32)

    @jax.jit
    def run(canvas, refs, rows):
        return _mc_tile_phase(canvas, refs, refs,
                              ((is_ch, bi, wp, kind, w, h, rows),), bd)

    got = np.asarray(run(jnp.asarray(canvas), jnp.asarray(refs),
                         jnp.asarray(rows)))
    want = _reference(canvas, planes, rows, is_ch, bi, wp, w, h, bd)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cls,bd", [(0, 8), (1, 8), (2, 10), (3, 8)])
def test_resid_phase_matches_reference(cls, bd):
    rng = np.random.default_rng(cls * 17 + bd)
    s = 4 << cls
    n_blk, n_pool = 6, 8
    pool = rng.integers(-200, 200, (n_pool, s, s)).astype(np.int32)
    pool[0] = 0  # slot 0 = zeros by convention
    canvas = rng.integers(0, 1 << bd, (CH, CW)).astype(np.int32)
    cols = CW // (s + 8)
    rows = [(8 + (i // cols) * (s + 8), 8 + (i % cols) * (s + 8),
             int(rng.integers(0, n_pool))) for i in range(n_blk)]
    rows += [(DUMP, DUMP, 0)] * 2       # power-of-two padding: dropped
    fields = [jnp.zeros((0, 3), jnp.int32) for _ in range(4)]
    fields[cls] = jnp.asarray(np.asarray(rows, np.int32))
    resids = [jnp.zeros((1, 4 << c, 4 << c), jnp.int32) for c in range(4)]
    resids[cls] = jnp.asarray(pool)

    got = np.asarray(jax.jit(resid_phase, static_argnums=3)(
        jnp.asarray(canvas), tuple(fields), tuple(resids), bd))
    want = canvas.copy()
    for cy, cx, slot in rows[:n_blk]:
        want[cy:cy + s, cx:cx + s] = np.clip(
            want[cy:cy + s, cx:cx + s] + pool[slot], 0, (1 << bd) - 1)
    np.testing.assert_array_equal(got, want)
