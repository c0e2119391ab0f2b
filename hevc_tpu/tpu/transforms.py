"""Batched dequant + inverse transform on device (JAX/XLA), bit-exact.

Stage-B kernel family replacing the reference's per-TU scalar IDCT path
(reference: libavcodec/hevcdsp_template.c:62-308, hevc_cabac.c:1695
ff_hevc_hls_transform) with a batched design: all TUs of one size
class across a frame are batched into [N, S, S] tensors and transformed
with two int32 matmul passes (exact integer arithmetic; no float
dot_general, so no TF32 rounding on the GPU).

Exact integer semantics (H.265 8.6.3/8.6.4) without int64:
- dequant splits the 19-bit scale into (hi << shift) + lo so every
  partial product fits int32:  (lv*scale + R) >> sh
  == lv*hi + ((lv*lo + R) >> sh)   (exact for signed lv).
- the transform matmuls keep |acc| <= 32*32767*90 < 2^31 in int32.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import reference as R

LEVEL_SCALE = tuple(int(v) for v in R.LEVEL_SCALE)


# host-side constants; jnp converts at trace time (never cache tracers)
_MAT = {n: np.asarray(R.dct_matrix(n), np.int32) for n in (4, 8, 16, 32)}
_MAT["dst4"] = np.asarray(R.DST4, np.int32)


def mat(key):
    return jnp.asarray(_MAT[key], jnp.int32)


@partial(jax.jit, static_argnames=("log2_size", "bit_depth"))
def dequant_batch(levels: jax.Array, qp: jax.Array, log2_size: int,
                  bit_depth: int, scale_m=None) -> jax.Array:
    """Scaling process (8.6.3).

    levels: int32 [N, S, S]; qp: int32 [N] (already includes QpBdOffset);
    scale_m: optional int32 [N, S, S] scaling matrices (None = flat 16).
    Returns int32 [N, S, S] clipped to 16 bit.

    Exact in int32: the reference's 64-bit product
    (level * (ls << qp/6) * m + add) >> sh is refactored to
    (level * ls * m + add') >> (sh - qp/6); |level*ls*m| < 2^30 since
    ls <= 45 and m <= 255, and a non-positive effective shift becomes a
    left shift whose operand is pre-clipped (anything >= 2^15 saturates
    to the same +/-32767 either way)."""
    sh = bit_depth + log2_size - 5
    ls = jnp.asarray(LEVEL_SCALE, jnp.int32)[qp % 6]
    if scale_m is None:
        lsm = (ls * 16)[:, None, None]
    else:
        lsm = ls[:, None, None] * scale_m
    num = levels * lsm
    sh2 = (sh - qp // 6)[:, None, None]
    sh2p = jnp.maximum(sh2, 1)
    d_pos = (num + (1 << (sh2p - 1))) >> sh2p
    d_neg = jnp.clip(num, -(1 << 24), 1 << 24) << jnp.maximum(-sh2, 0)
    d = jnp.where(sh2 > 0, d_pos, d_neg)
    return jnp.clip(d, -32768, 32767)


@partial(jax.jit, static_argnames=("bit_depth",))
def inverse_transform_batch(d: jax.Array, bit_depth: int,
                            dst_mask: jax.Array) -> jax.Array:
    """Inverse 2-D transform (8.6.4) for a batch of same-size blocks.

    d: int32 [N, S, S]; dst_mask: bool [N] — True selects DST-VII
    (only meaningful for S == 4).  Returns int32 residual [N, S, S]."""
    n = d.shape[-1]
    T = mat(n)
    if n == 4:
        Td = mat("dst4")
        T_eff = jnp.where(dst_mask[:, None, None], Td[None], T[None])
    else:
        T_eff = jnp.broadcast_to(T[None], (d.shape[0], n, n))
    # stage 1 (columns): e = clip16((T^T @ d + 64) >> 7)
    e = jnp.matmul(T_eff.transpose(0, 2, 1), d,
                   preferred_element_type=jnp.int32)
    e = jnp.clip((e + 64) >> 7, -32768, 32767)
    sh2 = 20 - bit_depth
    r = jnp.matmul(e, T_eff, preferred_element_type=jnp.int32)
    r = jnp.clip((r + (1 << (sh2 - 1))) >> sh2, -32768, 32767)
    return r


@partial(jax.jit, static_argnames=("bit_depth",))
def transform_skip_batch(d: jax.Array, bit_depth: int) -> jax.Array:
    # size-dependent shift 15 - bd - log2 (reference:
    # hevcdsp_template.c:109; rext skip blocks reach 32x32)
    log2 = int(d.shape[-1]).bit_length() - 1
    sh = 15 - bit_depth - log2
    if sh > 0:
        r = (d + (1 << (sh - 1))) >> sh
    else:
        r = d << -sh
    return jnp.clip(r, -32768, 32767)


@partial(jax.jit, static_argnames=("log2_size", "bit_depth"))
def residual_batch(levels: jax.Array, qp: jax.Array, dst_mask: jax.Array,
                   ts_mask: jax.Array, log2_size: int,
                   bit_depth: int, scale_m=None) -> jax.Array:
    """Full levels → spatial residual for one TU size class.

    ts_mask selects the transform-skip path per block."""
    d = dequant_batch(levels, qp, log2_size, bit_depth, scale_m)
    it = inverse_transform_batch(d, bit_depth, dst_mask)
    ts = transform_skip_batch(d, bit_depth)
    return jnp.where(ts_mask[:, None, None], ts, it)
