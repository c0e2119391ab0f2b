"""Frame-parallel GOP driver: anchors + mutually-independent B frames.

Encodes I0 and P(n+1) anchors, then n non-reference B pictures (POC
1..n) that each reference ONLY the two anchors — so all n B frames are
decodable CONCURRENTLY once the anchors exist.  This is the
hierarchical-B shape that gives real frame-level parallelism: the
reference's frame threads exploit exactly this independence, gating
each frame's MC on its producers' progress (pthread_frame.c:395/484/
570/592); on a device mesh the n B frames map onto a ("frame",) axis with
the anchor reconstructions replicated (see __graft_entry__.py
dryrun_multichip frame axis and tests/test_pgop.py).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..bitstream import nal as nalmod
from ..bitstream.ps import ShortTermRPS
from .core import EncoderConfig, IntraEncoder


class ParallelBGopEncoder:
    """Encode n_frames = n_b + 2 pictures as I0, P(n_b+1), B1..Bn_b.

    Decode order: I, P, B1..Bn (every B is TRAIL_N, temporal id 1).
    `recons` accumulates (poc, planes) in decode order."""

    def __init__(self, cfg: EncoderConfig, n_b: int):
        assert cfg.gop == "ra", "drive with gop='ra' scheduling"
        self.enc = IntraEncoder(cfg)
        self.n_b = n_b
        anchor = n_b + 1
        # RPS 0: the P anchor references I0; RPS k: B_k references both
        # anchors (I0 before, P after)
        rps = [ShortTermRPS(delta_poc_s0=[-anchor], used_s0=[1])]
        for k in range(1, n_b + 1):
            rps.append(ShortTermRPS(delta_poc_s0=[-k], used_s0=[1],
                                    delta_poc_s1=[anchor - k],
                                    used_s1=[1]))
        sps = self.enc.sps
        sps.st_rps = rps
        for ps in (sps, self.enc.vps):
            ps.max_sub_layers = 2
            ps.num_reorder_pics = [0, n_b]
            ps.max_dec_pic_buffering = [2, n_b + 2]
            ps.max_latency_increase = [0, 0]
        self.recons: List[Tuple[int, list]] = []

    def _encode(self, planes, poc, ftype, rps_idx, l0, l1, tid=0,
                ntype=None) -> bytes:
        enc = self.enc
        enc._sched = (poc, ftype, rps_idx,
                      [poc + d for d in l0], [poc + d for d in l1],
                      tid, ntype)
        try:
            au = enc.encode_frame(planes)
        finally:
            enc._sched = None
        self.recons.append((poc, [p.copy() for p in enc.recon_planes]))
        # B pictures are sub-layer non-reference (TRAIL_N): keep only
        # the anchors in the encoder DPB so its sliding window never
        # evicts I0 regardless of n_b
        anchor = self.n_b + 1
        if poc not in (0, anchor):
            enc.dpb = [e for e in enc.dpb if e[0] in (0, anchor)]
        return au

    def encode(self, frames: List[list]) -> bytes:
        """frames: display-order pictures, len == n_b + 2."""
        n_b = self.n_b
        assert len(frames) == n_b + 2
        anchor = n_b + 1
        out = self._encode(frames[0], 0, "I", 0, (), ())
        out += self._encode(frames[anchor], anchor, "P", 0,
                            (-anchor,), ())
        for k in range(1, n_b + 1):
            out += self._encode(frames[k], k, "B", k, (-k,),
                                (anchor - k,), tid=1,
                                ntype=nalmod.NAL_TRAIL_N)
        return out
