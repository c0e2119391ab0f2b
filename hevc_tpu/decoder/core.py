"""HEVC decoder driver: NAL dispatch, slice decode, CTU/CU/TU recursion.

Capability parity with the reference's hevcdec.c decode driver
(hevc_decode_frame :4174, decode_nal_units :3913, hls_coding_quadtree
:2711, hls_coding_unit :2550, hls_transform_tree :1549, hls_transform_unit
:1322) — re-derived from H.265 clauses 7.3.8 (syntax), 8.4 (intra), 8.6
(transform).  This is the scalar/NumPy decode path; it doubles as the
oracle for the JAX/Pallas reconstruction stage.

Current scope: intra slices (I), 4:2:0/4:4:4, 8/10-bit, transform skip;
inter and loop filters land in subsequent milestones.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .. import log as ohlog
from ..bitstream import nal as nalmod
from ..bitstream.bits import BitReader
from ..bitstream.ps import PPS, SPS, VPS
from ..bitstream.sei import (SEI_TYPE_DECODED_PICTURE_HASH, SIDE_DATA_PARSERS,
                             DecodedPictureHash, parse_sei_rbsp, picture_md5)
from ..bitstream.slice import SLICE_B, SLICE_I, SLICE_P, SliceHeader
from ..cabac.ctx import ContextModel
from ..cabac.engine import CabacDecoder
from ..coding.picture import (CHROMA_422_MODE, PictureState,
                              chroma_mode_from_idx, crop_conf_win,
                              mpm_list)
from ..coding.residual import decode_residual

_NATIVE_RESIDUAL = None


def _native_residual():
    """Resolve the C++ residual-coding front-end once (None if unavailable).

    The native kernel (hevc_tpu/native/residual.cpp) is the analogue of the
    reference's C entropy hot loop (reference: libavcodec/hevc_cabac.c:2408);
    it is bit-exact with coding.residual.decode_residual (tests/test_native.py).
    """
    global _NATIVE_RESIDUAL
    if _NATIVE_RESIDUAL is None:
        from .. import native
        _NATIVE_RESIDUAL = native.decode_residual if native.available() \
            else False
    return _NATIVE_RESIDUAL or None


_NATIVE_SLICE = None


def _native_slice():
    """Resolve the full-native stage-A slice decoder once (or None).

    Set HEVC_TPU_NATIVE=0 (all native off) or HEVC_TPU_NATIVE_SLICE=0
    (keep the residual kernel, Python syntax layer) to disable."""
    global _NATIVE_SLICE
    if _NATIVE_SLICE is None:
        import os

        from .. import native
        on = os.environ.get("HEVC_TPU_NATIVE_SLICE", "1") != "0"
        _NATIVE_SLICE = native.decode_slice_native \
            if (on and native.available()) else False
    return _NATIVE_SLICE or None
from ..coding.scans import scan_idx_for_intra
from ..ops import reference as R


@dataclass
class DecodedFrame:
    planes: List[np.ndarray]
    poc: int
    sei_hash: Optional[DecodedPictureHash] = None
    layer: int = 0
    # SEI-derived side data: key -> parsed message (bitstream/sei.py
    # SIDE_DATA_PARSERS); the analogue of AVFrame side data populated by
    # the reference's set_side_data (hevcdec.c:3456-3573)
    side_data: Optional[Dict[str, object]] = None
    bit_depth: int = 8
    chroma_format: int = 1  # chroma_format_idc (0/1/2/3)
    # presentation timestamp of the AU this picture was decoded from
    # (propagated with the picture, like the reference's AVFrame->pts)
    pts: int = 0
    # md5_ok is lazy on the device pipeline: the check fetches the
    # decoded planes, so deferring it to first access lets the
    # device->host copies overlap later frames' decode
    _md5_ok: Optional[bool] = None
    _md5_eval: Optional[object] = None

    @property
    def md5_ok(self):
        if self._md5_eval is not None:
            self._md5_ok = self._md5_eval()
            self._md5_eval = None
        return self._md5_ok

    @md5_ok.setter
    def md5_ok(self, v):
        self._md5_ok = v
        self._md5_eval = None


class _CuState:
    __slots__ = ("pred_intra", "intra_split", "inter_split", "chroma_mode",
                 "chroma_modes",
                 "tq_bypass", "max_trafo_depth", "x0", "y0", "log2_size",
                 "chroma_dm")


@dataclass
class BlockRecord:
    """One block operation in decode order (stage A → stage B interface).

    kind:
      "intra" — predict from neighbours + add residual (wavefront phase)
      "mc"    — motion-compensated prediction write (parallel phase 1)
      "resid" — add residual onto existing prediction (parallel phase 2)
    """
    plane: int
    x: int          # component coords
    y: int
    size: int       # width (== height for intra/resid)
    mode: int       # intra prediction mode
    qp: int         # component QP (incl. bd offset) for dequant
    levels: Optional[np.ndarray]  # None when cbf == 0
    dst: bool = False
    ts: bool = False
    tqb: bool = False
    kind: str = "intra"
    h: int = 0      # height for rectangular mc blocks (0 = square)
    mv: tuple = (0, 0)
    ref_idx: int = 0
    lx: int = 0          # list of mv/ref_idx for uni mc records
    bi: bool = False     # bi-predicted mc record
    mv1: tuple = (0, 0)
    ref_idx1: int = 0
    mtx: int = -1        # scaling-list matrix id (-1 = flat 16)
    # explicit weighted prediction (w0, o0, w1, o1, log2wd) for this
    # record's plane; None = default weighting (7.4.7.3 pred_weight_table)
    wp: Optional[tuple] = None
    # range-extension residual modifiers
    rdpcm: int = 0       # 0 none / 1 horizontal / 2 vertical accumulate
    rot: bool = False    # 4x4 transform-skip 180° coefficient rotation
    ccp: int = 0         # cross-component res_scale_val (0 = off)
    ccp_ref: Optional["BlockRecord"] = None  # the TU's luma record


class SliceDecoder:
    """Decodes one slice segment's CTU payload."""

    def __init__(self, pic: PictureState, sps: SPS, pps: PPS,
                 sh: SliceHeader, d: CabacDecoder, cm: ContextModel,
                 slice_idx: int, plan: Optional[list] = None,
                 ref_list=None, cur_poc: int = 0,
                 rbsp: Optional[bytes] = None,
                 segment_starts: Optional[list] = None,
                 ref_list_l1=None, tmvp=None,
                 ref_lt0=None, ref_lt1=None):
        self.pic = pic
        self.sps = sps
        self.pps = pps
        self.sh = sh
        self.d = d
        self.cm = cm
        self.slice_idx = slice_idx
        self.qp_y = pps.init_qp + sh.qp_delta
        # per-QG luma QP state (8.6.1; reference hevc_filter.c:94-147)
        from ..coding.qp import QpState
        self.qpst = QpState(self.qp_y)
        self.plan = plan  # list to record BlockRecords into (stage-A mode)
        self.ref_list = ref_list or []  # L0: [(poc, [int32 planes]), ...]
        self.ref_list_l1 = ref_list_l1 or []
        self.cur_poc = cur_poc
        self.rbsp = rbsp
        self.segment_starts = segment_starts or []
        self.tmvp = tmvp
        # per-ref-idx long-term flags (SHVC inter-layer refs are LT)
        self.ref_lt0 = ref_lt0 or [False] * len(self.ref_list)
        self.ref_lt1 = ref_lt1 or [False] * len(self.ref_list_l1)
        # active scaling lists: PPS overrides SPS; None = flat 16
        # (reference: hevc_cabac.c:1488-1494 derive_quant_parameters)
        self.scaling = None
        if sps.scaling_list_enabled:
            from ..coding.scaling import ScalingListData
            if pps.scaling_list_data_present:
                self.scaling = pps.scaling_list
            else:
                self.scaling = sps.scaling_list or ScalingListData()
        pic.scaling = self.scaling
        # range-extension residual-coding state (stats reset per slice
        # like the context states; reference: hevc_cabac.c:609)
        from ..coding.residual import RextCtx
        self.rext = None
        if (sps.persistent_rice_adaptation or sps.transform_skip_context
                or sps.implicit_rdpcm or sps.explicit_rdpcm):
            self.rext = RextCtx(
                persistent_rice=bool(sps.persistent_rice_adaptation),
                ts_context=bool(sps.transform_skip_context),
                implicit_rdpcm=bool(sps.implicit_rdpcm),
                explicit_rdpcm=bool(sps.explicit_rdpcm))

    def _init_type(self):
        if self.sh.slice_type == SLICE_I:
            return 0
        if self.sh.slice_type == SLICE_P:
            return 2 if self.sh.cabac_init_flag else 1
        return 1 if self.sh.cabac_init_flag else 2

    # ---- CTU loop --------------------------------------------------------
    def decode_ctus(self) -> int:
        """Decode CTUs until end_of_slice; returns last ctb addr (rs).

        Handles WPP (per-row segments with the 2-CTU context handoff,
        reference: hevc_cabac.c:612 ff_hevc_cabac_init / :558
        ff_hevc_save_states) and tiles (per-tile segments, fresh CABAC)."""
        sps, pps = self.sps, self.pps
        wpp = bool(pps.entropy_coding_sync_enabled)
        tiles = bool(pps.tiles_enabled)
        ts = int(pps.ctb_addr_rs_to_ts[self.sh.segment_address])
        n_ctbs = sps.ctb_w * sps.ctb_h
        seg_idx = 0

        def tile_col_start(xc, yc):
            """First CTB column of its tile row (WPP-in-tiles rows are
            tile-relative; reference: hevc_cabac.c:560 ctb_tile_rs)."""
            return xc == 0 or (tiles and int(pps.tile_of_ctb[yc, xc - 1])
                               != int(pps.tile_of_ctb[yc, xc]))

        if not hasattr(self, "wpp_saved"):
            self.wpp_saved = None
        # a dependent segment starting at a tile/WPP-row boundary takes
        # that boundary's context rule instead of plain continuation
        # (the WPP snapshot rides lay.dep_state across segment NALs)
        if self.sh.dependent_slice_segment:
            rs0 = self.sh.segment_address
            xc0, yc0 = rs0 % sps.ctb_w, rs0 // sps.ctb_w
            tile_start = tiles and ts > 0 and (
                int(pps.tile_id_of_ts[ts])
                != int(pps.tile_id_of_ts[ts - 1]))
            if tile_start:
                self.cm = ContextModel(self._init_type(), self.qp_y)
                self.wpp_saved = None
                if self.rext is not None:
                    self.rext.stats = [0, 0, 0, 0]
            elif wpp and tile_col_start(xc0, yc0) \
                    and self.wpp_saved is not None and sps.ctb_w > 1:
                self.cm = ContextModel(self._init_type(), self.qp_y)
                self.cm.load(self.wpp_saved[0])
                if self.rext is not None \
                        and self.wpp_saved[1] is not None:
                    self.rext.stats = list(self.wpp_saved[1])

        while True:
            rs = int(pps.ctb_addr_ts_to_rs[ts])
            xc, yc = rs % sps.ctb_w, rs // sps.ctb_w
            # QP prediction restarts at WPP-row / tile starts
            # (reference: hevcdec.c:2808/:2814 hls_decode_neighbour)
            if wpp:
                if tile_col_start(xc, yc):
                    self.qpst.first_qp_group = True
            if tiles and ts > 0 and (int(pps.tile_id_of_ts[ts])
                                     != int(pps.tile_id_of_ts[ts - 1])):
                self.qpst.first_qp_group = True
            self.pic.set_ctb_slice(xc, yc, self.slice_idx)
            if sps.sao_enabled and (self.sh.sao_luma or self.sh.sao_chroma):
                self._decode_sao(xc, yc)
            x0, y0 = xc << sps.log2_ctb_size, yc << sps.log2_ctb_size
            self.coding_quadtree(x0, y0, sps.log2_ctb_size, 0)
            if wpp and xc > 0 and tile_col_start(xc - 1, yc) \
                    and (not tiles or int(pps.tile_of_ctb[yc, xc - 1])
                         == int(pps.tile_of_ctb[yc, xc])):
                # state after the tile row's 2nd CTB (+ rice stats, this
                # engine's deterministic convention)
                self.wpp_saved = (self.cm.save(),
                                  list(self.rext.stats)
                                  if self.rext is not None else None)
            end = self.d.decode_terminate()
            ts += 1
            if end or ts >= n_ctbs:
                return rs
            # segment boundary? (end_of_subset_one_bit + new CABAC)
            nrs = int(pps.ctb_addr_ts_to_rs[ts])
            tile_boundary = tiles and (int(pps.tile_id_of_ts[ts])
                                       != int(pps.tile_id_of_ts[ts - 1]))
            row_boundary = wpp and not tile_boundary \
                and tile_col_start(nrs % sps.ctb_w, nrs // sps.ctb_w)
            if tile_boundary or row_boundary:
                self.d.decode_terminate()  # end_of_subset_one_bit
                seg_idx += 1
                self.d = CabacDecoder(self.rbsp,
                                      self.segment_starts[seg_idx])
                if tile_boundary:
                    self.cm = ContextModel(self._init_type(), self.qp_y)
                    self.wpp_saved = None  # rows don't cross tile edges
                    if self.rext is not None:
                        self.rext.stats = [0, 0, 0, 0]
                elif self.wpp_saved is not None and sps.ctb_w > 1:
                    self.cm = ContextModel(self._init_type(), self.qp_y)
                    self.cm.load(self.wpp_saved[0])
                    # rice stats ride the WPP snapshot (this engine's
                    # convention — deterministic under the MT fan-out;
                    # the reference leaves them thread-dependent)
                    if self.rext is not None \
                            and self.wpp_saved[1] is not None:
                        self.rext.stats = list(self.wpp_saved[1])
                else:
                    self.cm = ContextModel(self._init_type(), self.qp_y)
                    if self.rext is not None:
                        self.rext.stats = [0, 0, 0, 0]

    def _decode_sao(self, xc: int, yc: int) -> None:
        """sao() syntax (7.3.8.3)."""
        from ..ops.sao import SAO_BAND, SAO_EDGE, SaoParams
        d, cm, sh, pic = self.d, self.cm, self.sh, self.pic
        sps = self.sps
        if not hasattr(pic, "sao_map"):
            pic.sao_map = {}
        merge_left = merge_up = 0
        if xc > 0 and self._sao_mergeable(xc - 1, yc, xc, yc):
            merge_left = d.decode_bin(cm.at("sao_merge_flag", 0))
        if not merge_left and yc > 0 and self._sao_mergeable(xc, yc - 1,
                                                            xc, yc):
            merge_up = d.decode_bin(cm.at("sao_merge_flag", 0))
        if merge_left:
            pic.sao_map[(xc, yc)] = pic.sao_map[(xc - 1, yc)].copy()
            return
        if merge_up:
            pic.sao_map[(xc, yc)] = pic.sao_map[(xc, yc - 1)].copy()
            return
        prm = SaoParams()
        cmax = (1 << (min(sps.bit_depth_luma, 10) - 5)) - 1
        for c_idx in range(3):
            if c_idx == 0 and not sh.sao_luma:
                continue
            if c_idx > 0 and not sh.sao_chroma:
                continue
            if c_idx in (0, 1):
                t = 0
                if d.decode_bin(cm.at("sao_type_idx", 0)):
                    t = SAO_EDGE if d.decode_bypass() else SAO_BAND
                prm.type_idx[c_idx] = t
                if c_idx == 1:
                    prm.type_idx[2] = t
            t = prm.type_idx[c_idx]
            if t == 0:
                continue
            abs_offs = []
            for _ in range(4):
                a = 0
                while a < cmax and d.decode_bypass():
                    a += 1
                abs_offs.append(a)
            if t == SAO_BAND:
                offs = []
                for a in abs_offs:
                    if a and d.decode_bypass():
                        offs.append(-a)
                    else:
                        offs.append(a)
                prm.offsets[c_idx] = offs
                prm.band_position[c_idx] = d.decode_bypass_bits(5)
            else:
                if c_idx == 0:
                    prm.eo_class[0] = d.decode_bypass_bits(2)
                elif c_idx == 1:
                    ec = d.decode_bypass_bits(2)
                    prm.eo_class[1] = prm.eo_class[2] = ec
                prm.offsets[c_idx] = [abs_offs[0], abs_offs[1],
                                      -abs_offs[2], -abs_offs[3]]
        pic.sao_map[(xc, yc)] = prm

    def _sao_mergeable(self, xn, yn, xc, yc) -> bool:
        pic = self.pic
        return (pic.slice_idx[yn, xn] == pic.slice_idx[yc, xc]
                and self.pps.tile_of_ctb[yn, xn]
                == self.pps.tile_of_ctb[yc, xc])

    # ---- quadtree --------------------------------------------------------
    def coding_quadtree(self, x0, y0, log2_size, depth):
        sps, pps = self.sps, self.pps
        size = 1 << log2_size
        w, h = sps.width, sps.height
        if (x0 + size <= w and y0 + size <= h
                and log2_size > sps.log2_min_cb_size):
            ctx = self.pic.ctdepth_gt(x0, y0, depth)
            split = self.d.decode_bin(self.cm.at("split_cu_flag", ctx))
        else:
            split = 1 if log2_size > sps.log2_min_cb_size else 0
        # quantization-group start: re-arm cu_qp_delta (7.3.8.8 note;
        # reference: hevcdec.c:2727-2730)
        if pps.cu_qp_delta_enabled and log2_size >= \
                sps.log2_ctb_size - pps.diff_cu_qp_delta_depth:
            self.qpst.is_cu_qp_delta_coded = False
            self.qpst.cu_qp_delta_val = 0
        # chroma-QG start: re-arm cu_chroma_qp_offset (the offsets
        # themselves persist; reference: hevcdec.c:1213-1216)
        if self.sh.cu_chroma_qp_offset_enabled and log2_size >= \
                sps.log2_ctb_size - pps.diff_cu_chroma_qp_offset_depth:
            self.qpst.is_cu_chroma_qp_offset_coded = False
        if split:
            half = size >> 1
            for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
                x1, y1 = x0 + dx * half, y0 + dy * half
                if x1 < w and y1 < h:
                    self.coding_quadtree(x1, y1, log2_size - 1, depth + 1)
            if pps.cu_qp_delta_enabled:
                from ..coding.qp import qg_mask
                m = qg_mask(sps, pps)
                if ((x0 + size) & m) == 0 and ((y0 + size) & m) == 0:
                    self.qpst.qp_pred_state = self.qpst.cur_qp
        else:
            self.coding_unit(x0, y0, log2_size, depth)
            if pps.cu_qp_delta_enabled:
                from ..coding.qp import end_of_cu
                end_of_cu(self.qpst, self.pic, sps, pps, x0, y0, log2_size)

    # ---- inter helpers ---------------------------------------------------
    def _decode_merge_idx(self) -> int:
        max_cand = self.sh.max_num_merge_cand()
        if max_cand <= 1:
            return 0
        if not self.d.decode_bin(self.cm.at("merge_idx", 0)):
            return 0
        idx = 1
        while idx < max_cand - 1 and self.d.decode_bypass():
            idx += 1
        return idx

    def _decode_ref_idx(self, num_ref: int) -> int:
        if num_ref <= 1:
            return 0
        if not self.d.decode_bin(self.cm.at("ref_idx_l0", 0)):
            return 0
        if num_ref == 2:
            return 1
        if not self.d.decode_bin(self.cm.at("ref_idx_l0", 1)):
            return 1
        idx = 2
        while idx < num_ref - 1 and self.d.decode_bypass():
            idx += 1
        return idx

    def _decode_eg1(self) -> int:
        sym, count = 0, 1
        while True:
            b = self.d.decode_bypass()
            sym += b << count
            count += 1
            if not b:
                break
        count -= 1
        if count:
            sym += self.d.decode_bypass_bits(count)
        return sym

    def _decode_mvd(self):
        """mvd_coding (7.3.8.9)."""
        d, cm = self.d, self.cm
        g0x = d.decode_bin(cm.at("abs_mvd_greater0_flag", 0))
        g0y = d.decode_bin(cm.at("abs_mvd_greater0_flag", 0))
        g1x = d.decode_bin(cm.at("abs_mvd_greater1_flag", 1)) if g0x else 0
        g1y = d.decode_bin(cm.at("abs_mvd_greater1_flag", 1)) if g0y else 0
        out = []
        for g0, g1 in ((g0x, g1x), (g0y, g1y)):
            if g0:
                a = (self._decode_eg1() + 2) if g1 else 1
                if d.decode_bypass():
                    a = -a
            else:
                a = 0
            out.append(a)
        return out[0], out[1]

    def _inter_pb(self, x_pb, y_pb, n_w, n_h, mi):
        """Apply MC prediction for one PB (uni or bi) and record its
        motion.  mi: coding.mvs.MotionInfo."""
        from ..ops import mc as MC
        pic, sps = self.pic, self.sps
        bd = sps.bit_depth_luma
        bdc = sps.bit_depth_chroma
        xc, yc = x_pb // sps.sub_w, y_pb // sps.sub_h
        wc, hc = n_w // sps.sub_w, n_h // sps.sub_h
        bi = mi.uses_l0 and mi.uses_l1
        if self.plan is not None:
            wt = self.sh.weight_table

            def wp_rec(c):
                """(w0, o0, w1, o1, log2wd) for this record's plane, with
                offsets pre-scaled like the inline path (o << (bd - 8))."""
                if wt is None:
                    return None
                bdx = bd if c == 0 else bdc
                denom = wt.luma_log2_denom if c == 0 \
                    else wt.chroma_log2_denom
                oscale = bdx - 8

                def of(lst_luma, lst_chroma, ridx):
                    if c == 0:
                        _, wgt, offv = lst_luma[ridx]
                    else:
                        _, ws, os_ = lst_chroma[ridx]
                        wgt, offv = ws[c - 1], os_[c - 1]
                    return wgt, offv << oscale

                if bi:
                    w0, o0 = of(wt.luma_l0, wt.chroma_l0, mi.ref0)
                    w1, o1 = of(wt.luma_l1, wt.chroma_l1, mi.ref1)
                elif mi.uses_l0:
                    w0, o0 = of(wt.luma_l0, wt.chroma_l0, mi.ref0)
                    w1 = o1 = 0
                else:
                    w0, o0 = of(wt.luma_l1, wt.chroma_l1, mi.ref1)
                    w1 = o1 = 0
                return (w0, o0, w1, o1, denom + 14 - bdx)

            chroma_cs = (1, 2) if sps.chroma_format_idc else ()
            if bi:
                self.plan.append(BlockRecord(
                    plane=0, x=x_pb, y=y_pb, size=n_w, h=n_h, mode=0, qp=0,
                    levels=None, kind="mc", bi=True, mv=mi.mv0,
                    ref_idx=mi.ref0, mv1=mi.mv1, ref_idx1=mi.ref1,
                    wp=wp_rec(0)))
                for c in chroma_cs:
                    self.plan.append(BlockRecord(
                        plane=c, x=xc, y=yc, size=wc, h=hc, mode=0, qp=0,
                        levels=None, kind="mc", bi=True, mv=mi.mv0,
                        ref_idx=mi.ref0, mv1=mi.mv1, ref_idx1=mi.ref1,
                        wp=wp_rec(c)))
            else:
                lx = 0 if mi.uses_l0 else 1
                mv = mi.mv0 if lx == 0 else mi.mv1
                ridx = mi.ref0 if lx == 0 else mi.ref1
                self.plan.append(BlockRecord(
                    plane=0, x=x_pb, y=y_pb, size=n_w, h=n_h, mode=0, qp=0,
                    levels=None, kind="mc", mv=mv, ref_idx=ridx, lx=lx,
                    wp=wp_rec(0)))
                for c in chroma_cs:
                    self.plan.append(BlockRecord(
                        plane=c, x=xc, y=yc, size=wc, h=hc, mode=0, qp=0,
                        levels=None, kind="mc", mv=mv, ref_idx=ridx, lx=lx,
                        wp=wp_rec(c)))
        else:
            hs, vs = sps.sub_w - 1, sps.sub_h - 1
            planes_pred = []
            for c in range(3 if sps.chroma_format_idc else 1):
                bdx = bd if c == 0 else bdc
                px, py = (x_pb, y_pb) if c == 0 else (xc, yc)
                pw, ph = (n_w, n_h) if c == 0 else (wc, hc)
                if c == 0:
                    fn = MC.mc_luma
                else:
                    fn = lambda *a: MC.mc_chroma(*a, hshift=hs, vshift=vs)
                preds = []
                if mi.uses_l0:
                    rp = self.ref_list[mi.ref0][1][c]
                    preds.append(fn(rp, px, py, pw, ph,
                                    mi.mv0[0], mi.mv0[1], bdx))
                if mi.uses_l1:
                    rp = self.ref_list_l1[mi.ref1][1][c]
                    preds.append(fn(rp, px, py, pw, ph,
                                    mi.mv1[0], mi.mv1[1], bdx))
                wt = self.sh.weight_table
                use_wp = wt is not None
                if use_wp:
                    denom = (wt.luma_log2_denom if c == 0
                             else wt.chroma_log2_denom)
                    log2wd = denom + 14 - bdx
                    oscale = bdx - 8

                    def wp_of(lst_luma, lst_chroma, ridx):
                        if c == 0:
                            _, wgt, off = lst_luma[ridx]
                        else:
                            _, ws, os_ = lst_chroma[ridx]
                            wgt, off = ws[c - 1], os_[c - 1]
                        return wgt, off << oscale

                    if len(preds) == 2:
                        w0, o0 = wp_of(wt.luma_l0, wt.chroma_l0, mi.ref0)
                        w1, o1 = wp_of(wt.luma_l1, wt.chroma_l1, mi.ref1)
                        out = MC.weighted_bi_explicit(
                            preds[0], preds[1], w0, o0, w1, o1, log2wd, bdx)
                    else:
                        if mi.uses_l0:
                            wgt, off = wp_of(wt.luma_l0, wt.chroma_l0,
                                             mi.ref0)
                        else:
                            wgt, off = wp_of(wt.luma_l1, wt.chroma_l1,
                                             mi.ref1)
                        out = MC.weighted_uni_explicit(preds[0], wgt, off,
                                                       log2wd, bdx)
                elif len(preds) == 2:
                    out = MC.weighted_bi(preds[0], preds[1], bdx)
                else:
                    out = MC.weighted_uni(preds[0], bdx)
                planes_pred.append(out)
            pic.planes[0][y_pb:y_pb + n_h, x_pb:x_pb + n_w] = \
                planes_pred[0].astype(pic.planes[0].dtype)
            for c in ((1, 2) if sps.chroma_format_idc else ()):
                pic.planes[c][yc:yc + hc, xc:xc + wc] = \
                    planes_pred[c].astype(pic.planes[c].dtype)
        y4, x4 = y_pb >> 2, x_pb >> 2
        sl = np.s_[y4:y4 + (n_h >> 2), x4:x4 + (n_w >> 2)]
        if mi.uses_l0:
            pic.mv_l0[sl] = mi.mv0
            pic.ref_l0[sl] = mi.ref0
            pic.ref_poc_l0[sl] = mi.poc0
        if mi.uses_l1:
            pic.mv_l1[sl] = mi.mv1
            pic.ref_l1[sl] = mi.ref1
            pic.ref_poc_l1[sl] = mi.poc1
        pic.mark_block_edges(x_pb, y_pb, n_w, n_h)

    def _decode_inter_pred_idc(self, n_w, n_h, depth):
        """inter_pred_idc (9.3.3: ctxInc = cqtDepth for bin 0)."""
        d, cm = self.d, self.cm
        if n_w + n_h != 12:
            if d.decode_bin(cm.at("inter_pred_idc", depth)):
                return 2  # PRED_BI
        if d.decode_bin(cm.at("inter_pred_idc", 4)):
            return 1  # PRED_L1
        return 0      # PRED_L0

    def _prediction_unit(self, x_pb, y_pb, n_w, n_h, part_idx, part_mode,
                         depth):
        """prediction_unit (7.3.8.6): merge or AMVP, then MC.

        Returns True if merge was used."""
        from ..coding import mvs as MV
        d, cm, sh = self.d, self.cm, self.sh
        is_b = sh.slice_type == SLICE_B
        ref_pocs0 = [p for p, _ in self.ref_list]
        ref_pocs1 = [p for p, _ in self.ref_list_l1]
        if d.decode_bin(cm.at("merge_flag", 0)):
            idx = self._decode_merge_idx()
            cand = MV.merge_candidates(
                self.pic, x_pb, y_pb, n_w, n_h, part_idx, part_mode,
                sh.max_num_merge_cand(), sh.num_ref_idx_l0_active,
                ref_pocs0, sh.num_ref_idx_l1_active, ref_pocs1, is_b,
                tc=self.tmvp, lt0=self.ref_lt0, lt1=self.ref_lt1)
            self._inter_pb(x_pb, y_pb, n_w, n_h, cand[idx])
            return True
        idc = self._decode_inter_pred_idc(n_w, n_h, depth) if is_b else 0
        mi = MV.MotionInfo()
        if idc != 1:  # uses L0
            ref_idx = self._decode_ref_idx(sh.num_ref_idx_l0_active)
            mvd = self._decode_mvd()
            mvp_flag = d.decode_bin(cm.at("mvp_lx_flag", 0))
            cands = MV.amvp_candidates(self.pic, x_pb, y_pb, n_w, n_h, 0,
                                       ref_idx, ref_pocs0, self.cur_poc,
                                       tc=self.tmvp, lt0=self.ref_lt0,
                                       lt1=self.ref_lt1)
            mi.mv0 = (cands[mvp_flag][0] + mvd[0],
                      cands[mvp_flag][1] + mvd[1])
            mi.ref0 = ref_idx
            mi.poc0 = ref_pocs0[ref_idx]
        if idc != 0:  # uses L1
            ref_idx = self._decode_ref_idx(sh.num_ref_idx_l1_active)
            if sh.mvd_l1_zero and idc == 2:
                mvd = (0, 0)
            else:
                mvd = self._decode_mvd()
            mvp_flag = d.decode_bin(cm.at("mvp_lx_flag", 0))
            cands = MV.amvp_candidates(self.pic, x_pb, y_pb, n_w, n_h, 1,
                                       ref_idx, ref_pocs1, self.cur_poc,
                                       tc=self.tmvp, lt0=self.ref_lt0,
                                       lt1=self.ref_lt1)
            mi.mv1 = (cands[mvp_flag][0] + mvd[0],
                      cands[mvp_flag][1] + mvd[1])
            mi.ref1 = ref_idx
            mi.poc1 = ref_pocs1[ref_idx]
        self._inter_pb(x_pb, y_pb, n_w, n_h, mi)
        return False

    def _decode_part_mode_inter(self, log2_size):
        """part_mode for inter CUs (9.3.3.7 Table 9-34 binarization;
        reference: hevc_cabac.c ff_hevc_part_mode_decode — the AMP bin
        uses ctx 3, the size suffix is bypass)."""
        from ..coding.mvs import (PART_2Nx2N, PART_2NxN, PART_2NxnD,
                                  PART_2NxnU, PART_Nx2N, PART_NxN,
                                  PART_nLx2N, PART_nRx2N)
        d, cm, sps = self.d, self.cm, self.sps
        if d.decode_bin(cm.at("part_mode", 0)):
            return PART_2Nx2N
        if log2_size == sps.log2_min_cb_size:
            if d.decode_bin(cm.at("part_mode", 1)):
                return PART_2NxN
            if log2_size == 3:
                return PART_Nx2N
            if d.decode_bin(cm.at("part_mode", 2)):
                return PART_Nx2N
            return PART_NxN
        if not sps.amp_enabled:
            if d.decode_bin(cm.at("part_mode", 1)):
                return PART_2NxN
            return PART_Nx2N
        if d.decode_bin(cm.at("part_mode", 1)):
            if d.decode_bin(cm.at("part_mode", 3)):
                return PART_2NxN
            return PART_2NxnD if d.decode_bypass() else PART_2NxnU
        if d.decode_bin(cm.at("part_mode", 3)):
            return PART_Nx2N
        return PART_nRx2N if d.decode_bypass() else PART_nLx2N

    # ---- coding unit -----------------------------------------------------
    def coding_unit(self, x0, y0, log2_size, depth):
        sps, pps, d, cm, pic = self.sps, self.pps, self.d, self.cm, self.pic
        size = 1 << log2_size
        cu = _CuState()
        cu.x0, cu.y0, cu.log2_size = x0, y0, log2_size
        cu.tq_bypass = 0
        gq = size >> 2
        if pps.transquant_bypass_enabled:
            cu.tq_bypass = d.decode_bin(cm.at("cu_transquant_bypass_flag", 0))
            if cu.tq_bypass:
                pic.tq_bypass[y0 >> 2:(y0 >> 2) + gq,
                              x0 >> 2:(x0 >> 2) + gq] = True
                pic.no_filter[y0 >> 2:(y0 >> 2) + gq,
                              x0 >> 2:(x0 >> 2) + gq] = True
        if self.sh.slice_type != SLICE_I:
            # cu_skip_flag, ctx from neighbour skip flags
            ctx = 0
            if pic.available(x0, y0, x0 - 1, y0) \
                    and pic.skip_flag[y0 >> 2, (x0 - 1) >> 2]:
                ctx += 1
            if pic.available(x0, y0, x0, y0 - 1) \
                    and pic.skip_flag[(y0 - 1) >> 2, x0 >> 2]:
                ctx += 1
            pic.ct_depth[y0 >> 2:(y0 >> 2) + gq,
                         x0 >> 2:(x0 >> 2) + gq] = depth
            pic.qp_y[y0 >> 2:(y0 >> 2) + gq,
                     x0 >> 2:(x0 >> 2) + gq] = self.qp_y
            if d.decode_bin(cm.at("cu_skip_flag", ctx)):
                from ..coding import mvs as MV
                idx = self._decode_merge_idx()
                cand = MV.merge_candidates(
                    pic, x0, y0, size, size, 0, MV.PART_2Nx2N,
                    self.sh.max_num_merge_cand(),
                    self.sh.num_ref_idx_l0_active,
                    [p for p, _ in self.ref_list],
                    self.sh.num_ref_idx_l1_active,
                    [p for p, _ in self.ref_list_l1],
                    self.sh.slice_type == SLICE_B, tc=self.tmvp,
                    lt0=self.ref_lt0, lt1=self.ref_lt1)
                self._inter_pb(x0, y0, size, size, cand[idx])
                pic.skip_flag[y0 >> 2:(y0 >> 2) + gq,
                              x0 >> 2:(x0 >> 2) + gq] = True
                # a skip CU's boundary is still a transform-grid edge
                # for BS derivation (reference marks it via
                # deblocking_boundary_strengths at CU size)
                pic.mark_intra_tu_edges(x0, y0, size)
                return
            if not d.decode_bin(cm.at("pred_mode_flag", 0)):
                self._inter_cu(x0, y0, log2_size, depth, cu)
                return
        cu.pred_intra = True
        cu.intra_split = False
        if log2_size == sps.log2_min_cb_size:
            # part_mode: bin 1 → PART_2Nx2N, 0 → PART_NxN (intra)
            part2n = d.decode_bin(cm.at("part_mode", 0))
            cu.intra_split = not part2n
        if (sps.pcm_enabled and not cu.intra_split
                and sps.log2_min_pcm_cb_size <= log2_size
                <= sps.log2_max_pcm_cb_size
                and d.decode_terminate()):
            # pcm_flag == 1 (7.3.8.5; decoded with DecodeTerminate, 9.3.1)
            self._pcm_cu(x0, y0, log2_size, depth, cu)
            return

        # intra mode syntax: all prev flags, then all mpm/rem payloads
        n_pb = 4 if cu.intra_split else 1
        pb_size = size >> 1 if cu.intra_split else size
        prev_flags = [d.decode_bin(cm.at("prev_intra_luma_pred_flag", 0))
                      for _ in range(n_pb)]
        payload = []
        for i in range(n_pb):
            if prev_flags[i]:
                idx = 0
                if d.decode_bypass():
                    idx = 1 + d.decode_bypass()
                payload.append(idx)
            else:
                payload.append(d.decode_bypass_bits(5))
        # derive modes per PB in z-order, updating the map as we go
        g4 = pb_size >> 2
        for i in range(n_pb):
            xp = x0 + (i & 1) * pb_size
            yp = y0 + (i >> 1) * pb_size
            ca, cb = pic.luma_intra_mode_cand(xp, yp)
            cands = mpm_list(ca, cb)
            if prev_flags[i]:
                mode = cands[payload[i]]
            else:
                mode = payload[i]
                for m in sorted(cands):
                    if mode >= m:
                        mode += 1
            pic.intra_mode_y[yp >> 2:(yp >> 2) + g4,
                             xp >> 2:(xp >> 2) + g4] = mode
            pic.is_intra[yp >> 2:(yp >> 2) + g4,
                         xp >> 2:(xp >> 2) + g4] = True
        # chroma mode (4:2:0 / 4:4:4-single): one per CU; absent for
        # monochrome (ChromaArrayType == 0, 7.3.8.5)
        if sps.chroma_format_idc in (1, 2):
            n_cpb = 1
        elif sps.chroma_format_idc == 0:
            n_cpb = 0
            cu.chroma_mode = 0
        else:
            n_cpb = n_pb
        chroma_modes = []
        cu.chroma_dm = False
        for i in range(n_cpb):
            if d.decode_bin(cm.at("intra_chroma_pred_mode", 0)):
                idx = d.decode_bypass_bits(2)
            else:
                idx = 4
            luma_ref = int(pic.intra_mode_y[
                (y0 + (i >> 1) * pb_size) >> 2, (x0 + (i & 1) * pb_size) >> 2])
            chroma_modes.append(chroma_mode_from_idx(idx, luma_ref))
            if i == 0:
                cu.chroma_dm = idx == 4  # DM: CCP intra gate
        cu.chroma_modes = chroma_modes
        if chroma_modes:
            cu.chroma_mode = chroma_modes[0]

        # bookkeeping for neighbour contexts
        gq = size >> 2
        pic.ct_depth[y0 >> 2:(y0 >> 2) + gq, x0 >> 2:(x0 >> 2) + gq] = depth
        pic.qp_y[y0 >> 2:(y0 >> 2) + gq, x0 >> 2:(x0 >> 2) + gq] = self.qp_y
        if cu.tq_bypass:
            pic.tq_bypass[y0 >> 2:(y0 >> 2) + gq, x0 >> 2:(x0 >> 2) + gq] = True
            pic.no_filter[y0 >> 2:(y0 >> 2) + gq, x0 >> 2:(x0 >> 2) + gq] = True

        cu.inter_split = False
        cu.max_trafo_depth = (sps.max_transform_hierarchy_depth_intra
                              + (1 if cu.intra_split else 0))
        self.transform_tree(x0, y0, x0, y0, log2_size, 0, 0, (1, 1), (1, 1), cu)

    def _pcm_cu(self, x0, y0, log2_size, depth, cu):
        """PCM coding unit: raw u(v) samples in the bitstream, engine
        re-initialized after (7.3.8.7 pcm_sample; reference:
        hevcdec.c hls_pcm_sample)."""
        sps, pic, d = self.sps, self.pic, self.d
        size = 1 << log2_size
        pos = d.begin_pcm()
        data = d.data
        bitpos = pos * 8

        def read(nbits):
            nonlocal bitpos
            v = 0
            for _ in range(nbits):
                v = (v << 1) | ((data[bitpos >> 3] >> (7 - (bitpos & 7))) & 1)
                bitpos += 1
            return v

        blocks = []
        for c_idx in range(3 if sps.chroma_format_idc else 1):
            if c_idx == 0:
                w = h = size
                pbd, bd = sps.pcm_bit_depth_luma, sps.bit_depth_luma
                xs, ys = x0, y0
            else:
                w, h = size // sps.sub_w, size // sps.sub_h
                pbd, bd = sps.pcm_bit_depth_chroma, sps.bit_depth_chroma
                xs, ys = x0 // sps.sub_w, y0 // sps.sub_h
            shift = bd - pbd
            blk = np.empty((h, w), np.int32)
            for yy in range(h):
                for xx in range(w):
                    blk[yy, xx] = read(pbd) << shift
            blocks.append((c_idx, xs, ys, blk))
        d.reinit_at((bitpos + 7) >> 3)

        # bookkeeping: PCM CU is MODE_INTRA; neighbours' MPM derivation
        # sees INTRA_DC (8.4.2); deblocking sees intra edges
        gq = size >> 2
        ysl = slice(y0 >> 2, (y0 >> 2) + gq)
        xsl = slice(x0 >> 2, (x0 >> 2) + gq)
        pic.intra_mode_y[ysl, xsl] = 1  # INTRA_DC
        pic.is_intra[ysl, xsl] = True
        pic.ct_depth[ysl, xsl] = depth
        pic.qp_y[ysl, xsl] = self.qp_y
        if sps.pcm_loop_filter_disabled:
            pic.no_filter[ysl, xsl] = True
        pic.mark_intra_tu_edges(x0, y0, size)

        if self.plan is not None:
            for c_idx, xs, ys, blk in blocks:
                self.plan.append(BlockRecord(
                    plane=c_idx, x=xs, y=ys, size=blk.shape[1],
                    h=blk.shape[0], mode=0, qp=0, levels=blk, kind="pcm"))
            return
        for c_idx, xs, ys, blk in blocks:
            pic.planes[c_idx][ys:ys + blk.shape[0], xs:xs + blk.shape[1]] = \
                blk.astype(pic.planes[c_idx].dtype)

    def _inter_cu(self, x0, y0, log2_size, depth, cu):
        """Inter CU: partitions, PUs (merge/AMVP + MC), residual tree."""
        from ..coding.mvs import (PART_2Nx2N, PART_2NxN, PART_Nx2N,
                                  part_blocks)
        d, cm, sps, pic = self.d, self.cm, self.sps, self.pic
        size = 1 << log2_size
        cu.pred_intra = False
        cu.intra_split = False
        cu.chroma_mode = 0
        cu.chroma_modes = []
        part = self._decode_part_mode_inter(log2_size)
        pbs = part_blocks(part, x0, y0, size)
        first_merge = False
        for i, (xp, yp, w, h) in enumerate(pbs):
            merged = self._prediction_unit(xp, yp, w, h, i, part, depth)
            if i == 0:
                first_merge = merged
        rqt_root_cbf = 1
        if not (part == PART_2Nx2N and first_merge):
            rqt_root_cbf = d.decode_bin(cm.at("no_residual_data_flag", 0))
        if rqt_root_cbf:
            cu.inter_split = (sps.max_transform_hierarchy_depth_inter == 0
                              and part != PART_2Nx2N)
            cu.max_trafo_depth = sps.max_transform_hierarchy_depth_inter
            self.transform_tree(x0, y0, x0, y0, log2_size, 0, 0, (1, 1), (1, 1), cu)
        else:
            # no transform tree: the CU boundary is still a TU-grid edge
            pic.mark_intra_tu_edges(x0, y0, size)

    # ---- transform tree --------------------------------------------------
    def transform_tree(self, x0, y0, xb, yb, log2_size, depth, blk_idx,
                       cbf_cb_par, cbf_cr_par, cu):
        sps, d, cm = self.sps, self.d, self.cm
        intra_split_here = cu.intra_split and depth == 0
        inter_split_here = cu.inter_split and depth == 0
        if (log2_size <= sps.log2_max_tb_size
                and log2_size > sps.log2_min_tb_size
                and depth < cu.max_trafo_depth and not intra_split_here):
            split = d.decode_bin(cm.at("split_transform_flag", 5 - log2_size))
        else:
            split = 1 if (log2_size > sps.log2_max_tb_size
                          or intra_split_here or inter_split_here) else 0
        chroma_here = sps.chroma_format_idc != 0 \
            and (log2_size > 2 or sps.chroma_format_idc == 3)
        is422 = sps.chroma_format_idc == 2
        cbf_cb, cbf_cr = cbf_cb_par, cbf_cr_par  # (first, second) pairs
        if chroma_here:
            second = is422 and (not split or log2_size == 3)

            def parse_pair(par):
                if depth == 0 or par[0]:
                    f0 = d.decode_bin(cm.at("cbf_cbcr", depth))
                    f1 = d.decode_bin(cm.at("cbf_cbcr", depth)) \
                        if second else f0
                    return (f0, f1)
                return (0, 0)

            cbf_cb = parse_pair(cbf_cb_par)
            cbf_cr = parse_pair(cbf_cr_par)
        elif depth == 0:
            cbf_cb = cbf_cr = (0, 0)
        if split:
            half = 1 << (log2_size - 1)
            for i, (dx, dy) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
                self.transform_tree(x0 + dx * half, y0 + dy * half, x0, y0,
                                    log2_size - 1, depth + 1, i,
                                    cbf_cb, cbf_cr, cu)
        else:
            cbf_luma = 1
            if cu.pred_intra or depth != 0 or any(cbf_cb) or any(cbf_cr):
                cbf_luma = d.decode_bin(
                    self.cm.at("cbf_luma", 1 if depth == 0 else 0))
            self.transform_unit(x0, y0, xb, yb, log2_size, depth, blk_idx,
                                cbf_luma, cbf_cb, cbf_cr, cu)

    # ---- transform unit (decode + reconstruct or record) -----------------
    def _decode_levels(self, c_idx, log2_size, mode, cu):
        """Decode one residual block's levels (stage A, no transform).

        Returns (levels, ts_flag, rdpcm, rot): rdpcm = 0/1/2 accumulate
        direction resolved from the explicit flags / implicit hor-ver
        rule; rot = 4x4 transform-skip rotation."""
        sps, pps = self.sps, self.pps
        scan = scan_idx_for_intra(mode, log2_size, c_idx,
                                  sps.chroma_format_idc) \
            if cu.pred_intra else 0
        ts_allowed = (pps.transform_skip_enabled and not cu.tq_bypass
                      and log2_size <= pps.log2_max_transform_skip_block_size)
        if self.rext is None:
            fn = _native_residual() or decode_residual
            out = fn(self.d, self.cm, log2_size, c_idx, scan,
                     sign_data_hiding=bool(pps.sign_data_hiding),
                     transform_skip_allowed=ts_allowed,
                     tq_bypass=bool(cu.tq_bypass))
            levels, ts = out[0], out[1]
            rd_flag = rd_dir = 0
        else:
            levels, ts, rd_flag, rd_dir = decode_residual(
                self.d, self.cm, log2_size, c_idx, scan,
                sign_data_hiding=bool(pps.sign_data_hiding),
                transform_skip_allowed=ts_allowed,
                tq_bypass=bool(cu.tq_bypass),
                rext=self.rext, pred_inter=not cu.pred_intra,
                intra_mode=mode if cu.pred_intra else -1)
        rdpcm = 0
        if self.rext is not None and (ts or cu.tq_bypass):
            if rd_flag:
                rdpcm = 2 if rd_dir else 1
            elif (self.rext.implicit_rdpcm and cu.pred_intra
                  and mode in (10, 26)):
                # implicit: vertical for mode 26, horizontal for 10
                # (reference: hevc_cabac.c:1723-1750; the reference's
                # stale-intra-mode read when explicit+implicit are both
                # enabled on an inter bypass TU is not reproduced)
                rdpcm = 2 if mode == 26 else 1
        rot = bool(sps.transform_skip_rotation and ts and log2_size == 2
                   and cu.pred_intra)
        return levels, ts, rdpcm, rot

    def _component_qp(self, c_idx):
        sps, pps = self.sps, self.pps
        qp = self.qpst.cur_qp  # per-QG QP (== slice QP without cu_qp_delta)
        if c_idx == 0:
            return qp + sps.qp_bd_offset
        off = (pps.cb_qp_offset + self.sh.cb_qp_offset
               + self.qpst.cu_qp_offset_cb if c_idx == 1
               else pps.cr_qp_offset + self.sh.cr_qp_offset
               + self.qpst.cu_qp_offset_cr)
        return R.chroma_qp(qp, off, sps.chroma_format_idc,
                           sps.qp_bd_offset)

    def _decode_cu_chroma_qp_offset(self):
        """cu_chroma_qp_offset_flag/idx (7.3.8.10; reference:
        hevcdec.c:1367-1386)."""
        d, cm, pps = self.d, self.cm, self.pps
        if d.decode_bin(cm.at("cu_chroma_qp_offset_flag", 0)):
            idx = 0
            if len(pps.cb_qp_offset_list) > 1:
                cmax = max(5, len(pps.cb_qp_offset_list) - 1)
                while idx < cmax and d.decode_bin(
                        cm.at("cu_chroma_qp_offset_idx", 0)):
                    idx += 1
            self.qpst.cu_qp_offset_cb = pps.cb_qp_offset_list[idx]
            self.qpst.cu_qp_offset_cr = pps.cr_qp_offset_list[idx]
        else:
            self.qpst.cu_qp_offset_cb = 0
            self.qpst.cu_qp_offset_cr = 0
        self.qpst.is_cu_chroma_qp_offset_coded = True

    def _decode_ccp(self, idx):
        """cross_comp_pred (7.3.8.12) -> res_scale_val (reference:
        hevcdec.c:1306 hls_cross_component_pred)."""
        d, cm = self.d, self.cm
        i = 0
        while i < 4 and d.decode_bin(cm.at("log2_res_scale_abs",
                                           4 * idx + i)):
            i += 1
        if i == 0:
            return 0
        sign = d.decode_bin(cm.at("res_scale_sign_flag", idx))
        return (1 << (i - 1)) * (1 - 2 * sign)

    def _decode_cu_qp_delta(self, cu):
        """cu_qp_delta_abs/sign (7.3.8.10, binarization 9.3.3.9: TR cMax 5
        prefix + EG0 suffix; reference: hevc_cabac.c:756)."""
        d, cm = self.d, self.cm
        prefix = 0
        inc = 0
        while prefix < 5 and d.decode_bin(cm.at("cu_qp_delta", inc)):
            prefix += 1
            inc = 1
        val = prefix
        if prefix >= 5:
            k = 0
            suffix = 0
            while d.decode_bypass():
                suffix += 1 << k
                k += 1
            while k:
                k -= 1
                suffix += d.decode_bypass() << k
            val += suffix
        if val and d.decode_bypass():
            val = -val
        self.qpst.cu_qp_delta_val = val
        self.qpst.is_cu_qp_delta_coded = True
        from ..coding.qp import set_qpy
        set_qpy(self.qpst, self.pic, self.sps, self.pps, cu.x0, cu.y0)

    def _matrix_id(self, c_idx, log2_size, ts, cu) -> int:
        """Active scaling-matrix id for a TU, or -1 for flat scaling
        (reference: hevc_cabac.c:1487/1541 gating incl. the
        transform-skip >4x4 exclusion)."""
        if self.scaling is None or (ts and log2_size > 2):
            return -1
        from ..coding.scaling import matrix_id_for
        return matrix_id_for(not cu.pred_intra, c_idx)

    def _scale_matrix(self, c_idx, log2_size, ts, cu):
        mid = self._matrix_id(c_idx, log2_size, ts, cu)
        if mid < 0:
            return None, 16
        return self.scaling.factor(log2_size, mid)

    def _recon_block(self, c_idx, x, y, size, mode, levels, ts, cu,
                     rdpcm=0, rot=False, ccp=0, ccp_ref=None):
        """Reconstruct one block immediately (stage-B NumPy oracle path),
        or record it into the frame plan.  Returns the BlockRecord (also
        in inline mode — the TU's luma record anchors chroma CCP)."""
        sps, pic = self.sps, self.pic
        log2_size = size.bit_length() - 1
        qp = self._component_qp(c_idx)
        use_dst = (cu.pred_intra and log2_size == 2 and c_idx == 0)
        rec_obj = BlockRecord(
            plane=c_idx, x=x, y=y, size=size, mode=mode, qp=qp,
            levels=None if levels is None else levels.copy(),
            dst=use_dst, ts=bool(ts), tqb=bool(cu.tq_bypass),
            kind="intra" if cu.pred_intra else "resid",
            mtx=self._matrix_id(c_idx, log2_size, ts, cu),
            rdpcm=rdpcm, rot=bool(rot), ccp=ccp, ccp_ref=ccp_ref)
        if self.plan is not None:
            if not cu.pred_intra and levels is None and not ccp:
                return rec_obj  # inter TU, no residual: MC is final
            self.plan.append(rec_obj)
            return rec_obj
        bd = sps.bit_depth_luma if c_idx == 0 else sps.bit_depth_chroma
        maxv = (1 << bd) - 1
        if cu.pred_intra:
            pred = pic.predict_intra(c_idx, x, y, size, mode)
        else:
            # inter: MC prediction is already in the plane
            pred = pic.planes[c_idx][y:y + size, x:x + size].astype(np.int32)
        res = record_residual(pic, rec_obj, bd)
        rec = np.clip(pred + res, 0, maxv) if res is not None else pred
        pic.planes[c_idx][y:y + size, x:x + size] = \
            rec.astype(pic.planes[c_idx].dtype)
        return rec_obj

    def transform_unit(self, x0, y0, xb, yb, log2_size, depth, blk_idx,
                       cbf_luma, cbf_cb, cbf_cr, cu):
        sps, pic, pps = self.sps, self.pic, self.pps
        size = 1 << log2_size
        pic.mark_intra_tu_edges(x0, y0, size)
        # cu_qp_delta: first TU of the QG with any coded residual
        # (reference: hevcdec.c:1346 hls_transform_unit)
        cbf_chroma = (cbf_cb[0] or cbf_cr[0]
                      or (sps.chroma_format_idc == 2
                          and (cbf_cb[1] or cbf_cr[1])))
        if (pps.cu_qp_delta_enabled and not self.qpst.is_cu_qp_delta_coded
                and (cbf_luma or cbf_chroma)):
            self._decode_cu_qp_delta(cu)
        if (self.sh.cu_chroma_qp_offset_enabled and cbf_chroma
                and not cu.tq_bypass
                and not self.qpst.is_cu_chroma_qp_offset_coded):
            self._decode_cu_chroma_qp_offset()
        # ---- luma ----
        mode_y = int(pic.intra_mode_y[y0 >> 2, x0 >> 2])
        lv_y, ts_y, rd_y, rot_y = (None, 0, 0, False)
        if cbf_luma:
            lv_y, ts_y, rd_y, rot_y = self._decode_levels(
                0, log2_size, mode_y, cu)
            pic.cbf_luma[y0 >> 2:(y0 + size) >> 2,
                         x0 >> 2:(x0 + size) >> 2] = True
        rec_y = self._recon_block(0, x0, y0, size, mode_y, lv_y, ts_y, cu,
                                  rdpcm=rd_y, rot=rot_y)
        # ---- chroma ----
        chroma_here = sps.chroma_format_idc != 0 \
            and (log2_size > 2 or sps.chroma_format_idc == 3
                 or blk_idx == 3)
        if not chroma_here:
            return
        fmt = sps.chroma_format_idc
        # cross-component prediction: 4:4:4 only, luma residual present,
        # inter or DM chroma mode (reference: hevcdec.c:1415)
        cross = bool(pps.cross_component_prediction_enabled and cbf_luma
                     and fmt == 3
                     and (not cu.pred_intra or cu.chroma_dm))
        if fmt == 3:
            blocks = [(x0, y0, log2_size)]
        elif fmt == 2:
            # two stacked square TBs (chroma height == luma height)
            if log2_size == 2:
                xc, yc, log2c = xb >> 1, yb, 2
            else:
                xc, yc, log2c = x0 >> 1, y0, log2_size - 1
            blocks = [(xc, yc, log2c), (xc, yc + (1 << log2c), log2c)]
        elif log2_size == 2:
            blocks = [(xb >> 1, yb >> 1, 2)]
        else:
            blocks = [(x0 >> 1, y0 >> 1, log2_size - 1)]
        for c_idx, cbf_pair in ((1, cbf_cb), (2, cbf_cr)):
            mode_c = cu.chroma_mode
            if fmt == 3 and len(getattr(cu, "chroma_modes", ())) > 1 \
                    and log2_size == 2:
                # 4:4:4 NxN: one chroma mode PER PB (7.3.8.5); the
                # intra-split TU leaves map 1:1 to the PBs
                mode_c = cu.chroma_modes[blk_idx]
            if fmt == 2:
                mode_c = CHROMA_422_MODE[mode_c]
            ccp_val = self._decode_ccp(c_idx - 1) if cross else 0
            for half, (xc, yc, log2c) in enumerate(blocks):
                csize = 1 << log2c
                cbf = cbf_pair[half] if isinstance(cbf_pair, tuple) \
                    else cbf_pair
                lv, ts, rd_c, rot_c = (None, 0, 0, False)
                if cbf:
                    lv, ts, rd_c, rot_c = self._decode_levels(
                        c_idx, log2c, mode_c, cu)
                self._recon_block(c_idx, xc, yc, csize, mode_c, lv, ts,
                                  cu, rdpcm=rd_c, rot=rot_c, ccp=ccp_val,
                                  ccp_ref=rec_y if ccp_val else None)


def record_residual(pic: PictureState, r: BlockRecord, bd: int):
    """Residual samples for one intra/resid record, or None.

    Applies the range-extension modifiers in the reference's order
    (dequant -> 4x4-skip rotation -> skip shift -> RDPCM accumulate ->
    cross-component add); RDPCM/CCP arithmetic wraps in int16 like the
    reference's coefficient buffers (reference:
    hevcdsp_template.c:87 transform_rdpcm, hevcdec.c:1441 cross add)."""
    res = None
    if r.levels is not None:
        if r.tqb:
            res = r.levels.astype(np.int32)
        else:
            log2 = r.size.bit_length() - 1
            mtx, dc = (None, 16)
            if r.mtx >= 0 and getattr(pic, "scaling", None) is not None:
                mtx, dc = pic.scaling.factor(log2, r.mtx)
            d = R.dequant(r.levels, r.qp, log2, bd,
                          scale_matrix=mtx, dc_scale=dc)
            if r.rot:
                d = d[::-1, ::-1]
            res = (R.transform_skip_residual(d, bd) if r.ts
                   else R.inverse_transform(d, bd, dst=r.dst))
        if r.rdpcm:
            axis = 0 if r.rdpcm == 2 else 1
            res = np.cumsum(res.astype(np.int16), axis=axis,
                            dtype=np.int16).astype(np.int32)
    if r.ccp:
        ry = record_residual(pic, r.ccp_ref, pic.sps.bit_depth_luma)
        add = ((r.ccp * ry.astype(np.int32)) >> 3).astype(np.int16)
        if res is None:
            res = add.astype(np.int32)
        else:
            res = (res.astype(np.int16) + add).astype(np.int32)
    return res


def execute_plan_numpy(pic: PictureState, plan) -> None:
    """Stage-B oracle executor: replay BlockRecords in decode order."""
    from ..ops import mc as MC
    sps = pic.sps
    for r in plan:
        bd = sps.bit_depth_luma if r.plane == 0 else sps.bit_depth_chroma
        maxv = (1 << bd) - 1
        if r.kind == "mc":
            if r.plane == 0:
                fn = MC.mc_luma
            else:
                hs, vs = sps.sub_w - 1, sps.sub_h - 1
                fn = lambda *a: MC.mc_chroma(*a, hshift=hs, vshift=vs)
            if r.bi:
                p0 = fn(pic.ref_list_l0[r.ref_idx][1][r.plane], r.x, r.y,
                        r.size, r.h, r.mv[0], r.mv[1], bd)
                p1 = fn(pic.ref_list_l1[r.ref_idx1][1][r.plane], r.x, r.y,
                        r.size, r.h, r.mv1[0], r.mv1[1], bd)
                if r.wp is not None:
                    w0, o0, w1, o1, log2wd = r.wp
                    pred = MC.weighted_bi_explicit(p0, p1, w0, o0, w1, o1,
                                                   log2wd, bd)
                else:
                    pred = MC.weighted_bi(p0, p1, bd)
            else:
                refs = pic.ref_list_l0 if r.lx == 0 else pic.ref_list_l1
                raw = fn(refs[r.ref_idx][1][r.plane], r.x, r.y,
                         r.size, r.h, r.mv[0], r.mv[1], bd)
                if r.wp is not None:
                    w0, o0, _w1, _o1, log2wd = r.wp
                    pred = MC.weighted_uni_explicit(raw, w0, o0, log2wd, bd)
                else:
                    pred = MC.weighted_uni(raw, bd)
            pic.planes[r.plane][r.y:r.y + r.h, r.x:r.x + r.size] = \
                pred.astype(pic.planes[r.plane].dtype)
            continue
        if r.kind == "pcm":
            pic.planes[r.plane][r.y:r.y + r.h, r.x:r.x + r.size] = \
                r.levels.astype(pic.planes[r.plane].dtype)
            continue
        if r.kind == "resid":
            pred = pic.planes[r.plane][r.y:r.y + r.size,
                                       r.x:r.x + r.size].astype(np.int32)
        else:
            pred = pic.predict_intra(r.plane, r.x, r.y, r.size, r.mode)
        res = record_residual(pic, r, bd)
        rec = np.clip(pred + res, 0, maxv) if res is not None else pred
        pic.planes[r.plane][r.y:r.y + r.size, r.x:r.x + r.size] = \
            rec.astype(pic.planes[r.plane].dtype)


class _LayerCtx:
    """Per-layer decode state (the analogue of one reference decoder
    instance; reference: openhevc.c MAX_DECODERS wiring :30, :229-231)."""

    def __init__(self, layer_id: int):
        self.layer_id = layer_id
        self.cur_pic: Optional[PictureState] = None
        self.cur_poc = 0
        self.slice_counter = 0
        # DPB: poc -> [int32 planes] of the filtered reconstruction
        # (reference: hevc_refs.c DPB management, re-scoped to a poc map)
        self.dpb: Dict[int, List[np.ndarray]] = {}
        self.dpb_motion: Dict[int, dict] = {}
        # device DPB (HBM-resident padded planes), owned by the pack
        # worker thread after dispatch
        self.dpb_dev: Dict[int, tuple] = {}
        self.pending_sei: Optional[DecodedPictureHash] = None
        # side-data SEIs: persistent items stay attached until cancelled
        # (reference: hevcdec.c set_side_data consuming hevc_sei.c state)
        self.side_data: Dict[str, object] = {}
        self.oneshot_side_data: Dict[str, object] = {}
        self.last_poc = 0
        # inter-layer ref for the picture in flight: (poc, [planes])
        self.il_ref = None
        # decoded-but-not-output pictures, bumped in POC order
        # (reference: hevc_refs.c:224 ff_hevc_output_frame/:358 bump)
        self.out_q: List[DecodedFrame] = []
        self.num_reorder = 0
        # random-access state: RASL pictures with poc <= max_ra are
        # discarded after starting decode at a CRA/BLA (reference:
        # hevcdec.c:3776-3799 max_ra logic)
        self.max_ra: float = float("inf")
        self.skip_cur_pic = False


class Decoder:
    """Stream-level decoder: feed Annex-B bytes, get DecodedFrames.

    Handles single-layer HEVC and SHVC multi-layer streams: NALs are
    routed per nuh_layer_id to per-layer contexts; an enhancement-layer
    picture takes the upsampled base-layer reconstruction as a
    long-term inter-layer reference (reference: hevcdec.c:3597-3637
    hevc_frame_start, hevc_refs.c:168/:719)."""

    def __init__(self, check_md5: bool = True, recon_backend: str = "inline",
                 target_layer: int = 63, temporal_layer: int = 7):
        """recon_backend: 'inline' reconstructs during parse (NumPy oracle);
        'plan' records stage-A symbol plans and replays them (NumPy);
        'jax' records plans and reconstructs on device (hevc_tpu.tpu).
        target_layer/temporal_layer: decode-up-to selectors (the
        quality_layer_id / temporal-layer-id AVOptions of the
        reference, hevcdec.c:4642-4668)."""
        self.vps_map: Dict[int, VPS] = {}
        self.sps_map: Dict[int, SPS] = {}
        self.pps_map: Dict[int, PPS] = {}
        self.recon_backend = recon_backend
        self.check_md5 = check_md5
        self.target_layer = target_layer
        self.temporal_layer = temporal_layer
        self.layers: Dict[int, _LayerCtx] = {}
        self.frames: List[DecodedFrame] = []
        # pts of the AU currently being fed (set by the API wrapper);
        # captured per picture at its first slice so B-frame reordering
        # keeps each picture's own timestamp
        self.next_pts = 0

    def _layer(self, lid: int) -> _LayerCtx:
        if lid not in self.layers:
            self.layers[lid] = _LayerCtx(lid)
        return self.layers[lid]

    def _prefetch(self, lp) -> None:
        """Materialize a frame's device planes on a worker thread so the
        device->host transfer overlaps the next frames' stage A (the
        RPC wait releases the GIL)."""
        import concurrent.futures
        pool = getattr(self, "_fetch_pool", None)
        if pool is None:
            # one worker: frames materialize in decode order
            pool = self._fetch_pool = \
                concurrent.futures.ThreadPoolExecutor(max_workers=1)
        pool.submit(lp._mat)

    def _pack_submit(self, fn, *args):
        """Run fn on the ordered pack worker: a single-thread FIFO
        executor that owns all dpb_dev state and the device dispatch.
        Stage A of frame n+1 (native, GIL-released) overlaps pack +
        dispatch of frame n — the host analogue of the reference's
        frame-thread pipelining (pthread_frame.c:484).  Set
        HEVC_TPU_ASYNC_PACK=0 to run inline."""
        if os.environ.get("HEVC_TPU_ASYNC_PACK", "1") == "0":
            import concurrent.futures
            f = concurrent.futures.Future()
            try:
                f.set_result(fn(*args))
            except BaseException as e:  # noqa: BLE001
                f.set_exception(e)
            return f
        import concurrent.futures
        pool = getattr(self, "_pack_pool", None)
        if pool is None:
            pool = self._pack_pool = \
                concurrent.futures.ThreadPoolExecutor(max_workers=1)
            self._pack_futs = []
        fut = pool.submit(fn, *args)
        self._pack_futs.append(fut)
        return fut

    def decode_bytes(self, data: bytes) -> List[DecodedFrame]:
        import os as _os
        nals = list(nalmod.split_annexb(data))
        # slice-parallel stage A: groups of consecutive slice NALs
        # decode their independent slices on worker threads (native
        # path; SURVEY §2.2 slice parallelism)
        par = (self.recon_backend == "jax"
               and _os.environ.get("HEVC_TPU_SLICE_MT", "1") != "0")
        i = 0
        while i < len(nals):
            n = nals[i]
            if par and nalmod.is_slice_nal(n.type):
                j = i
                while j < len(nals) \
                        and nalmod.is_slice_nal(nals[j].type):
                    j += 1
                group = nals[i:j]
                if len(group) > 1:
                    import os as _os2
                    cpus = _os2.cpu_count() or 1
                    self._batch_threads = max(1, cpus // len(group))
                    self._slice_batch = []
                    try:
                        for nl in group:
                            self.decode_nal(nl)
                        self._run_slice_batch()
                    finally:
                        self._slice_batch = None
                else:
                    self.decode_nal(n)
                i = j
                continue
            self.decode_nal(n)
            i += 1
        self.flush()
        out = self.frames
        self.frames = []
        return out

    def flush(self):
        self._finish_all_pending()
        # pack-worker barrier: every frame's pack/dispatch has run and
        # any worker exception surfaces here (not just at plane access)
        futs = getattr(self, "_pack_futs", None)
        if futs:
            for f in futs:
                f.result()
            futs.clear()
        for lid in sorted(self.layers):
            self._drain_output(self.layers[lid])

    def _run_slice_batch(self):
        """Execute deferred slice-parallel stage-A jobs concurrently
        (all jobs belong to pictures still pending)."""
        jobs = getattr(self, "_slice_batch", None)
        if not jobs:
            return
        self._slice_batch = []
        from .. import trace
        with trace.span("stage_a_native"):
            if len(jobs) == 1:
                jobs[0]()
            else:
                import concurrent.futures
                with concurrent.futures.ThreadPoolExecutor(
                        max_workers=len(jobs)) as ex:
                    for f in [ex.submit(j) for j in jobs]:
                        f.result()

    def _finish_all_pending(self):
        self._run_slice_batch()
        for lid in sorted(self.layers):
            lay = self.layers[lid]
            if lay.cur_pic is not None:
                self._finish_picture(lay)

    def _bump_one(self, lay: _LayerCtx):
        i = min(range(len(lay.out_q)), key=lambda k: lay.out_q[k].poc)
        self.frames.append(lay.out_q.pop(i))

    def _drain_output(self, lay: _LayerCtx):
        while lay.out_q:
            self._bump_one(lay)

    def decode_nal(self, nal: nalmod.NalUnit):
        t = nal.type
        if nal.layer_id > self.target_layer \
                or nal.temporal_id > self.temporal_layer:
            return
        # prefix NALs (PS, prefix SEI, AUD) belong to the NEXT access unit:
        # finalize pictures in flight before processing them
        if t in (nalmod.NAL_VPS, nalmod.NAL_SPS, nalmod.NAL_PPS,
                 nalmod.NAL_AUD, nalmod.NAL_SEI_PREFIX):
            self._finish_all_pending()
        if t == nalmod.NAL_VPS:
            v = VPS.parse_rbsp(nal.rbsp)
            self.vps_map[v.vps_id] = v
        elif t == nalmod.NAL_SPS:
            s = SPS.parse_rbsp(nal.rbsp, nuh_layer_id=nal.layer_id,
                               vps_map=self.vps_map)
            # profile gate (reference: hevc_ps.c parse_ptl "Main/Main10/
            # RExt profile bitstream" logs; log-and-continue policy)
            names = {1: "Main", 2: "Main 10", 3: "Main Still Picture",
                     4: "Range extensions", 7: "Scalable Main"}
            prof = s.ptl.profile_idc
            if prof in names:
                ohlog.log(ohlog.OH_LOG_INFO,
                          f"{names[prof]} profile bitstream")
            else:
                ohlog.log(ohlog.OH_LOG_WARNING,
                          f"Unknown HEVC profile: {prof} — decoding "
                          "anyway (conformance not guaranteed)")
            self.sps_map[s.sps_id] = s
        elif t == nalmod.NAL_PPS:
            p = PPS.parse_rbsp(nal.rbsp)
            self.pps_map[p.pps_id] = p
        elif t in (nalmod.NAL_SEI_PREFIX, nalmod.NAL_SEI_SUFFIX):
            for ptype, payload in parse_sei_rbsp(nal.rbsp):
                lay = self._layer(nal.layer_id)
                if ptype == SEI_TYPE_DECODED_PICTURE_HASH:
                    if t == nalmod.NAL_SEI_SUFFIX \
                            and lay.cur_pic is None:
                        # suffix hash of a picture that was skipped
                        # (e.g. a discarded RASL) — must not attach to
                        # the next decoded picture
                        continue
                    lay.pending_sei = DecodedPictureHash.parse(payload)
                elif ptype in SIDE_DATA_PARSERS:
                    key, parser = SIDE_DATA_PARSERS[ptype]
                    msg = parser(payload)
                    if getattr(msg, "cancel", 0):
                        lay.side_data.pop(key, None)
                    elif key in ("user_data_registered",
                                 "active_parameter_sets"):
                        lay.oneshot_side_data[key] = msg
                    else:
                        lay.side_data[key] = msg
        elif nalmod.is_slice_nal(t):
            self._decode_slice(nal)

    def _start_el_picture(self, lay: _LayerCtx, sps: SPS, sh: SliceHeader,
                          nal_type: int = 0):
        """EL frame start: rendezvous with the base layer and build the
        inter-layer reference by whole-frame upsampling (reference:
        hevcdec.c:3597-3637; upsampling hevc_filter.c / hevcdsp)."""
        vps = self.vps_map[sps.vps_id]
        ext = vps.vps_ext
        ref_lid = ext.ref_layer_id[lay.layer_id][0]
        bl = self.layers.get(ref_lid)
        if bl is None or not bl.dpb:
            raise ValueError(
                f"EL layer {lay.layer_id}: no decoded base layer {ref_lid}")
        # the BL picture of this AU is the one most recently decoded
        bl_poc = bl.last_poc
        lay.cur_poc = bl_poc  # reference: s->poc = BL_frame->poc (:3621)
        bl_planes = bl.dpb[bl_poc]
        rep_bl = ext.rep_format_of(ref_lid)
        bl_bd = rep_bl.bit_depth_luma
        # CGS: colour-map the BL frame through the PPS 3D-LUT before
        # upsampling (reference: hevcdec.c:3627-3629 colorMapping +
        # upsample_base_layer_frame of the mapped frame)
        cgs = getattr(self.pps_map[sh.pps_id], "cgs_lut", None)
        if self.recon_backend == "jax":
            # BL -> EL entirely ON DEVICE: the BL frame's device planes
            # feed colour mapping + upsampling without a host fetch,
            # and the padded result seeds the EL's device DPB — so the
            # BL's stage B, the upsampling, and the EL's stage B just
            # queue back-to-back on the device (the concurrent-layer
            # analogue of the reference's il_progress rendezvous,
            # pthread_frame.c:613-738 / hevcdec.c:3604-3607)
            from ..tpu.pipeline import LazyPlanes, pad_dev_refs
            from ..tpu.upsample import upsample_frame_jax
            getdev = getattr(bl_planes, "device_planes", None)
            dev_in = getdev() if getdev is not None else None
            planes_in = dev_in if dev_in is not None \
                else [np.asarray(p) for p in bl_planes]
            if cgs is not None:
                from ..tpu.upsample import color_map_frame_jax
                planes_in = color_map_frame_jax(cgs, planes_in)
                bl_bd = cgs.out_bd_y
            il_dev = upsample_frame_jax(
                planes_in, sps.width, sps.height,
                sub_w=sps.sub_w, sub_h=sps.sub_h,
                bl_bit_depth=bl_bd,
                el_bit_depth=sps.bit_depth_luma)
            dd = getattr(lay, "dpb_dev", None)
            if dd is None:
                dd = lay.dpb_dev = {}
            dd[bl_poc] = pad_dev_refs(il_dev)
            il = LazyPlanes(list(il_dev))
        else:
            if cgs is not None:
                from ..ops.cgs import color_map_frame
                bl_planes = color_map_frame(cgs, [np.asarray(p)
                                                  for p in bl_planes])
                bl_bd = cgs.out_bd_y
            from ..ops.upsample import upsample_frame
            il = upsample_frame(
                bl_planes, sps.width, sps.height,
                sub_w=sps.sub_w, sub_h=sps.sub_h,
                bl_bit_depth=bl_bd,
                el_bit_depth=sps.bit_depth_luma)
        lay.il_ref = (bl_poc, il)
        # inter-layer motion field for TMVP from the IL ref (set_mfm;
        # zeroed at EL IRAP — reference: hevc_refs.c:733-755)
        from ..ops.upsample import upscale_motion_field
        lay.il_motion = upscale_motion_field(
            bl.dpb_motion[bl_poc], rep_bl.width, rep_bl.height,
            sps.width, sps.height, lay.cur_poc,
            irap=nalmod.is_irap_nal(nal_type))

    def _decode_slice(self, nal: nalmod.NalUnit):
        lid = nal.layer_id
        lay = self._layer(lid)
        r = BitReader(nal.rbsp)
        sh = SliceHeader.parse(r, nal.type, self.sps_map, self.pps_map,
                               nuh_layer_id=lid, vps_map=self.vps_map,
                               temporal_id=nal.temporal_id,
                               prev_independent=getattr(
                                   lay, "prev_indep_sh", None))
        if not sh.dependent_slice_segment:
            lay.prev_indep_sh = sh
        pps = self.pps_map[sh.pps_id]
        sps = self.sps_map[pps.sps_id]
        if not hasattr(pps, "ctb_addr_rs_to_ts"):
            pps.derive(sps)
        if sh.first_slice_in_pic:
            self._finish_all_pending()
            lay.skip_cur_pic = False
            if nalmod.is_idr_nal(nal.type):
                poc = 0
            else:
                poc = self._compute_poc(lay, sps, sh, nal.type)
            # random-access: discard RASL leading pictures of the CRA/BLA
            # we started at (reference: hevcdec.c:3776-3799)
            if nalmod.is_idr_nal(nal.type):
                lay.max_ra = float("-inf")
            elif nalmod.is_irap_nal(nal.type) \
                    and lay.max_ra == float("inf"):
                lay.max_ra = poc
            if nal.type in (nalmod.NAL_RASL_N, nalmod.NAL_RASL_R):
                if poc <= lay.max_ra:
                    ohlog.log(ohlog.OH_LOG_VERBOSE,
                              f"discarding RASL poc {poc} "
                              f"(random access at {lay.max_ra})")
                    lay.skip_cur_pic = True
                    lay.cur_pic = None
                    return
                # only a decodable RASL_R past the CRA ends the discard
                # window (reference: hevcdec.c:3797) — back-to-back CRAs
                # keep discarding each CRA's own leading pictures
                if nal.type == nalmod.NAL_RASL_R:
                    lay.max_ra = float("-inf")
            lay.cur_pic = PictureState(sps, pps)
            lay.cur_pts = self.next_pts
            if self.recon_backend != "inline":
                lay.cur_pic.plan = []
                if self.recon_backend == "jax" and _native_slice() \
                        and not pps.dependent_slice_segments_enabled \
                        and os.environ.get("HEVC_TPU_NATIVE_PACK",
                                           "1") != "0":
                    # raw record chunks feed the native packer directly
                    # (rext streams run the Python syntax layer, whose
                    # records flow through pic.plan)
                    lay.cur_pic.native_chunks = []
            lay.slice_counter = 0
            # prevTid0 tracking for POC derivation (8.3.1)
            if nal.temporal_id == 0 and nal.type not in (
                    nalmod.NAL_RASL_N, nalmod.NAL_RASL_R,
                    nalmod.NAL_RADL_N, nalmod.NAL_RADL_R) \
                    and not (nal.type <= 14 and nal.type % 2 == 0):
                lay.prev_tid0_poc = poc
            if nalmod.is_idr_nal(nal.type):
                # no_output_of_prior_pics_flag (C.3.2): 1 = discard
                # pending outputs, 0 = they precede the IDR
                if sh.no_output_of_prior_pics:
                    lay.out_q.clear()
                else:
                    self._drain_output(lay)
                lay.cur_poc = 0
                lay.dpb.clear()
                if getattr(lay, "dpb_dev", None) is not None:
                    self._pack_submit(lay.dpb_dev.clear)
            else:
                lay.cur_poc = poc
                # RPS-driven DPB: pictures in no RPS bucket are no
                # longer referenced and can be dropped (8.3.2; replaces
                # the old len>16 heuristic; reference: hevc_refs.c:719
                # ff_hevc_frame_rps unref of non-RPS frames)
                rps = sh.cur_rps(sps)
                keep = {poc + d for d in list(rps.delta_poc_s0)
                        + list(rps.delta_poc_s1)}
                if sh.lt_entries:
                    c, f = self._lt_pocs(lay, sps, sh)
                    keep |= set(c) | set(f)
                evict = [p for p in lay.dpb if p not in keep]
                for old in evict:
                    del lay.dpb[old]
                    lay.dpb_motion.pop(old, None)
                if evict and getattr(lay, "dpb_dev", None) is not None:
                    dd = lay.dpb_dev
                    self._pack_submit(
                        lambda dd=dd, ev=evict: [dd.pop(p, None)
                                                 for p in ev])
            lay.cur_pic.output_flag = sh.pic_output_flag
            if lid > 0 and sh.active_num_ilr > 0:
                self._start_el_picture(lay, sps, sh, nal.type)
        elif lay.skip_cur_pic:
            return
        ref_list, ref_list_l1 = [], []
        lt0, lt1 = [], []
        if sh.slice_type != SLICE_I:
            ref_list, ref_list_l1, lt0, lt1 = \
                self._build_ref_lists(lay, sps, sh, nal.type)
        # device DPB handles resolve on the pack worker at pack time
        # (finish_frame_pipeline) — the worker runs frames in order, so
        # every preceding frame's dpb_dev entry exists by then
        assert r.byte_aligned()
        d = CabacDecoder(nal.rbsp, r.pos >> 3)
        if sh.slice_type == SLICE_I:
            init_type = 0
        elif sh.slice_type == SLICE_P:
            init_type = 2 if sh.cabac_init_flag else 1
        else:
            init_type = 1 if sh.cabac_init_flag else 2
        cm = ContextModel(init_type, pps.init_qp + sh.qp_delta)
        dep_state = None
        if sh.dependent_slice_segment:
            # context/QP/rice state continues from the previous
            # segment's end (reference: hevc_cabac.c load_states for
            # dependent segments)
            dep_state = getattr(lay, "dep_state", None)
            assert dep_state is not None, \
                "dependent segment without preceding segment state"
            cm.load(dep_state[0])
        lay.cur_pic.ref_list_l0 = ref_list
        lay.cur_pic.ref_list_l1 = ref_list_l1
        tc = None
        if sh.slice_temporal_mvp_enabled and sh.slice_type != SLICE_I:
            from ..coding.mvs import TemporalCtx
            col_list = ref_list if sh.collocated_from_l0 else ref_list_l1
            col_lts = lt0 if sh.collocated_from_l0 else lt1
            col_poc = col_list[sh.collocated_ref_idx][0]
            all_pocs = [p for p, _ in ref_list] + [p for p, _ in ref_list_l1]
            # collocated == the long-term IL ref (same poc as the
            # current picture) -> upscaled BL motion; a REGULAR
            # long-term ref (e.g. an LT-kept frame 0) is ordinary
            # dpb motion with the no-scaling LT rules (found by the
            # fuzz matrix: long_term_ref + tmvp crashed on il_motion)
            il = getattr(lay, "il_motion", None)
            col_motion = (il if col_lts[sh.collocated_ref_idx]
                          and il is not None
                          and col_poc == lay.cur_poc
                          else lay.dpb_motion[col_poc])
            tc = TemporalCtx(col=col_motion,
                             cur_poc=lay.cur_poc,
                             ctb_log2=sps.log2_ctb_size,
                             pic_w=sps.width, pic_h=sps.height,
                             no_backward=all(p <= lay.cur_poc
                                             for p in all_pocs),
                             col_from_l0=bool(sh.collocated_from_l0))
        lay.cur_pic.tmvp_ctx = tc
        # entry-point segment starts, remapped from EPB'd byte offsets to
        # rbsp offsets (reference: hevcdec.c:3355-3389)
        data_start = r.pos >> 3
        seg_starts = [data_start]
        if sh.entry_point_offsets:
            skipped = nal.skipped_bytes_pos

            def post_to_raw(p):
                return p + sum(1 for q in skipped if q <= p)

            def raw_to_post(rw):
                return rw - sum(1 for k, q in enumerate(skipped)
                                if q + k < rw)

            raw = post_to_raw(data_start)
            for off in sh.entry_point_offsets:
                raw += off
                seg_starts.append(raw_to_post(raw))
        plan = getattr(lay.cur_pic, "plan", None)
        # the slice index spans all of a slice's segments (availability
        # is per-slice, not per-segment)
        seg_slice_idx = lay.slice_counter - 1 \
            if sh.dependent_slice_segment else lay.slice_counter
        # the native mirror carries no cross-NAL context state yet, so
        # dependent-slice streams run the Python syntax layer
        nat = _native_slice() if plan is not None \
            and not pps.dependent_slice_segments_enabled else None
        if nat is not None:
            # full-native stage A (hevc_tpu/native/stage_a.cpp): CTU
            # syntax + MV derivation in C++, bit-exact with SliceDecoder
            from .. import trace
            batch = getattr(self, "_slice_batch", None)
            chunks = getattr(lay.cur_pic, "native_chunks", None)
            if batch is not None and chunks is not None \
                    and not sh.dependent_slice_segment:
                # slice-parallel fan-out: defer the native call; jobs of
                # one picture run concurrently (reference analogue:
                # PARALLEL_SLICE jobs, hevcdec.c:2909)
                slot = len(chunks)
                chunks.append(None)
                batch.append(nat(
                    lay.cur_pic, sps, pps, sh, init_type, nal.rbsp,
                    seg_starts, seg_slice_idx, ref_list, ref_list_l1,
                    lt0, lt1, tc, lay.cur_poc, chunk_slot=slot,
                    n_threads=self._batch_threads, defer=True))
            else:
                with trace.span("stage_a_native"):
                    nat(lay.cur_pic, sps, pps, sh, init_type, nal.rbsp,
                        seg_starts, seg_slice_idx, ref_list,
                        ref_list_l1, lt0, lt1, tc, lay.cur_poc)
        else:
            sd = SliceDecoder(lay.cur_pic, sps, pps, sh, d, cm,
                              seg_slice_idx,
                              plan=plan,
                              ref_list=ref_list, cur_poc=lay.cur_poc,
                              rbsp=nal.rbsp, segment_starts=seg_starts,
                              ref_list_l1=ref_list_l1, tmvp=tc,
                              ref_lt0=lt0, ref_lt1=lt1)
            if dep_state is not None:
                sd.qpst = dep_state[2]
                if sd.rext is not None and dep_state[1] is not None:
                    sd.rext.stats = list(dep_state[1])
                sd.wpp_saved = dep_state[3] if len(dep_state) > 3 \
                    else None
            sd.decode_ctus()
            if pps.dependent_slice_segments_enabled:
                lay.dep_state = (sd.cm.save(),
                                 list(sd.rext.stats)
                                 if sd.rext is not None else None,
                                 sd.qpst, sd.wpp_saved)
        if not sh.dependent_slice_segment:
            lay.slice_counter += 1
            # per-slice filter parameters (multi-slice semantics;
            # dependent segments inherit the independent header's)
            sp = getattr(lay.cur_pic, "slice_params", None)
            if sp is None:
                sp = lay.cur_pic.slice_params = []
            sp.append({
                "beta_offset": sh.beta_offset,
                "tc_offset": sh.tc_offset,
                "disable": bool(sh.deblocking_filter_disabled),
                "lf_across": bool(sh.loop_filter_across_slices),
            })
        # single-slice fast-path parameters (scalar device filters)
        lay.cur_pic.deblock_params = None
        if not sh.deblocking_filter_disabled:
            lay.cur_pic.deblock_params = {
                "beta_offset": sh.beta_offset, "tc_offset": sh.tc_offset,
                "cb_qp_offset": pps.cb_qp_offset,
                "cr_qp_offset": pps.cr_qp_offset,
            }

    def _lt_pocs(self, lay: _LayerCtx, sps: SPS, sh: SliceHeader):
        """(PocLtCurr, PocLtFoll) derivation (8.3.2).

        Entries without delta_poc_msb identify the reference by POC lsb
        alone — resolved against the DPB (the most recent match, per the
        'there shall be exactly one' constraint)."""
        curr, foll = [], []
        max_lsb = sps.max_poc_lsb
        for (lsb, used, msb_present, cyc) in sh.lt_entries:
            if msb_present:
                poc = lsb + lay.cur_poc - cyc * max_lsb \
                      - (lay.cur_poc & (max_lsb - 1))
            else:
                cands = [p for p in lay.dpb
                         if (p & (max_lsb - 1)) == lsb]
                poc = max(cands) if cands else lsb
            (curr if used else foll).append(poc)
        return curr, foll

    def _build_ref_lists(self, lay: _LayerCtx, sps: SPS, sh: SliceHeader,
                         nal_type: int):
        """RefPicList0/1 from the slice RPS (8.3.2/8.3.4 + F.8.3.4).

        Candidate order per list (reference: hevc_refs.c:541-545
        ff_hevc_slice_rpl): L0 = ST_CURR_BEF, IL_REF0, ST_CURR_AFT,
        LT_CURR, IL_REF1; L1 = ST_CURR_AFT, ST_CURR_BEF, LT_CURR,
        IL_REF1.  The inter-layer ref lands in IL_REF0 (all view ids
        are 0) and is long-term, as are PocLtCurr refs.
        ref_pic_lists_modification picks RefPicListTemp entries by
        index (7.3.6.2; reference: hevc_refs.c:516)."""
        before, after, ltc = [], [], []
        if not nalmod.is_idr_nal(nal_type):
            rps = sh.cur_rps(sps)
            before = [lay.cur_poc + d
                      for d, u in zip(rps.delta_poc_s0, rps.used_s0) if u]
            after = [lay.cur_poc + d
                     for d, u in zip(rps.delta_poc_s1, rps.used_s1) if u]
            if sh.lt_entries:
                ltc, _foll = self._lt_pocs(lay, sps, sh)
        il = []
        if lay.layer_id > 0 and sh.active_num_ilr > 0 \
                and lay.il_ref is not None:
            il = [("il", lay.il_ref[0])]
        if not before and not after and not ltc and not il:
            raise ValueError("inter slice with empty reference set")

        def build(cands, n, entries):
            tmp = [cands[i % len(cands)]
                   for i in range(max(n, len(cands)))]
            if entries is not None:
                lst = [tmp[e] for e in entries][:n]
            else:
                lst = tmp[:n]
            refs, lts = [], []
            for kind, poc in lst:
                if kind == "il":
                    refs.append((poc, lay.il_ref[1]))
                    lts.append(True)
                else:
                    refs.append((poc, self._ref_or_conceal(lay, sps, poc)))
                    lts.append(kind == "lt")
            return refs, lts

        st = lambda pocs: [("st", p) for p in pocs]
        lt = [("lt", p) for p in ltc]
        l0, lt0 = build(st(before) + il + st(after) + lt,
                        sh.num_ref_idx_l0_active, sh.list_entry_l0)
        l1, lt1 = [], []
        if sh.slice_type == SLICE_B:
            l1, lt1 = build(st(after) + st(before) + lt + il,
                            sh.num_ref_idx_l1_active, sh.list_entry_l1)
        return l0, l1, lt0, lt1

    def _ref_or_conceal(self, lay: _LayerCtx, sps: SPS, poc: int):
        """Missing-reference concealment: synthesize a mid-gray frame with
        zeroed motion so decode continues (reference: hevc_refs.c:622
        generate_missing_ref + log-and-continue default error policy)."""
        if poc in lay.dpb:
            return lay.dpb[poc]
        ohlog.log(ohlog.OH_LOG_WARNING,
                  f"missing reference picture poc {poc}, concealing")
        dims = [(sps.height, sps.width)]
        if sps.chroma_format_idc:
            dims += [(sps.height // sps.sub_h, sps.width // sps.sub_w)] * 2
        planes = []
        for i, (h, w) in enumerate(dims):
            bd = sps.bit_depth_luma if i == 0 else sps.bit_depth_chroma
            planes.append(np.full((h, w), 1 << (bd - 1), np.int32))
        lay.dpb[poc] = planes
        pw = lay.cur_pic.mv_l0.shape
        h4, w4 = pw[0], pw[1]
        zmv = np.zeros((h4, w4, 2), np.int32)
        zpoc = np.full((h4, w4), -(1 << 30), np.int64)
        lay.dpb_motion[poc] = {"mv0": zmv, "poc0": zpoc,
                               "mv1": zmv.copy(), "poc1": zpoc.copy(),
                               "poc": poc}
        return planes

    def _compute_poc(self, lay: _LayerCtx, sps: SPS, sh: SliceHeader,
                     nal_type: int) -> int:
        # 8.3.1: prevTid0Pic = previous decode-order picture with
        # TemporalId 0 that is not RASL/RADL/sub-layer-non-reference
        # (reference: hevc_refs.c:843 ff_hevc_compute_poc + pocTid0)
        prev = getattr(lay, "prev_tid0_poc", 0)
        max_lsb = sps.max_poc_lsb
        prev_lsb = prev & (max_lsb - 1)
        prev_msb = prev - prev_lsb
        lsb = sh.pic_order_cnt_lsb
        if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
            msb = prev_msb + max_lsb
        elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
            msb = prev_msb - max_lsb
        else:
            msb = prev_msb
        return msb + lsb

    def _finish_picture(self, lay: _LayerCtx):
        pic = lay.cur_pic
        lay.cur_pic = None
        pic.poc = lay.cur_poc
        plan = getattr(pic, "plan", None)
        dev_out = None
        if plan is not None:
            if self.recon_backend == "jax" \
                    and pic.sps.chroma_format_idc == 0 \
                    and getattr(pic, "native_chunks", None) is None:
                # monochrome without native records (e.g. dependent
                # slices): NumPy executor fallback
                execute_plan_numpy(pic, plan)
            elif self.recon_backend == "jax":
                if getattr(pic, "native_chunks", None) is not None \
                        and os.environ.get("HEVC_TPU_PIPELINE",
                                           "1") != "0":
                    # device-resident pipeline on the ordered pack
                    # worker: pack + dispatch of THIS frame overlap the
                    # next frames' stage A; refs stay in HBM, one
                    # metadata upload, async launch + lazy fetch
                    from ..tpu.pipeline import finish_frame_pipeline
                    dev_out = self._pack_submit(finish_frame_pipeline,
                                                pic, lay, lay.cur_poc)
                else:
                    # full device stage B: recon + deblock + SAO in one
                    # jit (per-frame host marshalling)
                    from ..tpu.recon import finish_frame_jax
                    finish_frame_jax(pic, plan)
            else:
                execute_plan_numpy(pic, plan)
        # multi-slice / restricted-tile-boundary filter semantics need
        # the per-CTB parameter path (reference: s->deblock[ctb] +
        # filter_slice_edges, hevc_filter.c:264/:525/:989)
        slice_params = getattr(pic, "slice_params", None) or []
        need_ms = dev_out is None and (
            len(slice_params) > 1
            or (pic.pps.tiles_enabled
                and not pic.pps.loop_filter_across_tiles))
        if need_ms:
            sao_map = getattr(pic, "sao_map", None)
            if not sao_map and getattr(pic, "has_sao", False):
                from ..native import sao_arrays_to_map
                sao_map = sao_arrays_to_map(pic)
            from ..ops.boundaries import filter_frame_multislice
            if not all(p["disable"] for p in slice_params):
                pic.compute_bs()
            else:
                pic.bs_v = np.zeros((pic.h4, pic.w4), np.int8)
                pic.bs_h = np.zeros((pic.h4, pic.w4), np.int8)
            params = [dict(p) for p in slice_params] or [{}]
            tiles = np.asarray(pic.pps.tile_of_ctb) \
                if pic.pps.tiles_enabled else np.zeros_like(pic.slice_idx)
            filter_frame_multislice(
                pic.planes, pic.qp_y.astype(np.int32), pic.bs_v,
                pic.bs_h, pic.slice_idx, tiles, params, sao_map or {},
                1 << pic.sps.log2_ctb_size, pic.sps.bit_depth_luma,
                pic.sps.chroma_format_idc, pic.pps.cb_qp_offset,
                pic.pps.cr_qp_offset,
                bool(pic.pps.loop_filter_across_tiles),
                bool(pic.pps.tiles_enabled),
                pic.sps.sub_w, pic.sps.sub_h,
                no_filter4=pic.no_filter)
        elif dev_out is None \
                and getattr(pic, "deblock_params", None) is not None:
            from ..ops.deblock import deblock_frame
            pic.compute_bs()
            p = pic.deblock_params
            deblock_frame(pic.planes, pic.qp_y.astype(np.int32),
                          pic.bs_v, pic.bs_h,
                          no_filter4=pic.no_filter,
                          bit_depth=pic.sps.bit_depth_luma,
                          beta_offset=p["beta_offset"],
                          tc_offset=p["tc_offset"],
                          chroma_format_idc=pic.sps.chroma_format_idc,
                          cb_qp_offset=p["cb_qp_offset"],
                          cr_qp_offset=p["cr_qp_offset"])
        sao_map = None if (dev_out is not None or need_ms) \
            else getattr(pic, "sao_map", None)
        if dev_out is None and not need_ms and not sao_map \
                and getattr(pic, "has_sao", False):
            from ..native import sao_arrays_to_map
            sao_map = sao_arrays_to_map(pic)
        if sao_map:
            from ..ops.sao import apply_sao_frame
            apply_sao_frame(pic.planes, sao_map,
                            1 << pic.sps.log2_ctb_size,
                            pic.sps.bit_depth_luma,
                            pic.sps.sub_w, pic.sps.sub_h,
                            no_filter4=pic.no_filter)
        # store the filtered reconstruction + motion for inter prediction
        if dev_out is not None:
            from ..tpu.pipeline import LazyPlanes
            lay.dpb[lay.cur_poc] = LazyPlanes(dev_out, dtype=np.int32)
        else:
            lay.dpb[lay.cur_poc] = [p.astype(np.int32)
                                    for p in pic.planes]
        lay.last_poc = lay.cur_poc
        # no copies: pic is finished — its motion arrays are never
        # written again, so the DPB motion table can alias them
        lay.dpb_motion[lay.cur_poc] = {
            "mv0": pic.mv_l0, "poc0": pic.ref_poc_l0,
            "mv1": pic.mv_l1, "poc1": pic.ref_poc_l1,
            "poc": lay.cur_poc}
        lay.il_ref = None
        if dev_out is not None:
            from ..tpu.pipeline import LazyPlanes
            out_planes = LazyPlanes(dev_out, crop=pic.sps)
        else:
            out_planes = crop_conf_win(pic.planes, pic.sps)
        frame = DecodedFrame(planes=out_planes,
                             poc=lay.cur_poc, layer=lay.layer_id,
                             bit_depth=pic.sps.bit_depth_luma,
                             chroma_format=pic.sps.chroma_format_idc,
                             pts=getattr(lay, "cur_pts", 0))
        if lay.side_data or lay.oneshot_side_data:
            frame.side_data = dict(lay.side_data)
            frame.side_data.update(lay.oneshot_side_data)
            lay.oneshot_side_data.clear()
        if lay.pending_sei is not None:
            frame.sei_hash = lay.pending_sei
            lay.pending_sei = None
            if self.check_md5:
                if dev_out is not None:
                    # deferred: evaluate at first access so the async
                    # device->host copy overlaps later frames' decode;
                    # a background worker materializes the planes while
                    # the host parses the next frames
                    from ..tpu.pipeline import LazyPlanes
                    lp = LazyPlanes(dev_out)

                    def _eval(lp=lp, expect=frame.sei_hash.md5,
                              bd=pic.sps.bit_depth_luma):
                        from .. import trace
                        with trace.span("md5_fetch"):
                            planes = list(lp)
                        return picture_md5(planes, bd) == expect
                    frame._md5_eval = _eval
                    self._prefetch(lp)
                else:
                    got = picture_md5(pic.planes, pic.sps.bit_depth_luma)
                    frame.md5_ok = got == frame.sei_hash.md5
        if getattr(pic, "output_flag", 1):
            lay.out_q.append(frame)
        # bumping (C.5.2.2): output when the reorder budget or the DPB
        # capacity is exceeded (reference: hevc_refs.c:224/:358)
        lay.num_reorder = pic.sps.num_reorder_pics[-1]
        max_dec = pic.sps.max_dec_pic_buffering[-1]
        while len(lay.out_q) > lay.num_reorder \
                or len(lay.out_q) >= max_dec:
            if not lay.out_q:
                break
            self._bump_one(lay)
