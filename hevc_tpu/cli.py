"""Decoder CLI — the analogue of the reference's ohplay player.

Capability parity with ohplay_utils/main.c (reference: ohplay.c:68-92 CLI
flags, :377 fps report): decode an Annex-B stream, optionally write the
raw YUV, verify decoded-picture-hash SEI, print `frame= N fps= F time= T`.

Usage: python -m hevc_tpu.cli -i in.265 [-o out.yuv] [-c] [-v LEVEL]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", help="raw YUV output path")
    ap.add_argument("-c", "--no-md5", action="store_true",
                    help="disable SEI decoded-picture-hash checking")
    ap.add_argument("-v", "--log-level", type=int, default=30)
    ap.add_argument("-n", "--frames", type=int, default=0,
                    help="stop after N frames (0 = all)")
    ap.add_argument("-b", "--backend", default="inline",
                    choices=["inline", "plan", "jax"],
                    help="reconstruction backend (jax = device stage B)")
    ap.add_argument("-l", "--layer", type=int, default=63,
                    help="maximum quality (SHVC) layer id to decode; "
                         "output is the highest decoded layer")
    ap.add_argument("-t", "--temporal-layer", type=int, default=7,
                    help="maximum temporal layer id to decode")
    args = ap.parse_args(argv)

    from . import compile_cache
    from .decoder.core import Decoder
    from .io import open_input

    if args.backend == "jax":
        compile_cache.enable()

    # container probe: raw Annex-B, MP4 (hvcC), MPEG-TS
    data = open_input(args.input)
    t0 = time.time()
    dec = Decoder(check_md5=not args.no_md5, recon_backend=args.backend,
                  target_layer=args.layer,
                  temporal_layer=args.temporal_layer)
    frames = dec.decode_bytes(data)
    # output = highest decoded layer (reference: openhevc.c:553-562)
    top = max((f.layer for f in frames), default=0)
    frames = [f for f in frames if f.layer == top]
    if args.frames:
        frames = frames[:args.frames]
    dt = time.time() - t0

    bad = 0
    out = open(args.output, "wb") if args.output else None
    for f in frames:
        if f.md5_ok is False:
            bad += 1
            print(f"Incorrect MD5 (poc {f.poc})", file=sys.stderr)
        elif f.md5_ok and args.log_level >= 40:
            print(f"Correct MD5 (poc {f.poc})")
        if out:
            for p in f.planes:
                bd = 8 if p.dtype == np.uint8 else 16
                out.write(p.astype(np.uint8 if bd == 8 else "<u2").tobytes())
    if out:
        out.close()
    n = len(frames)
    fps = n / dt if dt > 0 else 0.0
    print(f"frame= {n} fps= {fps:.1f} time= {dt:.2f}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
