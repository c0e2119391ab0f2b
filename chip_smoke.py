"""Smoke test of the decode path on a GPU, through the entry points a user
calls, at real stream geometry, bit-exact.

    python3 chip_smoke.py          # one card: phases 1-5
    python3 chip_smoke.py --four   # four cards: the column-banded decode only

One card:
  1. device  — JAX's default backend must be a GPU; the native stage A
     must load (no silent fallback to the Python stage A).
  2. main_1080p — a 1920x1080 8-bit 4:2:0 WPP IPP stream (CTB 64, QP 30)
     made from a seed by the repo's encoder, decoded twice (cold, then
     warm) through Decoder(check_md5=True, recon_backend="jax"): MD5 ok on
     every frame, the right frame count, both passes byte-identical.
  3. main_4k — the same at 3840x2160, I + P.
  4. phases  — a profiler trace of a warm P frame and of the I frame at
     1080p and at 4K: device time of each named stage-B scope
     (tpu/pipeline.py PHASES).
  5. coverage — 10-bit random-access hierarchical-B, 4:2:2 10-bit
     all-intra and two-layer x2 SHVC at 832x480, MD5 checked; plus the
     batched int32 IDCT at all four TU sizes against the NumPy reference.
--four: a 3840x2160 stream with 4 equal tile columns decoded over a flat
4-GPU ("tile",) mesh (tpu/sharded.decode_gop_banded), bit-identical to
the one-card Decoder output and to the SEI MD5; the halo ppermute time
from a trace.

Every result line names the card (nvidia-smi name, power limit).  Any
failure raises: the script then exits non-zero and prints no result
line.  The last line of stdout is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}.  Traces and a
summary go to chiprun_out/smoke/.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import glob
import json
import multiprocessing
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "smoke")

# stream geometry (width, height) per named stream
GEOMETRY = {"main_1080p": (1920, 1080), "main_4k": (3840, 2160),
            "ra10": (832, 480), "intra422_10": (832, 480),
            "shvc_x2": (832, 480), "tiles4_4k": (3840, 2160)}
ONE_CARD = ("main_1080p", "main_4k", "ra10", "intra422_10", "shvc_x2")

DEVICE_PLANE = "/device:GPU"     # profiler planes that hold device events
BACKEND_COMPILE = "/jax/core/compile/backend_compile_duration"
_COMPILES = []          # (fun_name, seconds) per backend compile


# ---------------------------------------------------------------------------
# streams: generated from seeds, in parallel worker processes (no JAX)
# ---------------------------------------------------------------------------

def _shifted(frame, bd):
    return [p.astype(np.int32) << (bd - 8) for p in frame] if bd > 8 \
        else frame


def make_stream(name, w, h):
    """(bytes, output frame count) of one named test stream at w x h."""
    from bench import synth_stream
    from hevc_tpu.encoder.core import (EncoderConfig, IntraEncoder,
                                       RaEncoder)
    from hevc_tpu.encoder.generate import synth_frame
    from hevc_tpu.encoder.shvc import ShvcEncoder

    if name == "main_1080p":
        return synth_stream(w, h, 30, 6, wpp=True), 6
    if name == "main_4k":
        return synth_stream(w, h, 30, 2, wpp=True), 2
    if name == "tiles4_4k":
        return synth_stream(w, h, 30, 2, wpp=False, tiles=(4, 1)), 2
    if name == "ra10":
        cfg = EncoderConfig(width=w, height=h, qp=30, bit_depth=10,
                            log2_ctb_size=5, log2_cu_size=5, gop="ra",
                            deblocking=True, sao=True, seed=3,
                            search_range=3)
        base = synth_frame("gradient", w, h, 0)
        frames = [_shifted([np.roll(p, (t * 2, t * 3), (0, 1))
                            for p in base], 10) for t in range(5)]
        return bytes(RaEncoder(cfg).encode(frames)), 5
    if name == "intra422_10":
        cfg = EncoderConfig(width=w, height=h, qp=27, bit_depth=10,
                            chroma_format_idc=2, log2_ctb_size=5,
                            log2_cu_size=5, deblocking=True, sao=True,
                            seed=5)
        enc = IntraEncoder(cfg)
        data = bytearray()
        for t in range(2):
            data += enc.encode_frame(
                _shifted(synth_frame("zoneplate", w, h, t), 10))
        return bytes(data), 2
    if name == "shvc_x2":
        bl = EncoderConfig(width=w // 2, height=h // 2, qp=32,
                           log2_ctb_size=5, log2_cu_size=5, gop="ipp",
                           search_range=2, seed=3)
        el = EncoderConfig(width=w, height=h, qp=30, log2_ctb_size=5,
                           log2_cu_size=5, gop="ipp", search_range=2,
                           seed=4, deblocking=True, sao=True)
        enc = ShvcEncoder(bl, el)
        blb = synth_frame("gradient", w // 2, h // 2, 0)
        elb = synth_frame("zoneplate", w, h, 0)
        data = bytearray()
        for t in range(3):
            data += enc.encode_frame(
                [np.roll(p, (t * 2, t * 3), (0, 1)) for p in blb],
                [np.roll(p, (t * 4, t * 6), (0, 1)) for p in elb])
        return bytes(data), 6          # both layers are output
    raise ValueError(name)


def _encode_job(name, w, h):
    t0 = time.perf_counter()
    data, n = make_stream(name, w, h)
    return data, n, time.perf_counter() - t0


def _child_init():
    os.environ["JAX_PLATFORMS"] = "cpu"   # encoders never touch the card


def encode_all(jobs):
    """{name: (bytes, n_frames, encode_s)} — one spawned process each."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=len(jobs), mp_context=ctx,
            initializer=_child_init) as pool:
        futs = {name: pool.submit(_encode_job, name, w, h)
                for name, (w, h) in jobs.items()}
        try:
            return {name: f.result() for name, f in futs.items()}
        except BaseException:
            for f in futs.values():
                f.cancel()
            raise


# ---------------------------------------------------------------------------
# decode passes
# ---------------------------------------------------------------------------

def _on_duration(event, secs, **kw):
    if event == BACKEND_COMPILE:
        _COMPILES.append((kw.get("fun_name"), secs))


def decode_pass(data, n_expect, capture=None, **dec_kw):
    """Decode through Decoder(check_md5=True, recon_backend="jax");
    materialize every plane on the host.  Raises unless every frame's
    SEI MD5 matched and the frame count is right."""
    from hevc_tpu import trace
    from hevc_tpu.decoder.core import Decoder
    import hevc_tpu.tpu.pipeline as pl

    orig = pl._pipeline_frame
    if capture is not None:
        def wrapper(*args):
            if args[7]:                       # refs_y: the last P/B frame
                capture["P"] = args
            else:                             # the first intra frame
                capture.setdefault("I", args)
            return orig(*args)
        pl._pipeline_frame = wrapper
    c0 = len(_COMPILES)
    trace.reset()
    t0 = time.perf_counter()
    try:
        frames = Decoder(check_md5=True, recon_backend="jax",
                         **dec_kw).decode_bytes(data)
        planes = [[np.asarray(p) for p in f.planes] for f in frames]
    finally:
        pl._pipeline_frame = orig
    dt = time.perf_counter() - t0
    bad = [(f.layer, f.poc) for f in frames if f.md5_ok is not True]
    if bad:
        raise AssertionError(f"MD5 not ok for (layer, poc) {bad}")
    if len(frames) != n_expect:
        raise AssertionError(f"{len(frames)} frames, expected {n_expect}")
    comp = _COMPILES[c0:]
    stages = {k: round(v["total_s"] / len(frames) * 1e3, 3)
              for k, v in trace.report().items()}
    return dict(planes=planes, seconds=dt, fps=len(frames) / dt,
                compiles=len(comp),
                compile_s=round(sum(s for _n, s in comp), 3),
                stage_ms_per_frame=stages)


def _as_bytes(planes):
    return b"".join(p.tobytes() for fr in planes for p in fr)


def main_stream(name, data, n, dev, capture):
    """Cold + warm decode of one main stream; both must be identical."""
    cold = decode_pass(data, n)
    warm = decode_pass(data, n, capture=capture)
    if _as_bytes(cold["planes"]) != _as_bytes(warm["planes"]):
        raise AssertionError(f"{name}: cold and warm decodes differ")
    if set(capture) != {"I", "P"}:
        raise AssertionError(f"{name}: captured {sorted(capture)}, "
                             f"wanted an intra and an inter frame")
    return {
        "frames": n,
        "cold_fps": round(cold["fps"], 3),
        "warm_fps": round(warm["fps"], 3),
        "cold_s": round(cold["seconds"], 3),
        "warm_s": round(warm["seconds"], 3),
        "compiles_cold": cold["compiles"],
        "compile_s_cold": cold["compile_s"],
        "compiles_warm": warm["compiles"],
        "stage_ms_per_frame_warm": warm["stage_ms_per_frame"],
        "peak_bytes_in_use":
            (dev.memory_stats() or {}).get("peak_bytes_in_use"),
        "bit_identical_cold_warm": True,
    }


# ---------------------------------------------------------------------------
# trace reduction: device time per named stage-B scope
# ---------------------------------------------------------------------------

def hlo_scopes(hlo_text):
    """{instruction name: op_name metadata} of a compiled HLO module's
    text; names are also keyed with '.'/'-' mapped to '_' (GPU kernel
    names follow the fusion's name that way)."""
    import re
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?'
                     r'metadata=\{[^}]*op_name="([^"]*)"')
    out = {}
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m:
            out[m.group(1)] = m.group(2)
            out[m.group(1).replace(".", "_").replace("-", "_")] = \
                m.group(2)
    return out


def phase_of(op_name, phases):
    """The outermost named scope of `phases` in an op_name path, or
    "other"."""
    path = "/" + op_name + "/"
    best, pos = "other", len(path)
    for p in phases:
        i = path.find("/" + p + "/")
        if 0 <= i < pos:
            best, pos = p, i
    return best


def device_events(trace_dir):
    """Events of the GPU planes of the newest trace under trace_dir:
    dicts of plane, line, name, start_ns, dur_ns, stats."""
    from jax.profiler import ProfileData
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    if not paths:
        raise AssertionError(f"no trace written under {trace_dir}")
    pd = ProfileData.from_file(paths[-1])
    out = []
    for plane in pd.planes:
        if not plane.name.startswith(DEVICE_PLANE):
            continue
        for line in plane.lines:
            for ev in line.events:
                out.append(dict(plane=plane.name, line=line.name,
                                name=ev.name, start_ns=ev.start_ns,
                                dur_ns=ev.duration_ns,
                                stats={k: v for k, v in ev.stats}))
    return out


def reduce_phases(events, scopes, phases, module):
    """Sum device nanoseconds per phase over the kernels of `module`.

    A kernel is attributed through its hlo_op stat or, where that names
    no instruction (kernels replayed from a CUDA graph carry
    "command_buffer"), its kernel name to the op_name of that
    instruction in `scopes`.  Returns (ns per phase incl. "other", ns
    per unattributed kernel name, total ns, busy ns, window ns); busy is
    the union of the module's kernel intervals, window the span from
    the first start to the last end."""
    per = {p: 0 for p in phases + ("other",)}
    unknown = {}
    seen = set()
    spans = []
    for ev in events:
        st = ev["stats"]
        if module not in str(st.get("hlo_module", "")):
            continue
        op = next((c for c in (str(st.get("hlo_op", "")), ev["name"])
                   if c in scopes), None)
        key = (ev["start_ns"], ev["dur_ns"], ev["name"])
        if key in seen:
            continue
        seen.add(key)
        phase = phase_of(scopes[op], phases) if op else "other"
        per[phase] += ev["dur_ns"]
        if phase == "other":
            unknown[ev["name"]] = unknown.get(ev["name"], 0) + ev["dur_ns"]
        spans.append((ev["start_ns"], ev["start_ns"] + ev["dur_ns"]))
    total = sum(per.values())
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (max(b for _a, b in spans) - min(a for a, _b in spans)) \
        if spans else 0
    return per, unknown, total, busy, window


def _kernel_table(events):
    """{plane | line: {kernel name: [count, total ns, module]}} — what a
    trace held, small enough to keep."""
    out = {}
    for ev in events:
        tab = out.setdefault(f"{ev['plane']} | {ev['line']}", {})
        row = tab.setdefault(ev["name"], [0, 0, str(
            ev["stats"].get("hlo_module", ""))])
        row[0] += 1
        row[1] += ev["dur_ns"]
    return out


def traced(label, fn, reps):
    """Run fn() reps times under the profiler (after one warm call);
    returns (device events, host seconds per call)."""
    import jax
    jax.block_until_ready(fn())
    d = os.path.join(OUT, "trace_" + label)
    shutil.rmtree(d, ignore_errors=True)
    jax.profiler.start_trace(d)
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn())
    wall = (time.perf_counter() - t0) / reps
    jax.profiler.stop_trace()
    events = device_events(d)
    with open(os.path.join(OUT, f"kernels_{label}.json"), "w") as f:
        json.dump(_kernel_table(events), f, indent=1, sort_keys=True)
    shutil.rmtree(d, ignore_errors=True)
    if not events:
        raise AssertionError(f"{label}: no device events in the trace")
    return events, wall


def phase_times(label, args, reps=3):
    """Device ms per named stage-B scope of one captured frame."""
    import hevc_tpu.tpu.pipeline as pl
    fn = pl._pipeline_frame
    events, wall = traced(label, lambda: fn(*args), reps)
    hlo = fn.lower(*args).compile().as_text()
    with open(os.path.join(OUT, f"hlo_{label}.txt"), "w") as f:
        f.write(hlo)
    scopes = hlo_scopes(hlo)
    per, unknown, total, busy, window = reduce_phases(
        events, scopes, pl.PHASES, "_pipeline_frame")
    if total == 0:
        raise AssertionError(f"{label}: no _pipeline_frame kernels found")
    top = sorted(unknown.items(), key=lambda kv: -kv[1])[:8]
    return {
        "phase_device_ms": {k: round(v / reps / 1e6, 4)
                            for k, v in per.items()},
        "other_top_ms": {k: round(v / reps / 1e6, 4) for k, v in top},
        "pipeline_frame_device_ms": round(total / reps / 1e6, 4),
        "pipeline_frame_host_ms": round(wall * 1e3, 4),
        "device_idle_share": round(1 - busy / window, 4) if window else None,
        "kernels_per_frame": len([e for e in events if "_pipeline_frame"
                                  in str(e["stats"].get("hlo_module", ""))])
        // reps,
    }


# ---------------------------------------------------------------------------
# kernels against the NumPy reference
# ---------------------------------------------------------------------------

def check_idct(n=2048, n_check=64, seed=0):
    """Batched dequant + int32 IDCT at all four TU sizes (and the 4x4 DST
    and transform skip) vs ops/reference.py, on the default device."""
    import jax.numpy as jnp
    from hevc_tpu.ops import reference as R
    from hevc_tpu.tpu.transforms import residual_batch
    rng = np.random.default_rng(seed)
    for log2 in (2, 3, 4, 5):
        s = 1 << log2
        for bd in (8, 10):
            lv = rng.integers(-512, 512, (n, s, s)).astype(np.int32)
            lv[rng.random((n, s, s)) < 0.7] = 0
            qp = rng.integers(0, 52 + 6 * (bd - 8), n).astype(np.int32)
            dst = (rng.random(n) < 0.5) if log2 == 2 else np.zeros(n, bool)
            ts = (rng.random(n) < 0.3) if log2 == 2 else np.zeros(n, bool)
            out = np.asarray(residual_batch(
                jnp.asarray(lv), jnp.asarray(qp), jnp.asarray(dst),
                jnp.asarray(ts), log2, bd))
            for i in rng.choice(n, n_check, replace=False):
                d = R.dequant(lv[i], int(qp[i]), log2, bd)
                ref = (R.transform_skip_residual(d, bd) if ts[i]
                       else R.inverse_transform(d, bd, dst=bool(dst[i])))
                if not (out[i] == ref).all():
                    raise AssertionError(
                        f"IDCT {s}x{s} bd{bd} block {i} differs")
    return {"idct_sizes_checked": [4, 8, 16, 32], "blocks_per_size": n,
            "exact": True}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def _line(card, label, obj):
    print(f"[{card}] {label} {json.dumps(obj, sort_keys=True)}",
          flush=True)


def run_one_card(devs, card, summary):
    t0 = time.perf_counter()
    streams = encode_all({k: GEOMETRY[k] for k in ONE_CARD})
    enc = {k: round(v[2], 3) for k, v in streams.items()}
    summary["encode_s"] = enc
    _line(card, "encode", {"encode_s": enc,
                           "wall_s": round(time.perf_counter() - t0, 3),
                           "bytes": {k: len(v[0])
                                     for k, v in streams.items()}})

    captured = {}
    for name in ("main_1080p", "main_4k"):
        data, n, _s = streams[name]
        cap = {}
        res = main_stream(name, data, n, devs[0], cap)
        captured[name + "_P"] = cap["P"]
        captured[name + "_I"] = cap["I"]
        summary[name] = res
        _line(card, name, res)

    for name, args in captured.items():
        res = phase_times(name, args)
        res["spec_nlv"] = dict(args[-1])["nlv"]
        res["mc_groups"] = len(dict(args[-1])["mc_groups"])
        summary["phases_" + name] = res
        _line(card, "phases_" + name, res)

    res = check_idct()
    summary["idct"] = res
    _line(card, "idct", res)
    for name in ("ra10", "intra422_10", "shvc_x2"):
        data, n, _s = streams[name]
        r = decode_pass(data, n)
        res = {"frames": n, "fps": round(r["fps"], 3),
               "compiles": r["compiles"], "compile_s": r["compile_s"],
               "md5_ok": True,
               "dtype": str(r["planes"][0][0].dtype)}
        summary[name] = res
        _line(card, name, res)


def run_four(devs, card, summary):
    """Column-banded 4K decode over four cards vs the one-card decode."""
    import jax
    from jax.sharding import Mesh
    from hevc_tpu.tpu.band import prepare_gop_banded
    from hevc_tpu.tpu.sharded import decode_gop_banded
    if len(devs) < 4:
        raise AssertionError(f"--four needs 4 GPUs, JAX sees {len(devs)}")
    name = "tiles4_4k"
    data, n, enc_s = encode_all({name: GEOMETRY[name]})[name]
    one = decode_pass(data, n)                      # one card, MD5 checked
    t0 = time.perf_counter()
    frames, ref_planes, (hl, hc) = prepare_gop_banded(data, 4)
    prep_s = time.perf_counter() - t0
    mesh = Mesh(np.asarray(devs[:4]), ("tile",))

    def run():
        return decode_gop_banded(mesh, frames, halo_l=hl, halo_c=hc)

    c0 = len(_COMPILES)
    t0 = time.perf_counter()
    outs = jax.block_until_ready(run())
    cold_s = time.perf_counter() - t0
    compiles = _COMPILES[c0:]
    for i, (got3, plan3, one3) in enumerate(zip(outs, ref_planes,
                                                one["planes"])):
        for p, (g, w, o) in enumerate(zip(got3, plan3, one3)):
            g = np.asarray(g)
            if not (np.array_equal(g, w) and np.array_equal(g, o)):
                raise AssertionError(f"banded frame {i} plane {p} differs")
    t0 = time.perf_counter()
    jax.block_until_ready(run())
    warm_s = time.perf_counter() - t0
    events, _wall = traced("banded_4k", run, reps=2)
    halo_ns = sum(e["dur_ns"] for e in events
                  if any(k in (e["name"] + str(e["stats"].get("hlo_op", "")))
                         .lower()
                         for k in ("collective-permute", "collective_permute",
                                   "ppermute", "sendrecv")))
    res = {"frames": n, "encode_s": round(enc_s, 3),
           "stage_a_pack_s": round(prep_s, 3),
           "cold_s": round(cold_s, 3), "warm_s": round(warm_s, 3),
           "warm_fps": round(n / warm_s, 3), "compiles": len(compiles),
           "compile_s": round(sum(s for _n, s in compiles), 3),
           "halo": [hl, hc],
           "halo_ppermute_device_ms_per_gop_all_cards":
               round(halo_ns / 2 / 1e6, 4),
           "bit_identical_to_one_card": True, "md5_ok": True}
    summary["banded_4k_four_cards"] = res
    _line(card.replace("\n", " | "), "banded_4k_four_cards", res)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card column-banded decode")
    args = ap.parse_args(argv)

    import jax

    from hevc_tpu import compile_cache, native
    from hevc_tpu.gpu import card_name_power, device_info, require_gpu

    devs = require_gpu()
    card = card_name_power()
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}: {device_info(devs)}", flush=True)
    if not native.available():
        raise RuntimeError("native stage A unavailable: the decode would "
                           "fall back to the Python stage A")
    cache = compile_cache.enable()
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    os.makedirs(OUT, exist_ok=True)
    summary = {"card": card, "device": device_info(devs),
               "jax": jax.__version__, "compile_cache": cache}
    card1 = card.splitlines()[0]
    if args.four:
        run_four(devs, card, summary)
        count = 4
    else:
        run_one_card(devs, card1, summary)
        count = len(devs)
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1, sort_keys=True)
    info = device_info(devs)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
