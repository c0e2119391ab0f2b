"""Multi-host worker: the REAL banded decode pipeline across processes.

Launched N times (one per "host"); each process owns
`local_devices` virtual CPU devices, joins a jax.distributed global
mesh, and runs tpu/sharded.decode_gop_banded — the SAME sharded
stage-B pipeline as single-host — over the process-spanning ("tile",)
mesh, on a self-encoded 3-frame IPP stream with one tile column per
device.  Each process asserts bit-exactness of its ADDRESSABLE output
shards against the sequential decode (SURVEY §4 item (e); the
multi-host analogue of the reference's thread-config MD5 equality).
Used by tests/test_distributed.py.

argv: port process_id num_processes local_devices
Prints 'worker <pid> OK' on success.
"""
import os
import sys

port, pid, nproc, ldev = (sys.argv[1], int(sys.argv[2]),
                          int(sys.argv[3]), int(sys.argv[4]))
N_FRAMES, H = 3, 96

os.environ["XLA_FLAGS"] = \
    f"--xla_force_host_platform_device_count={ldev}"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=nproc,
                           process_id=pid)
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from hevc_tpu.encoder.core import EncoderConfig, IntraEncoder  # noqa: E402
from hevc_tpu.encoder.generate import synth_frame  # noqa: E402
from hevc_tpu.tpu.band import prepare_gop_banded  # noqa: E402
from hevc_tpu.tpu.sharded import decode_gop_banded  # noqa: E402

devs = jax.devices()
n_bands = nproc * ldev
assert len(devs) == n_bands, (len(devs), n_bands)
mesh = Mesh(np.asarray(devs), ("tile",))

W = 32 * n_bands
cfg = EncoderConfig(width=W, height=H, qp=30, log2_ctb_size=5,
                    log2_cu_size=5, gop="ipp", tiles=(n_bands, 1),
                    deblocking=True, sao=True, seed=2, search_range=3)
enc = IntraEncoder(cfg)
stream = b"".join(enc.encode_frame(synth_frame("noise", W, H, t, seed=4))
                  for t in range(N_FRAMES))

frames, ref_planes, (hl, hc) = prepare_gop_banded(stream, n_bands)
assert any(f["spec"]["mc_shapes"] for f in frames), "no inter content"

outs = decode_gop_banded(mesh, frames, halo_l=hl, halo_c=hc,
                         globalize=True)
jax.block_until_ready([o for fr in outs for o in fr])

for i, (got3, want3) in enumerate(zip(outs, ref_planes)):
    for p, (got, want) in enumerate(zip(got3, want3)):
        for sh in got.addressable_shards:
            idx = sh.index  # (slice(None), slice(cols))
            local = np.asarray(sh.data)
            assert (local == want[idx]).all(), \
                f"frame {i} plane {p} shard {sh.index} mismatch"
print(f"worker {pid} OK")
