"""Multi-process (multi-host analogue) execution on the CPU backend.

SURVEY §4 item (e): sharded layouts must run across process boundaries
without a pod.  Two levels here:
  1. primitive: cross-process ppermute halo exchange + global psum
     (the banded pipeline's collective pattern in isolation);
  2. the REAL pipeline: tools/dist_banded_worker.py runs
     tpu/sharded.decode_gop_banded — MC + residual + intra wavefront +
     deblock/SAO with per-device DPB windows — on a global ("tile",)
     mesh spanning 2 processes, each asserting bit-exactness of its
     addressable shards vs the sequential decode.
"""
import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import sys
import numpy as np
port, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=nproc,
                           process_id=pid)
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

devs = jax.devices()
assert len(devs) == nproc, f"global cpu devices {len(devs)} != {nproc}"
mesh = Mesh(np.asarray(devs), ("tile",))

H, BW = 8, 16
W = BW * nproc
full = np.arange(H * W, dtype=np.int32).reshape(H, W)

def cb(idx):
    return full[idx]

sharding = NamedSharding(mesh, P(None, "tile"))
x = jax.make_array_from_callback((H, W), sharding, cb)

def body(x):
    # 2-column halo exchange with both neighbours (the MC/filter halo
    # pattern); frame edges receive zeros
    n = nproc
    send_r = [(i, i + 1) for i in range(n - 1)]
    send_l = [(i + 1, i) for i in range(n - 1)]
    left = jax.lax.ppermute(x[:, -2:], "tile", send_r)
    right = jax.lax.ppermute(x[:, :2], "tile", send_l)
    ext = jnp.concatenate([left, x, right], axis=1)
    # and a global reduction over the mesh
    total = jax.lax.psum(jnp.sum(x), "tile")
    return ext, total

fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(None, "tile"),),
                       out_specs=(P(None, "tile"), P())))
ext, total = fn(x)
assert int(total) == int(full.sum()), (int(total), int(full.sum()))
# check this process's shard of the halo-extended output
local = np.asarray([s.data for s in ext.addressable_shards][0])
k = pid
want_left = (full[:, k * BW - 2:k * BW] if k > 0
             else np.zeros((H, 2), np.int32))
want_right = (full[:, (k + 1) * BW:(k + 1) * BW + 2] if k < nproc - 1
              else np.zeros((H, 2), np.int32))
want = np.concatenate([want_left, full[:, k * BW:(k + 1) * BW],
                       want_right], axis=1)
assert (local == want).all(), "halo exchange mismatch"
print(f"worker {pid} OK")
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(cmds, timeout=600):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for cmd in cmds]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out")
        outs.append(out.decode(errors="replace"))
    return procs, outs


def test_two_process_halo_exchange(tmp_path):
    wfile = tmp_path / "worker.py"
    wfile.write_text(_WORKER)
    port = _free_port()
    procs, outs = _run_workers(
        [[sys.executable, str(wfile), str(port), str(pid), "2"]
         for pid in range(2)], timeout=150)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 and "distributed.initialize" in out \
                and "NotImplementedError" in out:
            pytest.skip("jax.distributed unavailable on this backend")
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"worker {pid} OK" in out


def test_two_process_banded_decode():
    """The REAL banded stage-B pipeline (MC + residual + intra +
    filters, per-device DPB, ppermute halos) on a global mesh spanning
    2 processes x 2 devices, each process asserting bit-exactness of
    its addressable output shards — the SAME banded pipeline as one
    process, not a toy array."""
    worker = os.path.join(os.path.dirname(__file__), "..", "tools",
                          "dist_banded_worker.py")
    port = _free_port()
    procs, outs = _run_workers(
        [[sys.executable, worker, str(port), str(pid), "2", "2"]
         for pid in range(2)])
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 and "distributed.initialize" in out \
                and "NotImplementedError" in out:
            pytest.skip("jax.distributed unavailable on this backend")
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"worker {pid} OK" in out
