"""chip_smoke.py's pieces that run without a card: its device check and
its reduction of a profiler trace to device time per named scope."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from hevc_tpu.gpu import require_gpu  # noqa: E402

PHASES = ("mc", "deblock", "sao")


def test_device_check_raises_on_cpu():
    import jax
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="needs a GPU"):
        require_gpu()


def test_hlo_scopes_reads_op_names():
    text = (
        '  %fusion.3 = s32[4]{0} fusion(%p), kind=kLoop, calls=%c, '
        'metadata={op_name="jit(f)/mc/scatter" source_file="x.py"}\n'
        '  ROOT %input_scatter-fusion.1 = s32[4]{0} fusion(%q), '
        'metadata={op_name="jit(f)/deblock/select_n"}\n'
        '  %param.1 = s32[4]{0} parameter(0)\n')
    scopes = chip_smoke.hlo_scopes(text)
    assert scopes["fusion.3"] == "jit(f)/mc/scatter"
    assert scopes["fusion_3"] == "jit(f)/mc/scatter"      # kernel name
    assert scopes["input_scatter_fusion_1"] == "jit(f)/deblock/select_n"
    assert "param.1" not in scopes


@pytest.mark.parametrize("op_name,want", [
    ("jit(f)/mc/vmap(dynamic_slice)", "mc"),
    ("jit(f)/sao", "sao"),
    ("jit(f)/deblock/jit(sao_helper)/add", "deblock"),   # outermost wins
    ("jit(f)/mcx/add", "other"),
    ("", "other"),
])
def test_phase_of(op_name, want):
    assert chip_smoke.phase_of(op_name, PHASES) == want


def test_reduce_phases_attributes_graph_kernels_by_name():
    scopes = {"fusion_1": "jit(f)/mc/x", "fusion_2": "jit(f)/sao/y"}

    def ev(name, start, dur, op="command_buffer", mod="jit_f"):
        return dict(plane="/device:GPU:0", line="s", name=name,
                    start_ns=start, dur_ns=dur,
                    stats={"hlo_op": op, "hlo_module": mod})

    events = [ev("fusion_1", 0, 10), ev("fusion_2", 20, 5),
              ev("fusion_2", 20, 5),                  # duplicate: once
              ev("gemm_kernel", 30, 10),              # unattributed
              ev("fusion_1", 40, 99, mod="jit_other")]  # other module
    per, unknown, total, busy, window = chip_smoke.reduce_phases(
        events, scopes, PHASES, "jit_f")
    assert per == {"mc": 10, "deblock": 0, "sao": 5, "other": 10}
    assert unknown == {"gemm_kernel": 10}
    assert (total, busy, window) == (25, 25, 40)
