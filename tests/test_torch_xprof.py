"""The port's profile report (``utils/xprof.py``, ``cli/profile_report.py``)
on hand-written and live ``torch.profiler`` traces, and against agenda_tpu's
report format, on the CPU.

- A hand-written ``trace.json`` with known kernel intervals: two
  iterations, two streams that overlap, a memcpy, a host op that widens the
  traced window, and a second device with less busy time. Busy ms an
  iteration is the union of the busiest device's intervals (the overlap
  once), the categories sum each interval once, the top kernels and the busy
  share are what the intervals give, to float rounding (REPORT_TOL).
- The kernel names the port's card runs meet, sorted into their categories.
- A live trace from ``maybe_profile`` on the CPU: it is found and read, and
  holds no device events, so the report is None and the CLI exits 1; the
  CLI exits 0 on the hand-written trace, and takes the JAX CLI's flags.
- ``format_report``'s category and top-kernel lines are the JAX package's
  for the same numbers.
"""

import json

import pytest
import torch

from agenda_tpu.cli import profile_report as jax_cli
from agenda_tpu.utils import xprof as jax_xprof
from agenda_tpu_torch.cli import profile_report
from agenda_tpu_torch.utils import xprof
from agenda_tpu_torch.utils.profiling import maybe_profile

REPORT_TOL = 1e-9  # ms: the report's sums of the intervals below

FLASH = "void (anonymous namespace)::flash_fwd_wgmma_kernel<40, 3>((anonymous namespace)::FwdParams)"
GN = "void (anonymous namespace)::groupnorm_kernel<true>((anonymous namespace)::GnParams)"
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1"
ADD = ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
       "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)")


def _x(name, ts, dur, cat="kernel", pid=0, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur}


def _write_trace(path):
    """Two iterations on device 0 (streams 7 and 13) and a little on device 1.
    Device 0, in microseconds: flash [100, 400) and [1100, 1400); gn on stream
    13 [300, 500) (100 us over flash) and [1300, 1500); gemm [600, 700) and
    [1600, 1700); a memcpy [50, 80); an add [800, 810). Union: 30 + 400 + 100
    + 10 + 400 + 100 = 1040 us. The host op spans [0, 2000): the window."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "python3"}},
        {"ph": "M", "name": "process_labels", "pid": 0, "args": {"labels": "GPU 0"}},
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "GPU 1"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 4242, "tid": 1, "ts": 0,
         "dur": 2000},
        _x("Memcpy HtoD (Pinned -> Device)", 50, 30, cat="gpu_memcpy"),
        _x(FLASH, 100, 300), _x(GN, 300, 200, tid=13), _x(GEMM, 600, 100), _x(ADD, 800, 10),
        _x(FLASH, 1100, 300), _x(GN, 1300, 200, tid=13), _x(GEMM, 1600, 100),
        _x(GEMM, 100, 50, pid=1),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "step", "pid": 0, "tid": 7, "ts": 90,
         "dur": 1700},
    ]
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": events}))


def test_report_of_a_hand_written_trace(tmp_path):
    _write_trace(tmp_path / "trace.json")
    rep = xprof.device_op_report(str(tmp_path), iters=2, top=3)
    assert rep.plane == "GPU 0" and rep.iters == 2
    assert rep.total_ms == pytest.approx(1.040 / 2, abs=REPORT_TOL)
    assert rep.window_ms == pytest.approx(2.0, abs=REPORT_TOL)
    assert rep.busy_share == pytest.approx(1.040 / 2.0, abs=REPORT_TOL)
    cats = dict(rep.by_category)
    assert [k for k, _ in rep.by_category] == ["flash_fwd", "groupnorm", "gemm", "copy",
                                               "aten elementwise"]
    for k, ms in {"flash_fwd": 0.3, "groupnorm": 0.2, "gemm": 0.1, "copy": 0.015,
                  "aten elementwise": 0.005}.items():
        assert cats[k] == pytest.approx(ms, abs=REPORT_TOL)
    # each interval once: the sum exceeds the busy ms by the streams' overlap
    assert sum(cats.values()) - rep.total_ms == pytest.approx(0.200 / 2, abs=REPORT_TOL)
    assert [n for n, _ in rep.top_ops] == [FLASH, GN, GEMM]
    text = xprof.format_report(rep)
    assert "plane GPU 0: 0.52 ms/iter device-busy (2 iters)" in text
    assert "busy 52.0% of the traced window (2.00 ms)" in text


def test_kernel_categories():
    assert xprof.category(FLASH) == "flash_fwd"
    assert xprof.category("void (anonymous namespace)::flash_fwd_wide_kernel((anonymous "
                          "namespace)::WideParams)") == "flash_fwd"
    assert xprof.category("void (anonymous namespace)::flash_bwd_dkv_wide_kernel((anonymous "
                          "namespace)::WideBwdParams)") == "flash_bwd_dkv"
    assert xprof.category("void (anonymous namespace)::flash_bwd_dq_kernel<80>((anonymous "
                          "namespace)::BwdParams)") == "flash_bwd_dq"
    assert xprof.category("void (anonymous namespace)::fused_adamw8bit_kernel<true>(Leaves)"
                          ) == "fused_adamw"
    assert xprof.category("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
                          ) == "cudnn conv"
    assert xprof.category("cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int, 512>(...)"
                          ) == "cudnn"
    assert xprof.category("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT") == "gemm"
    assert xprof.category(ADD) == "aten elementwise"
    assert xprof.category("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
                          "at::native::MeanOps<float, float, float, float>, unsigned int, "
                          "float, 4> >(at::native::ReduceOp<float>)") == "aten reduce"
    assert xprof.category("void at::native::unrolled_elementwise_kernel<at::native::"
                          "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>"
                          "(int)") == "copy"
    assert xprof.category("Memset (Device)", "gpu_memset") == "copy"
    assert xprof.category("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, "
                          "float, float, float, at::native::(anonymous namespace)::"
                          "SoftMaxForwardEpilogue>(float*, float const*, int)"
                          ) == "cunn_SoftMaxForward"


def test_live_cpu_trace_and_the_cli(tmp_path, capsys):
    live = tmp_path / "live"
    with maybe_profile(str(live)):
        x = torch.randn(64, 64)
        (x @ x).relu().sum()
    trace = json.loads((live / "trace.json").read_text())
    assert any(ev.get("ph") == "X" for ev in trace["traceEvents"])  # host ops were traced
    assert xprof.find_trace(str(live)) == str(live / "trace.json")
    assert xprof.device_op_report(str(live)) is None  # no device events on the CPU
    assert profile_report.main([str(live)]) == 1
    assert profile_report.main([str(tmp_path / "none")]) == 1
    assert "no device trace" in capsys.readouterr().out

    (tmp_path / "hand").mkdir()
    _write_trace(tmp_path / "hand" / "trace.json")
    assert profile_report.main([str(tmp_path / "hand"), "--iters", "2", "--top", "2"]) == 0
    out = capsys.readouterr().out
    assert "-- by category --" in out and "-- top ops --" in out
    ours, theirs = vars(profile_report.parse_args(["d", "--iters", "3", "--top", "4"])), vars(
        jax_cli.parse_args(["d", "--iters", "3", "--top", "4"]))
    assert ours == theirs


def test_format_lines_are_the_jax_reports():
    cats, ops = [("flash_fwd", 3.25), ("gemm", 1.5)], [(FLASH, 3.25), (GEMM, 1.5)]
    theirs = jax_xprof.format_report(jax_xprof.OpReport("GPU 0", 4.75, 2, cats, ops))
    ours = xprof.format_report(xprof.OpReport("GPU 0", 4.75, 2, cats, ops, 0.5, 19.0))
    their_lines, our_lines = theirs.splitlines(), ours.splitlines()
    assert our_lines[0] == their_lines[0]
    assert our_lines[2:] == their_lines[1:]  # ours adds the busy-share line
