"""Read a ``torch.profiler`` Chrome trace back into a device-time report.

Counterpart of ``agenda_tpu/utils/xprof.py:52-131``: ``utils/profiling.py::
maybe_profile`` writes ``trace.json``; this module reads the newest one
under a directory and reports, for the busiest device timeline:

- device-busy ms an iteration: the union of its kernel, memcpy and memset
  intervals, so time where two streams overlap counts once;
- ms an iteration by category, highest first, and the top kernels;
- the busy share of the traced window (first to last event of any kind).

Categories come from the CUDA kernel's name: the port's own kernels by
their symbol (``flash_fwd``, ``flash_bwd_dkv``, ``flash_bwd_dq``,
``fused_adamw``, ``groupnorm``), cuDNN convolutions (and cuDNN's other
kernels apart), cuBLAS/CUTLASS gemms,
ATen elementwise and reduce kernels, copies (ATen copies, ``Memcpy``,
``Memset``), and everything else by the kernel's base name (the name
without its return type, namespaces, template arguments and parameters).
The category sums add each interval once, so they exceed the busy ms only
where streams overlap. The JAX package's xplane reader has no counterpart.

    with maybe_profile(trace_dir):   # N iterations of the hot step
        ...
    print(xprof.format_report(xprof.device_op_report(trace_dir, iters=N)))
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import json
import os
import re
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # Kineto's device activity
OUR_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "fused_adamw", "groupnorm")


@dataclasses.dataclass
class OpReport:
    plane: str  # the device timeline's name
    total_ms: float  # device-busy ms an iteration (union over streams)
    iters: int
    by_category: List[Tuple[str, float]]  # (category, ms/iter), highest first
    top_ops: List[Tuple[str, float]]  # (kernel name, ms/iter), highest first
    busy_share: float  # busy time over the traced window
    window_ms: float  # the traced window, first to last event


def base_name(name: str) -> str:
    """'void ns::(anonymous namespace)::kern<4, float>(Args)' -> 'kern'."""
    head = name[5:] if name.startswith("void ") else name
    cut = len(head)
    for i, ch in enumerate(head):  # the first '<' or '(' outside '(anonymous namespace)'
        if ch in "<(" and not head.startswith("(anonymous", i):
            cut = i
            break
    head = head[:cut].replace("(anonymous namespace)", "")
    parts = [p for p in head.split("::") if p.strip()]
    return parts[-1].strip() if parts else (name.split(" ", 1)[0] or "?")


def category(name: str, cat: str = "kernel") -> str:
    """The report's category of one device event."""
    if cat in ("gpu_memcpy", "gpu_memset") or name.startswith(("Memcpy", "Memset")):
        return "copy"
    base = base_name(name)
    for ours in OUR_KERNELS:
        if base.startswith(ours):
            return ours
    low = name.lower()
    if "at::native" in name:
        if "copy" in low:
            return "copy"
        if "reduce" in low:
            return "aten reduce"
        if "elementwise" in low:
            return "aten elementwise"
    if re.search(r"conv|fprop|dgrad|wgrad", low):
        return "cudnn conv"
    if "cudnn" in low:  # batch norm and the other cuDNN kernels
        return "cudnn"
    if re.search(r"gemm|cutlass|cublas|nvjet|xmma", low):
        return "gemm"
    return base


def find_trace(trace_dir: str) -> Optional[str]:
    """The newest ``*.json`` trace under ``trace_dir``, or None."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True)
    return max(paths, key=os.path.getmtime) if paths else None


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def device_op_report(trace_dir: str, iters: int = 1, top: int = 25) -> Optional[OpReport]:
    """Aggregate the newest trace under ``trace_dir``; None without a trace
    or without device events in it (a trace taken on the CPU)."""
    path = find_trace(trace_dir)
    if path is None:
        return None
    with open(path) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
    names: Dict[object, str] = {}  # a timeline's labels ("GPU 0"), else its process name
    span = [float("inf"), float("-inf")]
    by_device: Dict[object, list] = collections.defaultdict(list)
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") in ("process_name", "process_labels"):
            args = ev.get("args", {})
            label = str(args.get("labels", args.get("name", "")))
            if label and (ev["name"] == "process_labels" or ev.get("pid") not in names):
                names[ev.get("pid")] = label
            continue
        if ev.get("ph") != "X" or "ts" not in ev:
            continue
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        span[0], span[1] = min(span[0], ts), max(span[1], ts + dur)
        if ev.get("cat") in DEVICE_CATS:
            by_device[ev.get("pid")].append(ev)

    best: Optional[OpReport] = None
    for pid, evs in by_device.items():
        busy_us = union_us([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                            for e in evs])
        if busy_us <= 0:
            continue
        cats: Dict[str, float] = collections.Counter()
        ops: Dict[str, float] = collections.Counter()
        for e in evs:
            ms = float(e.get("dur", 0.0)) / 1e3
            cats[category(e["name"], e.get("cat"))] += ms
            ops[e["name"]] += ms
        window_us = span[1] - span[0]
        rep = OpReport(
            plane=names.get(pid) or f"device {pid}",
            total_ms=busy_us / 1e3 / iters,
            iters=iters,
            by_category=[(k, v / iters) for k, v in cats.most_common()],
            top_ops=[(k, v / iters) for k, v in ops.most_common(top)],
            busy_share=busy_us / window_us if window_us > 0 else 0.0,
            window_ms=window_us / 1e3,
        )
        if best is None or rep.total_ms > best.total_ms:
            best = rep
    return best


def format_report(rep: Optional[OpReport], shape_chars: int = 110) -> str:
    if rep is None:
        return "xprof: no device trace found (no trace.json, or no device events in it)"
    lines = [
        f"plane {rep.plane}: {rep.total_ms:.2f} ms/iter device-busy ({rep.iters} iters)",
        f"busy {100.0 * rep.busy_share:.1f}% of the traced window ({rep.window_ms:.2f} ms)",
        "-- by category --",
    ]
    for cat, ms in rep.by_category[:20]:
        lines.append(f"  {ms:9.3f} ms  {ms / rep.total_ms * 100:5.1f}%  {cat}")
    lines.append("-- top ops --")
    for name, ms in rep.top_ops:
        lines.append(f"  {ms:9.3f} ms  {ms / rep.total_ms * 100:5.1f}%  {name[:shape_chars]}")
    return "\n".join(lines)
