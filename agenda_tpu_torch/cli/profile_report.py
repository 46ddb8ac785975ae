"""CLI: device-time report of a ``torch.profiler`` trace directory.

Counterpart of ``agenda_tpu/cli/profile_report.py``. Pair it with a
trainer's ``--profile_dir`` (``utils/profiling.maybe_profile`` writes
``trace.json`` there) or any script that exports a Chrome trace:

    python -m agenda_tpu_torch.cli.finetune_sd ... --profile_dir /tmp/trace
    python -m agenda_tpu_torch.cli.profile_report /tmp/trace --iters 20

It prints device-busy ms an iteration (the union over streams), the busy
share of the traced window, ms by kernel category and the top kernels
(``utils/xprof.py``), and exits 1 when no trace with device events is found.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Summarize a torch.profiler trace.")
    p.add_argument("trace_dir", help="Directory holding the exported trace.json")
    p.add_argument("--iters", type=int, default=1,
                   help="Iterations captured inside the trace (report is per-iter).")
    p.add_argument("--top", type=int, default=25, help="How many top kernels to list.")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from agenda_tpu_torch.utils import xprof

    args = parse_args(argv)
    rep = xprof.device_op_report(args.trace_dir, iters=args.iters, top=args.top)
    print(xprof.format_report(rep))
    return 0 if rep is not None else 1


if __name__ == "__main__":
    raise SystemExit(main())
