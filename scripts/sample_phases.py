#!/usr/bin/env python3
"""Where the wall time of chip_smoke.py's detector phases goes, on the card.

    python3 scripts/sample_phases.py [--families F ...] [phase ...]

Fabricates phase 17's heatmap stacks, then runs the named phases of
chip_smoke.py (det_timing, family_parity, family_cli_phase, family_timing;
all four by default) in order, over the named detector families only
(chip_smoke.FAMILIES by default), while a thread samples the main thread's
stack every 50 ms. Prints each phase's wall, then for each phase the
innermost frames that held it for 0.5 s or more and the stacks (nine
frames) that held it for 2 s or more. A wait on the card shows as the
frame that blocks on it (a convolution's cuDNN autotuning in a cold pass,
the backward of a cold step).
"""

import collections
import os
import sys
import tempfile
import threading
import time
import traceback

DT = 0.05
PHASES = ("det_timing", "family_parity", "family_cli_phase", "family_timing")


def main(argv) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("sample_phases: needs the card", file=sys.stderr)
        return 2
    if argv[:1] == ["--families"]:
        n = next((i for i, a in enumerate(argv[1:], 1) if a in PHASES), len(argv))
        cs.FAMILIES, argv = tuple(argv[1:n]), argv[n:]
    phases = argv or list(PHASES)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main_id = threading.get_ident()
    stacks, leaves, walls = collections.Counter(), collections.Counter(), {}
    tag = ["labels_fabricate"]
    stop = threading.Event()

    def sampler():
        while not stop.wait(DT):
            frame = sys._current_frames().get(main_id)
            if frame is None:
                continue
            names = [f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}"
                     for f in traceback.extract_stack(frame)]
            leaves[(tag[0], names[-1])] += 1
            stacks[(tag[0], " > ".join(names[-9:]))] += 1

    thread = threading.Thread(target=sampler, daemon=True, name="sampler")
    thread.start()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="sample_phases_") as tmp:
        root = os.path.join(tmp, "labels")
        t0 = time.perf_counter()
        labels = cs.labels_fabricate(root)
        walls["labels_fabricate"] = time.perf_counter() - t0
        for name in phases:
            tag[0] = name
            t0 = time.perf_counter()
            getattr(cs, name)(labels, root, dev)
            walls[name] = time.perf_counter() - t0
            print(f"[sample] {name}: {walls[name]:.1f} s", flush=True)
    stop.set()
    thread.join()
    for name, wall in walls.items():
        print(f"== {name} ({wall:.1f} s): innermost frames")
        for (t, frame), c in leaves.most_common():
            if t == name and c * DT >= 0.5:
                print(f"  {c * DT:7.1f} s  {frame}")
        print(f"== {name}: stacks")
        for (t, stack), c in stacks.most_common():
            if t == name and c * DT >= 2.0:
                print(f"  {c * DT:7.1f} s  {stack}")
    return 0


if __name__ == "__main__":  # spawned workers (device augmentation) re-import this file
    sys.exit(main(sys.argv[1:]))
