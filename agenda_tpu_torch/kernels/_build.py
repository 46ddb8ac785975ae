"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into one shared library with a plain
C interface, cached under ``agenda_tpu_torch/_build/`` by a digest of the
sources and flags, and loaded with ``ctypes``. Every pointer and the stream
cross as ``c_void_p``; every C entry returns ``cudaGetLastError()``, which
``check`` turns into a raise. Nothing here runs at import time: the CPU
tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when the cached library was loaded
    log: str  # nvcc / ptxas output of the build (registers, shared memory, spills)

    def function(self, name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
        fn = getattr(self.lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn


def find_nvcc() -> str:
    candidates = [os.path.join(os.environ[v], "bin", "nvcc")
                  for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(srcs: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(list(srcs) + list(CSRC_DIR.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(nvcc: str, srcs: Sequence[Path], out: Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in srcs:  # one nvcc per source, all at once
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run([nvcc, "-shared", *[str(o) for _, o, _ in procs], "-o",
                               str(tmp_so)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {out.name} failed:\n{link.stdout}")
        os.replace(tmp_so, out)  # atomic: a half-written library is never loaded
    log = "\n".join(logs)
    out.with_suffix(".log").write_text(log)
    return log


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (once per source digest) and load the kernel library."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    out = BUILD_DIR / f"libagenda_kernels_{_digest(srcs)}.so"
    seconds = 0.0
    if out.exists():
        log_path = out.with_suffix(".log")
        log = log_path.read_text() if log_path.exists() else ""
    else:
        t0 = time.perf_counter()
        log = _build(find_nvcc(), srcs, out)
        seconds = time.perf_counter() - t0
    return KernelLibrary(ctypes.CDLL(str(out)), out, seconds, log)


def check(rc: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error (e.g. a refused launch)."""
    if rc != 0:
        try:
            torch.cuda.check_error(rc)
        except torch.cuda.CudaError as e:
            raise RuntimeError(f"{name}: {e} (cudaError {rc})") from None
        raise RuntimeError(f"{name}: cudaError {rc}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
