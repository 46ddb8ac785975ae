"""Build and load the port's host libraries (``csrc/*.cc``) at first use.

Two shared libraries, each compiled by the host C++ compiler (``$CXX`` or
``g++``), cached under ``agenda_tpu_torch/_build/`` (beside the CUDA
kernels' library, ``kernels/_build.py``) by a digest of its sources, flags
and link libraries, and loaded with ``ctypes``:

- ``host``: ``coco_eval.cc`` (the box matchers, ``detect/native.py``) and
  ``image_ops.cc`` (the bilinear resize, HSV jitter and median,
  ``data/native_image.py``). No dependency beyond the C++ library;
- ``codecs``: ``image_codecs.cc``, the PNG and JPEG decode, linked against
  libpng, libjpeg and zlib.

A build writes to a temporary file in the cache directory and renames it
into place, so processes that build at once never load a half-written
library, and a cached library that does not load (a build directory copied
from a machine with other shared libraries) is built again. A build that
fails raises with the compiler's output; before it compiles ``codecs``, the
builder asks the preprocessor for each header the source includes, and a
missing one raises ``MissingHeaders`` naming it.
Each outcome, a library or its error, is kept for the process, so a machine
without the headers pays for the probe once. Nothing here runs at import
time.
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
from typing import Dict, Sequence, Tuple, Union

from agenda_tpu_torch.kernels._build import BUILD_DIR, CSRC_DIR

CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")


@dataclasses.dataclass(frozen=True)
class Spec:
    sources: Tuple[str, ...]
    headers: Tuple[str, ...] = ()  # system headers the sources include
    link: Tuple[str, ...] = ()


LIBRARIES: Dict[str, Spec] = {
    "host": Spec(("coco_eval.cc", "image_ops.cc")),
    "codecs": Spec(("image_codecs.cc",), headers=("png.h", "jpeglib.h", "zlib.h"),
                   link=("-lpng", "-ljpeg", "-lz")),
}
# the library each header comes with, for the messages
HEADER_LIBRARY = {"png.h": "libpng", "jpeglib.h": "libjpeg", "zlib.h": "zlib"}


class BuildError(RuntimeError):
    """A host library did not build; the message holds the compiler's output."""


class MissingHeaders(BuildError):
    """The machine lacks headers a host library includes (``self.headers``)."""

    def __init__(self, name: str, headers: Sequence[str]):
        self.headers = tuple(headers)
        libs = ", ".join(f"{HEADER_LIBRARY.get(h, h)} ({h})" for h in self.headers)
        super().__init__(f"the {name} host library cannot be built here: no headers of {libs}")


@dataclasses.dataclass
class HostLibrary:
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when the cached library was loaded

    def function(self, name: str, argtypes: Sequence, restype=ctypes.c_int):
        fn = getattr(self.lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        return fn


def find_cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise BuildError("no C++ compiler (set CXX or install g++); the host libraries "
                         "cannot be built")
    return cxx


def missing_headers(cxx: str, headers: Sequence[str]) -> Tuple[str, ...]:
    """The headers of ``headers`` that the preprocessor does not find."""
    out = []
    for h in headers:
        probe = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                               input=f"#include <cstdio>\n#include <{h}>\n", text=True,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if probe.returncode != 0:
            out.append(h)
    return tuple(out)


def _digest(spec: Spec) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + spec.link).encode())
    for name in spec.sources:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _build(name: str, spec: Spec, out: str) -> None:
    cxx = find_cxx()
    missing = missing_headers(cxx, spec.headers)
    if missing:
        raise MissingHeaders(name, missing)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-", suffix=".so")
    os.close(fd)
    try:
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, *[str(CSRC_DIR / s) for s in spec.sources],
               *spec.link]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise BuildError(f"building the {name} host library failed:\n{' '.join(cmd)}\n"
                             f"{proc.stdout}")
        os.replace(tmp, out)  # atomic: a half-written library is never loaded
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def _load(name: str) -> Union[HostLibrary, BuildError]:
    spec = LIBRARIES[name]
    out = str(BUILD_DIR / f"libagenda_{name}_{_digest(spec)}.so")
    if os.path.exists(out):
        try:
            return HostLibrary(ctypes.CDLL(out), out, 0.0)
        except OSError:  # built on another machine: its shared libraries are not here
            pass
    try:
        t0 = time.perf_counter()
        _build(name, spec, out)
    except BuildError as e:
        return e
    return HostLibrary(ctypes.CDLL(out), out, time.perf_counter() - t0)


def load(name: str) -> HostLibrary:
    """The host library ``name`` ("host" or "codecs"), built on first use;
    raises ``BuildError`` (``MissingHeaders`` for absent headers)."""
    got = _load(name)
    if isinstance(got, MissingHeaders):
        raise MissingHeaders(name, got.headers)
    if isinstance(got, BuildError):
        raise BuildError(*got.args)
    return got
