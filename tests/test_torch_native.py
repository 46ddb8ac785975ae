"""The JAX package's native image library, made to load before a parity test
compares pixels with the JAX package's host path.

``agenda_tpu.data.native_image._load`` builds ``native/libagenda_image.so``
with ``make`` at its first call in a process and caches the outcome for the
life of that process; on a failure the JAX dataset resizes with Pillow,
within one level of the native resize. On a fresh tree, several test
workers run that ``make`` at the same moment, and one of them can load a
half-written library and cache the failure. The port's tile resize
(``detect/dataset.py::resize_u8_host``) equals the native resize to the bit,
so a parity test that meets the Pillow path fails by one level.

``native_library`` clears that cache and loads again, a short wait apart so
that another worker's ``make`` can finish, until the library loads or
``LOAD_BOUND_S`` runs out; then it fails and says so. It never skips, and it
never switches the JAX side to Pillow. The test files that build a JAX
dataset and compare its pixels take it, module-scoped, with
``from test_torch_native import native_library``.
"""

import time

import pytest

from agenda_tpu.data import native_image

LOAD_BOUND_S = 120.0  # another worker's make of the library takes a few seconds
RETRY_WAIT_S = 0.5


def load_native_library(bound_s: float = LOAD_BOUND_S, wait_s: float = RETRY_WAIT_S) -> float:
    """Load the native library, retrying past a cached failure; the seconds it took."""
    t0 = time.monotonic()
    while True:
        native_image._load.cache_clear()
        if native_image.available():
            return time.monotonic() - t0
        if time.monotonic() - t0 > bound_s:
            pytest.fail(f"the JAX package's native image library (native/libagenda_image.so) "
                        f"did not load within {bound_s:.0f} s; the pixel-exact parity tests "
                        "need its resize")
        time.sleep(wait_s)


@pytest.fixture(scope="module")
def native_library():
    load_native_library()


def test_native_library_loads_after_a_cached_failure(monkeypatch):
    """A failure cached by ``_load`` (a half-written library, say) does not
    stick: the retry clears it and loads the library."""
    monkeypatch.setenv("AGENDA_TPU_NO_NATIVE", "1")
    native_image._load.cache_clear()
    assert not native_image.available()  # the failure, now cached
    monkeypatch.delenv("AGENDA_TPU_NO_NATIVE")
    assert not native_image.available()  # still cached
    assert load_native_library() < LOAD_BOUND_S
    assert native_image.available()
