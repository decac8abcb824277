"""Make the JAX package's native libraries complete before any test uses
them.

hisat2_tpu/native/__init__.py builds each library with `g++ -o <final
path>` straight into the shared cache ~/.cache/hisat2_tpu_native/, with no
temporary name and no lock. Under xdist a worker that loads a library
while another worker is still writing it fails with "file too short", and
a module-scoped fixture that loses that race costs its module every test.

`ensure_jax_native()` runs once per process, while the test modules are
being collected (every worker collects every module before any test
runs): under an exclusive flock on a lock file in the cache directory it
loads each library, building it if needed. The first worker builds; the
others wait on the lock and then load finished files. A library whose
loader returns None or whose dlopen raises is dropped from the loader's
memo and from the cache, and built again, until a deadline. The port
modules that call a JAX builder or loader import this module.
"""

from __future__ import annotations

import fcntl
import os
import time

import hisat2_tpu.native as jnative

LIBS = ("sais", "kmersort", "samfmt", "dpkernel", "juncscore")
DEADLINE_S = 600.0
_done: dict = {}


def _cache_dir() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "hisat2_tpu_native")


def ensure_jax_native() -> dict:
    """Load (building where needed) every JAX native library under the
    cache lock. Returns {name: ctypes.CDLL}; raises if one still fails
    after the deadline."""
    if _done:
        return _done
    cache = _cache_dir()
    os.makedirs(cache, exist_ok=True)
    with open(os.path.join(cache, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            stop = time.monotonic() + DEADLINE_S
            for name in LIBS:
                loader = getattr(jnative, f"{name}_lib")
                while True:
                    err = None
                    try:
                        lib = loader()
                    except OSError as e:       # dlopen of a broken file
                        lib, err = None, e
                    if lib is not None:
                        _done[name] = lib
                        break
                    jnative._libs.pop(name, None)
                    so = os.path.join(cache, name + ".so")
                    if os.path.exists(so):
                        os.unlink(so)
                    if time.monotonic() > stop:
                        raise RuntimeError(
                            f"JAX native library {name} does not load: {err}")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return _done


ensure_jax_native()


def test_jax_native_libraries_load():
    libs = ensure_jax_native()
    assert sorted(libs) == sorted(LIBS)
    assert hasattr(libs["samfmt"], "finish_se_native")
    assert hasattr(libs["juncscore"], "junc_score_batch")
    assert hasattr(libs["kmersort"], "kmer_table")
    for name in LIBS:
        assert jnative._libs[name] is libs[name]
