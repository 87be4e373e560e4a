"""Build the JAX package's native readers once, before any test loads them.

`isosurfacesuperresolution_tpu/native/vdbio.py` and `volumeio.py` compile
their shared library at import (`native/build._ensure`) straight into its
final path whenever it is missing or older than its source.  Under
pytest-xdist every worker collects every test file, so on a tree without
the libraries several workers run g++ into the same `.so` at once, and a
worker that loads it while another is still writing it gets an `OSError`
(`tests/test_vdb_spec_fixtures.py` then sets its `vdbio` to None).

Importing this module does the build the safe way, once per machine: under
an exclusive `fcntl.flock` on a lock file in `build/`, only for a library
that is missing or older than its source (`_ensure`'s own test), with the
JAX package's own command (`native.build._compile`, the same flags), into
a temporary name that is then `os.replace`d onto the final one.  A worker
that waited for the lock finds the libraries up to date and builds
nothing; a later `_ensure` finds them up to date too.

The port's test files that reach the JAX package's native readers import
this module before anything else.  They sort before `test_vdb_*.py`, and
xdist runs no test before every worker has collected, so each worker finds
the libraries built before any `_ensure` of the JAX package runs.
"""

import fcntl
import os
import subprocess

from isosurfacesuperresolution_tpu.native import build as jax_native_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK = os.path.join(ROOT, "build", "jax_native.lock")
LIBRARIES = (
    (jax_native_build.SRC, jax_native_build.OUT, ("-fopenmp",)),
    (jax_native_build.VDB_SRC, jax_native_build.VDB_OUT, ("-lz",)),
)

#: {library path: the error that stopped its build}, empty when all built
ERRORS = {}


def _stale(src: str, out: str) -> bool:
    return (not os.path.exists(out)
            or os.path.getmtime(out) < os.path.getmtime(src))


def ensure_jax_native_built() -> dict:
    """Build each stale JAX native library under the lock; returns
    `ERRORS` (a library that could not be built keeps its error)."""
    os.makedirs(os.path.dirname(LOCK), exist_ok=True)
    with open(LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for src, out, extra in LIBRARIES:
                if not _stale(src, out):
                    continue
                tmp = f"{out}.{os.getpid()}.tmp"
                try:
                    jax_native_build._compile(src, tmp, extra,
                                              verbose=False)
                    os.replace(tmp, out)
                except (OSError, subprocess.CalledProcessError) as e:
                    ERRORS[out] = repr(e)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return ERRORS


ensure_jax_native_built()
