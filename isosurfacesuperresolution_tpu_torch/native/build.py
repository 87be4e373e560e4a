"""Build and load the host C++ volume readers under ``native/``.

Counterpart of the JAX package's `native/build.py`, built the way the
port's CUDA kernels are (`kernels.py`): each source is compiled by ``g++``
into a shared library with a plain C interface, loaded with ctypes, under
``build/native/`` at the repository root, named by a hash of the source
and flags, and written under a temporary name and renamed, so concurrent
processes never load a partial file.  The compiler's output is captured,
never written to the process's own streams (the render server's stderr
carries its frames).  Nothing is built when a module is imported: the
first call (or `build`) does it.

Usage: ``python -m isosurfacesuperresolution_tpu_torch.native.build``
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent.parent / "build" / "native"
# library name -> (source, its own flags): the raw decode's slice loop
# runs under OpenMP; the .vdb decode inflates zip payloads with zlib
SOURCES = {"volumeio": ("volumeio.cpp", ["-fopenmp"]),
           "vdbio": ("vdbio.cpp", ["-lz"])}
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def command(name: str, out: Path) -> list:
    src, extra = SOURCES[name]
    return ["g++", *CXX_FLAGS, str(HERE / src), "-o", str(out), *extra]


def library_path(name: str) -> Path:
    src = (HERE / SOURCES[name][0]).read_bytes()
    flags = " ".join(command(name, Path("out")))
    tag = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"{name}-{tag[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named libraries (all by default) that are not built
    yet, one ``g++`` per source, all started together.  Returns
    ``{name: seconds}`` for those built; raises OSError with the
    compiler's output if one fails (or there is no ``g++``)."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (subprocess.Popen(
            command(n, tmp), stdin=subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    done, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}: g++ exited {p.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        done[n] = time.time() - t0
    if failed:
        raise OSError("native library build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


if __name__ == "__main__":
    for n, sec in build().items():
        print(f"built {library_path(n)} in {sec:.1f}s")
