"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds).  Libraries go to ``build/cuda/`` at the repository
root, named by a hash of the source and flags, and are written under a
temporary name and renamed, so concurrent processes never load a partial
file.  Each library's compiler output (with ``-Xptxas -v``: registers,
spills and static shared memory of every kernel) is kept beside it as
``.log``.  Nothing is built when a module is imported: the first launch (or
`build`) does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cuda"
# kernel name -> (source, its own nvcc flags).  The march keeps every
# product and sum separately rounded (--fmad=false), as in the reference's
# elementwise arithmetic; the convolutions' bf16 products are exact in
# float32, so they need no such flag.  conv3x3.cu holds B5, B6 and B7.
SOURCES = {"sweep_march": ("sweep_march.cu", ["--fmad=false"]),
           "conv3x3": ("conv3x3.cu", [])}
# flags of every source; -Xptxas -v reports registers/spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or PyTorch's idea
    of the CUDA root.  Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    roots = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        roots.append(CUDA_HOME)
    except ImportError:
        pass
    for root in roots:
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def flags(name: str) -> list:
    """The nvcc flags of kernel ``name``: the common ones and its own."""
    return NVCC_FLAGS + SOURCES[name][1]


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name][0]).read_bytes()
    tag = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{tag[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` per source, all started together.  Returns
    ``{name: {"seconds": s, "log": compiler output}}`` for those built;
    raises with the compiler's output if one fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.time()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *flags(n), "-o", str(tmp), str(CSRC / SOURCES[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    done, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exited {p.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        done[n] = {"seconds": time.time() - t0, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return done


def build_log(name: str) -> str:
    """The compiler output of kernel ``name``'s current library, as its
    build kept it ("" if it was not built here)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def ptxas_usage(log: str) -> list:
    """Per kernel entry in an ``nvcc -Xptxas -v`` log: ``{"entry": mangled
    name, "registers", "spill_stores", "spill_loads", "stack",
    "static_smem"}`` (bytes), in the log's order."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"entry": m.group(1), "registers": 0, "spill_stores": 0,
                   "spill_loads": 0, "stack": 0, "static_smem": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m.group(1)) if m else 0
    return out


def source_constant(name: str, const: str) -> int:
    """The value of ``constexpr int <const>`` in kernel ``name``'s source:
    a launch layout that tools and tests follow, read where it is set."""
    text = (CSRC / f"{name}.cu").read_text()
    m = re.search(rf"constexpr int {const} = (\d+);", text)
    if m is None:
        raise KeyError(f"{name}.cu sets no constexpr int {const}")
    return int(m.group(1))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
