"""Build helper for the hand-written CUDA kernels.

Each kernel source under a ``csrc/`` directory is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C
interface, loaded with `ctypes`.  The build runs at first use, into
``build/repro_torch_kernels/`` at the root of the checkout, and is
keyed by a hash of the source, the files it includes by a quoted
``#include`` (a shared ``.cuh``), and the flags, so an edited source
or header rebuilds and an unchanged one is loaded as it is.  Several
sources build in parallel (`build_all`), one ``nvcc`` each.

Nothing here runs at import time: the CPU tests import every module
of the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
_QUOTED_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def included_files(source: Path) -> List[Path]:
    """`source` and every file it pulls in by a quoted ``#include``,
    recursively, each path taken relative to the file that names it."""
    found: List[Path] = []
    todo = [Path(source)]
    while todo:
        f = todo.pop()
        if f in found:
            continue
        found.append(f)
        todo.extend(f.parent / m.decode()
                    for m in _QUOTED_INCLUDE.findall(f.read_bytes()))
    return found


def library_path(source: Path) -> Path:
    """Where the library of `source` lands: named by the source's stem
    and a hash of its text, of the files it includes, and the flags."""
    h = hashlib.sha256()
    for f in included_files(source):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def _start(source: Path) -> "tuple[subprocess.Popen, Path, Path]":
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = library_path(source)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def build_all(sources: Iterable[Path]) -> List[Path]:
    """Compile every source not yet built, all nvcc processes started
    together; returns the library paths.  The compiler's report
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside
    each library as ``<library>.log``."""
    sources = [Path(s) for s in sources]
    jobs = []
    try:
        for src in sources:
            if not library_path(src).exists():
                jobs.append((src, *_start(src)))
        for src, proc, tmp, out in jobs:
            log, _ = proc.communicate()
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
            os.replace(tmp, out)
    finally:
        for _, proc, tmp, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return [library_path(s) for s in sources]


def load_library(source: Path) -> ctypes.CDLL:
    """Build `source` if needed and load it (once per process)."""
    source = Path(source)
    key = str(source)
    lib = _LOADED.get(key)
    if lib is None:
        path, = build_all([source])
        lib = ctypes.CDLL(str(path))
        _LOADED[key] = lib
    return lib
