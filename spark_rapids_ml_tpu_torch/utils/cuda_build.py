"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``_build/<name>-<digest>.so``, then loaded
with ``ctypes``. The digest covers the source, every file under ``csrc/``
that it includes (``#include "..."``, followed recursively) and every
compiler and linker flag, so an edited source, header or flag rebuilds and
an unchanged build is reused. The build runs at first use, from the
package's own sources, never at import: the CPU test suite imports every
module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Dict, List

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# after the source, so the linker resolves the source's calls into libcuda
# (cuTensorMapEncodeTiled)
LINK_FLAGS = ("-lcuda",)

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


@dataclass
class BuildResult:
    """One kernel library: where it is, how long ``nvcc`` took (0 when the
    cached build was reused) and what ``ptxas -v`` reported (registers,
    shared memory and spills per kernel)."""

    name: str
    path: str
    seconds: float
    ptxas: str
    cached: bool


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    first ``nvcc`` on ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA toolkit is needed to build the port's kernels"
        )
    return found


def _source(name: str) -> str:
    path = os.path.join(CSRC_DIR, f"{name}.cu")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no kernel source {path}")
    return path


def build_inputs(name: str) -> List[str]:
    """``csrc/<name>.cu`` and every file it includes with quotes, directly
    or through another such file, resolved against the including file's
    directory as ``nvcc`` does. A quoted include that does not resolve
    there is not one of the package's files and is left to the compiler."""
    seen: List[str] = []
    pending = [_source(name)]
    while pending:
        path = os.path.realpath(pending.pop())
        if path in seen:
            continue
        seen.append(path)
        with open(path, encoding="utf-8") as f:
            text = f.read()
        for include in _INCLUDE.findall(text):
            candidate = os.path.join(os.path.dirname(path), include)
            if os.path.isfile(candidate):
                pending.append(candidate)
    return seen


def library_path(name: str) -> str:
    """Where the build of ``csrc/<name>.cu``, with its included files and
    the current flags, lives."""
    digest = hashlib.sha256()
    for path in build_inputs(name):
        digest.update(os.path.relpath(path, CSRC_DIR).encode() + b"\0")
        with open(path, "rb") as f:
            digest.update(f.read())
    for flag in NVCC_FLAGS + ("--",) + LINK_FLAGS:
        digest.update(flag.encode() + b"\0")
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless its current build exists. Raises
    RuntimeError with the compiler's output if ``nvcc`` fails."""
    out = library_path(name)
    if os.path.isfile(out):
        return BuildResult(name, out, 0.0, "", True)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, _source(name), *LINK_FLAGS],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return BuildResult(name, out, seconds, proc.stdout, False)


_LIBS: Dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed. Loaded once per process."""
    with _LIBS_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name).path)
            _LIBS[name] = lib
        return lib
