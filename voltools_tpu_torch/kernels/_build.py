"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes``; PyTorch's headers are never
included, so a build takes seconds.  Nothing is built or loaded at import:
the first launch of a kernel builds its library.  Libraries go to
``voltools_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so a changed
source or header is rebuilt and an unchanged one is reused by later
processes.  A kernel whose layout the host also needs takes it as ``-D``
flags from its wrapper's table (``defines``), so the two never disagree.
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
from pathlib import Path

from ..utils import trace

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: dict = {}
# per source name: (seconds the build took, nvcc's output) of this process
BUILD_LOG: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def flags(defines=None) -> tuple:
    """``NVCC_FLAGS`` and a ``-D<macro>=<value>`` flag for each entry of
    ``defines`` (a mapping, or None), in the mapping's order."""
    return NVCC_FLAGS + tuple(f"-D{k}={v}"
                              for k, v in (defines or {}).items())


def library_path(name: str, defines=None) -> Path:
    """Where the library built from ``csrc/<name>.cu`` with ``defines``
    lives: named by a hash of the source, every header it may include and
    the flags."""
    digest = hashlib.sha256()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(flags(defines)).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def ptxas_usage(log: str, entry: str):
    """(registers a thread, spill store bytes) that ptxas reports in
    ``log`` (nvcc's ``-Xptxas -v`` output) for the first entry function
    whose mangled name contains ``entry``; None where the log has none."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            spill = None
            for nxt in lines[i + 1:]:
                if "Compiling entry function" in nxt:
                    break
                found = re.search(r"(\d+) bytes spill stores", nxt)
                if found:
                    spill = int(found.group(1))
                found = re.search(r"Used (\d+) registers", nxt)
                if found:
                    return int(found.group(1)), spill
            return None
    return None


def build(name: str, defines=None) -> Path:
    """Compile ``csrc/<name>.cu`` with ``defines`` unless its library is
    already built."""
    target = library_path(name, defines)
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent builders never
    # load a half-written library
    partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *flags(defines), "-o", str(partial),
           str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        partial.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(partial, target)
    BUILD_LOG[name] = (seconds, proc.stdout + proc.stderr)
    return target


def load(name: str, defines=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``defines``,
    built on first use."""
    span = trace.span("build")
    with span, _LOCK:
        lib = _LOADED.get(name)
        built = False
        if lib is None:
            before = BUILD_LOG.get(name)
            lib = ctypes.CDLL(str(build(name, defines)))
            _LOADED[name] = lib
            built = BUILD_LOG.get(name) is not before
        span.note(name=name, built=built)
        return lib
