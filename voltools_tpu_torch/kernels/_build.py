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

The one seam between Python and a library: each wrapper declares its
:class:`Library` at import and launches through its launchers; the launch
counts and the device counters live here, and the tracer reads them.
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

import torch

from ..utils import trace

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
# per source name: (seconds the build took, nvcc's output) of this process
BUILD_LOG: dict = {}
_LIBRARIES: list = []        # every Library declared, in import order
_LAUNCHES: dict = {}         # launch count name -> launches in this process
_COUNTERS: dict = {}         # (library, counter, device index) -> tensor


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


def device_index(device) -> int:
    """The index of CUDA ``device`` (the current one for ``'cuda'``)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the kernels' counters live on a CUDA device, "
                         f"not {device}")
    return torch.cuda.current_device() if device.index is None \
        else device.index


def launches() -> dict:
    """The kernel launches of this process, by count name."""
    return dict(_LAUNCHES)


def reset_launches() -> None:
    """Set every launch count to 0."""
    _LAUNCHES.update(dict.fromkeys(_LAUNCHES, 0))


class Library:
    """``csrc/<name>.cu`` as its wrapper declares it at import: its C
    ``entries`` (name: argtypes; each returns 0 or a code that
    ``<name>_error_string`` describes), the build's ``defines`` and its
    device ``counters`` (name: (dtype, words), ``words`` an int or the
    entry that returns it)."""

    def __init__(self, name, entries, counters=None, defines=None):
        self.name, self.entries, self.defines = name, entries, defines
        self.counters, self._lib = counters or {}, None
        _LIBRARIES.append(self)

    def lib(self) -> ctypes.CDLL:
        """The library, built and loaded at its first use, entries typed."""
        if self._lib is None:
            span = trace.span("build")
            with span, _LOCK:
                if self._lib is None:
                    before = BUILD_LOG.get(self.name)
                    lib = ctypes.CDLL(str(build(self.name, self.defines)))
                    for entry, argtypes in self.entries.items():
                        fn = getattr(lib, entry)
                        fn.argtypes, fn.restype = argtypes, ctypes.c_int
                    fn = self._errors = getattr(
                        lib, f"{self.name}_error_string")
                    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
                    self._lib = lib
                    span.note(name=self.name,
                              built=BUILD_LOG.get(self.name) is not before)
        return self._lib

    def launcher(self, entry, *counts, message=None, stream=True):
        """``launch(device, *args)``: ``entry`` called with ``args`` and the
        current stream (unless not ``stream``) on ``device``, a non-zero
        code raised as ``message`` (default "<first count> launch failed:
        <text> (<code>)"), and 1 added to each of ``counts``."""
        message = message or f"{(counts or (self.name,))[0]} launch " \
            "failed: {} ({})"
        _LAUNCHES.update({name: 0 for name in counts if name not in _LAUNCHES})

        def launch(device, *args) -> None:
            fn = getattr(self._lib or self.lib(), entry)
            with torch.cuda.device(device):
                code = fn(*args, torch.cuda.current_stream().cuda_stream) \
                    if stream else fn(*args)
            if code:
                raise RuntimeError(
                    message.format(self._errors(code).decode(), code))
            for name in counts:
                _LAUNCHES[name] += 1
        return launch

    def counter(self, name, device) -> torch.Tensor:
        """Device counter ``name`` on ``device``, zeros made at first use."""
        key = (self.name, name, device_index(device))
        found = _COUNTERS.get(key)
        if found is None:
            dtype, words = self.counters[name]
            if isinstance(words, str):
                words = getattr(self.lib(), words)()
            found = _COUNTERS[key] = torch.zeros(
                words, dtype=dtype, device=torch.device("cuda", key[2]))
        return found

    def read(self, name, device="cuda") -> int:
        """Counter ``name``'s words on ``device``, summed; waits for it."""
        found = _COUNTERS.get((self.name, name, device_index(device)))
        return 0 if found is None else int(found.sum())

    def reset(self, name, device="cuda") -> None:
        """Set counter ``name`` on ``device`` to 0, in stream order."""
        found = _COUNTERS.get((self.name, name, device_index(device)))
        if found is not None:
            found.zero_()


trace.add_counters(
    lambda: {**{f"launches.{k}": n for k, n in launches().items()},
             **{f"load.{x.name}": 1 for x in _LIBRARIES if x._lib},
             **{f"build.{k}": 1 for k in list(BUILD_LOG)}},
    lambda indices: {name: sum(x.read(name, torch.device("cuda", i))
                               for i in indices)
                     for x in _LIBRARIES for name in x.counters})
