"""Build the package's native libraries at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under ``_build/``
(git-ignored), named by a hash of its source, the headers it includes and
the flags, so that an edited source or header is rebuilt. The host
libraries of ``HOST_SOURCES`` (the packed-data loader, the repository's
``native/dataloader.cc``) are compiled the same way by the host's C++
compiler with ``native/Makefile``'s flags; they are built for this CPU
(``-march=native``), so their name also hashes the CPU's feature flags and a
library built on another host is never loaded. Builds of several sources run
in parallel, one compiler each. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# host libraries: name -> C++ source, compiled with HOST_FLAGS (native/Makefile's)
HOST_SOURCES = {"dataloader": Path(__file__).resolve().parents[2] / "native" / "dataloader.cc"}
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17")
HOST_LINK = ("-shared", "-lpthread")

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)
_LIBS: dict[str, ctypes.CDLL] = {}
# name -> (seconds, compiler output) of the builds this process ran
BUILD_LOG: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are "
                       "built from source on a machine with the CUDA toolkit")


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("no C++ compiler found (set CXX): the packed-data loader is built "
                       "from native/dataloader.cc")


def _cpu_tag() -> str:
    """The CPU's feature flags (the ``flags`` line of /proc/cpuinfo, or the
    machine's name where there is none): what a -march=native build runs on."""
    try:
        with open("/proc/cpuinfo") as f:
            return next(line for line in f if line.startswith("flags"))
    except (OSError, StopIteration):
        return platform.machine() + " " + platform.processor()


def _source(name: str) -> Path:
    return HOST_SOURCES.get(name) or CSRC / f"{name}.cu"


def _command(name: str, out: Path) -> list[str]:
    if name in HOST_SOURCES:
        return [_cxx(), *HOST_FLAGS, str(_source(name)), "-o", str(out), *HOST_LINK]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(_source(name))]


def sources(name: str) -> list[Path]:
    """The source of ``name`` and every header beside it that it includes
    with ``#include "..."``, directly or through another header, in the
    order first reached."""
    found = [_source(name)]
    for path in found:
        for inc in _INCLUDE.findall(path.read_text()):
            header = path.parent / inc
            if header.exists() and header not in found:
                found.append(header)
    return found


def _target(name: str) -> Path:
    flags = HOST_FLAGS + HOST_LINK + (_cpu_tag(),) if name in HOST_SOURCES else NVCC_FLAGS
    h = hashlib.sha1(" ".join(flags).encode())
    for path in sources(name):
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> None:
    """Compile every named source that has no up-to-date library, all
    compilers started together. Raises on the first failure."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        # write to a private name, then rename: concurrent builders never
        # load a half-written library
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = (time.perf_counter() - t0, out)
        if proc.returncode != 0:
            failed.append(f"the build of {_source(name).name} failed (exit "
                          f"{proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``name`` (``csrc/<name>.cu`` or a host source),
    built first if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return _LIBS[name]
