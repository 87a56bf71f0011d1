"""Build the port's native libraries and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launch function. It is
compiled for Hopper (``sm_90a``) at first use into ``_build/`` beside
the package (listed in ``.gitignore``), under a name that carries a hash
of the source, so an edited source is never served a stale library.
:func:`build` compiles several sources in parallel, one ``nvcc`` each.

Host code takes the same route: ``native/<name>.cpp`` (the WAV reader)
is compiled with ``g++ -O3 -std=c++17 -fPIC -shared`` (``$CXX`` when
set) by :func:`build_host` and loaded by :func:`load_host`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["build", "load", "build_host", "load_host", "BUILD_DIR",
           "CSRC_DIR", "NATIVE_DIR"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
NATIVE_DIR = _PKG / "native"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra"]

_lock = threading.Lock()
_libs: dict[tuple[str, str], ctypes.CDLL] = {}  # (source dir, name)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ on a machine with the CUDA toolkit")


def _target(name: str, source: Path | None = None) -> Path:
    src = (source or CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile the named sources that are not built yet, all at once.

    Returns ``{name: library path}``. The compiler's resource report
    (``-Xptxas -v``) is kept in ``_build/<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        target = _target(name)
        out[name] = target
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    errors = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build_host(name: str) -> Path:
    """Compile ``native/<name>.cpp`` for the host unless it is built;
    returns the library's path. The compiler's output is kept in
    ``_build/<name>.log``."""
    source = NATIVE_DIR / f"{name}.cpp"
    target = _target(name, source)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build "
                           f"native/{name}.cpp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, timeout=300)
    (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for native/{name}.cpp:\n"
                           f"{proc.stderr}")
    os.replace(tmp, target)
    return target


def _load(name: str, source_dir: Path, path_of,
          signatures: dict) -> ctypes.CDLL:
    key = (source_dir.name, name)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(path_of(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[key] = lib
        return lib


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, setting
    ``argtypes``/``restype`` of each function in ``signatures``."""
    return _load(name, CSRC_DIR, lambda n: build(n)[n], signatures)


def load_host(name: str, signatures: dict) -> ctypes.CDLL:
    """:func:`load` for ``native/<name>.cpp``, built by :func:`build_host`.
    ``ctypes.CDLL`` releases the interpreter lock for each foreign call."""
    return _load(name, NATIVE_DIR, build_host, signatures)
