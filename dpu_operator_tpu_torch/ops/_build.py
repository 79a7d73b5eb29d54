"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object file, all
of them at once, then linked into one shared library with a plain C
interface, ``build/torch_kernels/libkernels.so`` under the repository root,
and loaded with :mod:`ctypes`. The build runs at first use and again
whenever a source changes (a content hash is kept beside the library), so
nothing is built when a module is imported and a fresh checkout builds
everything on its first kernel call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("rmsnorm.cu", "flash_attention_fwd.cu", "flash_attention_bwd.cu",
           "attention_kv8.cu", "attention_kv8_tf32.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took (0.0 when the library was reused)
build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "rmsnorm_fwd": (_I, [_P, _P, _P, _I, _I, _F, _I, _I, _I, _P]),
    "attention_fwd": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I]
                      + [_L] * 12 + [_I, _F, _I, _I, _I, _P]),
    "attention_fwd_lse": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I]
                          + [_L] * 12 + [_I, _F, _I, _I, _I, _P]),
    "attention_decode": (_I, [_P] * 6 + [_I] * 4 + [_L] * 12
                         + [_I, _F, _I, _I, _P]),
    "attention_kv8": (_I, [_P] * 7 + [_I] * 5 + [_L] * 18
                      + [_I, _F, _I, _I, _I, _I, _P]),
    "attention_bwd_dq": (_I, [_P] * 7 + [_I] * 4 + [_L] * 15
                         + [_I, _F, _F, _I, _I, _I, _P]),
    "attention_bwd_dkv": (_I, [_P] * 8 + [_I] * 4 + [_L] * 15
                          + [_I, _F, _F, _I, _I, _I, _P]),
    "launch_floor": (_I, [_P]),
    "port_error_string": (ctypes.c_char_p, [_I]),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                           "CUDA toolkit (set CUDA_HOME)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()


def _build(lib_path: Path, stamp: Path, digest: str) -> None:
    """Compile every source in parallel, then link; raise with nvcc's
    output on failure. ptxas's register / shared-memory report is kept in
    ``ptxas.txt`` beside the library, spill lines included."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs = [BUILD_DIR / (name + ".o") for name in SOURCES]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, obj in zip(SOURCES, objs)]
    reports = []
    failed = []
    for name, proc in zip(SOURCES, procs):
        out, _ = proc.communicate()
        reports.append(f"== {name}\n{out}")
        if proc.returncode:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
    (BUILD_DIR / "ptxas.txt").write_text("\n".join(reports))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    tmp = lib_path.with_suffix(".so.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    tmp.replace(lib_path)
    stamp.write_text(digest)


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first when needed."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = BUILD_DIR / "libkernels.so"
        stamp = BUILD_DIR / "libkernels.sha256"
        digest = _digest()
        if not (lib_path.exists() and stamp.exists()
                and stamp.read_text() == digest):
            t0 = time.monotonic()
            _build(lib_path, stamp, digest)
            build_seconds = time.monotonic() - t0
        lib = ctypes.CDLL(str(lib_path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error code."""
    if rc:
        msg = library().port_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
