"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> shared library with
a plain C interface -> ctypes).

The library is built at first use from the package's own sources into
``build/roadsurf_tpu_torch/`` at the repository root, named by a hash of the
sources and the flags, so an edited source or flag builds anew and an
unchanged one is reused.  A missing ``nvcc`` or a failed build raises; there
is no fallback.  ``nvcc -Xptxas -v`` output (registers, spills) is kept in
the ``.log`` beside the library.

``build`` and ``load`` also take another source list: a measurement builds an
earlier copy of the kernel into a library of its own beside the package's;
``build`` also takes more flags (``-lineinfo`` for ``tools/sass.py``'s
split of the SASS by source line).
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "scan_kernel.cu",)
BUILD_DIR = _PKG.parent / "build" / "roadsurf_tpu_torch"

ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = (ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-prec-div=true", "-prec-sqrt=true", "-ftz=false", "-fmad=false",
         "-Xptxas", "-v")

_LIBS: dict = {}


def nvcc_path() -> str:
    """nvcc on PATH, else the toolkit's default location; raises if none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise FileNotFoundError("nvcc not found (PATH or $CUDA_HOME/bin)")


def library_path(sources=SOURCES, extra=()) -> Path:
    h = hashlib.sha256()
    for src in map(Path, sources):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS + tuple(extra)).encode())
    return BUILD_DIR / f"libroadsurf_kernels_{h.hexdigest()[:16]}.so"


def build(sources=SOURCES, extra=()) -> dict:
    """Compile the sources (with the ``extra`` flags after FLAGS) unless
    the hashed library exists.  Returns ``{"path", "seconds", "built",
    "log"}`` (``seconds`` 0 when reused)."""
    lib = library_path(sources, extra)
    log = lib.with_suffix(".log")
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "built": False,
                "log": log.read_text() if log.exists() else ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one temporary file a process and thread: builds of one library may
    # run at once
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.{threading.get_ident()}"
                        f".tmp.so")
    cmd = [nvcc_path(), *FLAGS, *extra, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    text = res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{text}")
    log.write_text(text)
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": seconds, "built": True, "log": text}


def ptxas_usage(log: str) -> list:
    """[(kernel, registers, stack_frame, spill_stores, spill_loads)] from
    the -Xptxas -v log (sizes in bytes)."""
    usage, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, frame = m.group(1), (0, 0, 0)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = tuple(int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage.append((name, int(m.group(1))) + frame)
    return usage


def load(sources=SOURCES) -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    path = library_path(sources)
    lib = _LIBS.get(path)
    if lib is not None:
        return lib
    build(sources)
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.roadsurf_scan.argtypes = [vp] * 7 + [ci] * 6 + [vp]
    lib.roadsurf_scan.restype = ci
    lib.roadsurf_scan_slim.argtypes = [vp] * 9 + [ci] * 8 + [
        ctypes.c_float, vp]
    lib.roadsurf_scan_slim.restype = ci
    lib.roadsurf_scan_fused.argtypes = [vp] * 9 + [ci] * 7 + [
        ctypes.c_float, vp]
    lib.roadsurf_scan_fused.restype = ci
    lib.roadsurf_scan_sharded.argtypes = [vp, ci] + [vp] * 12 + [ci] * 7 + [
        ctypes.c_float, vp, vp]
    lib.roadsurf_scan_sharded.restype = ci
    lib.roadsurf_fused_info.argtypes = [vp] + [ci] * 4 + [vp]
    lib.roadsurf_fused_info.restype = ci
    lib.roadsurf_consts_size.argtypes = []
    lib.roadsurf_consts_size.restype = ci
    lib.roadsurf_fuse_args_size.argtypes = []
    lib.roadsurf_fuse_args_size.restype = ci
    lib.roadsurf_error_string.argtypes = [ci]
    lib.roadsurf_error_string.restype = ctypes.c_char_p
    from .scan_kernel import FuseArgs, ScanConsts
    mirrors = [("consts", ScanConsts), ("fuse_args", FuseArgs)]
    # K5's entries; a copy of the source from before K5 (a measurement's
    # variant) has none, one from before K5 fused no fused entry
    if hasattr(lib, "roadsurf_window"):
        from .window_kernel import WinArgs
        lib.roadsurf_window.argtypes = [vp] * 3
        lib.roadsurf_window.restype = ci
        if hasattr(lib, "roadsurf_window_fused"):
            lib.roadsurf_window_fused.argtypes = [vp] * 4
            lib.roadsurf_window_fused.restype = ci
        lib.roadsurf_win_args_size.argtypes = []
        lib.roadsurf_win_args_size.restype = ci
        mirrors.append(("win_args", WinArgs))
    for name, mirror in mirrors:
        size = getattr(lib, f"roadsurf_{name}_size")()
        if size != ctypes.sizeof(mirror):
            raise RuntimeError(
                f"{mirror.__name__} layout mismatch: C {size} bytes, "
                f"ctypes {ctypes.sizeof(mirror)}")
    _LIBS[path] = lib
    return lib


def error_string(code: int) -> str:
    return load().roadsurf_error_string(code).decode()
