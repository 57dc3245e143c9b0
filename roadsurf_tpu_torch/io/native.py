"""ctypes bindings for the native C++ data-plane library (native/).

The port's own binding of the same library as ``roadsurf_tpu/io/native.py``
(``native/roadsurf_native.cpp``, built by ``make -C native`` into
``native/libroadsurf_native.so``): the same ABI check, the same
None-when-unbuilt result of ``load`` and the same one-retry failure latch.
It is a host library: its callers fall back to the numpy implementations,
which give the same values, when it is not built; ``load(build_if_missing=
True)`` compiles it on demand with the in-repo Makefile.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libroadsurf_native.so"))

_lib = None
_load_failed = False
_retry_left = 1     # one build_if_missing retry past a cached failure: a
                    # transient failure (concurrent `make` mid-write leaving a
                    # truncated .so, first CalledProcessError) should not
                    # disable the native path for the whole process


_ABI_VERSION = 2


def load(build_if_missing: bool = False):
    """Load (optionally build) the native library; returns None if
    unavailable.  A failed build/load is cached so hot paths calling this
    per array do not re-spawn a failing `make` every time; one explicit
    ``build_if_missing=True`` call may retry past the cached failure."""
    global _lib, _load_failed, _retry_left
    if _lib is not None:
        return _lib
    if _load_failed:
        if not (build_if_missing and _retry_left > 0):
            return None
        _retry_left -= 1
        _load_failed = False
    src = os.path.join(os.path.abspath(_NATIVE_DIR), "roadsurf_native.cpp")
    stale = (os.path.exists(_LIB_PATH) and os.path.exists(src)
             and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH))
    if not os.path.exists(_LIB_PATH) or stale:
        if not (build_if_missing or stale):
            return None
        try:
            subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                           check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            _load_failed = True
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        # possibly a stale/partial artifact from a concurrent build: rebuild
        # once before latching
        if build_if_missing:
            try:
                subprocess.run(["make", "-B", "-C",
                                os.path.abspath(_NATIVE_DIR)],
                               check=True, capture_output=True)
                lib = ctypes.CDLL(_LIB_PATH)
            except (subprocess.CalledProcessError, FileNotFoundError,
                    OSError):
                _load_failed = True
                return None
        else:
            _load_failed = True
            return None
    lib.rs_version.restype = ctypes.c_int
    if lib.rs_version() != _ABI_VERSION:
        _load_failed = True
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.rs_interpolate_columns.argtypes = [
        i64p, ctypes.c_int64, i64p, i64p, ctypes.c_int64, f64p,
        ctypes.c_int64, ctypes.c_int64, f64p, i32p, f64p, ctypes.c_int32]
    lib.rs_interpolate_columns.restype = None
    lib.rs_parse_ascii_obs.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, i64p, f64p, ctypes.c_int64]
    lib.rs_parse_ascii_obs.restype = ctypes.c_int64
    lib.rs_grid_at_points.argtypes = [
        f64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, f64p, f64p,
        f64p, f64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, f64p,
        ctypes.c_int32]
    lib.rs_grid_at_points.restype = None
    _lib = lib
    return lib


def grid_at_points(field, lats, lons, plat, plon, mode: int = 0,
                   flip_y: bool = False, nthreads: int = 0):
    """Bilinear (mode 0) / nearest-valid-corner (mode 1) extraction of a
    [R, ny, nx] field at P points; returns [P, R] float64.  ``lats`` must be
    ascending; pass flip_y=True when the field rows are ordered by the
    original DESCENDING latitudes.  Requires the native library."""
    lib = load()
    assert lib is not None, "native library not available"
    field = np.ascontiguousarray(field, np.float64)
    R, ny, nx = field.shape
    lats = np.ascontiguousarray(lats, np.float64)
    lons = np.ascontiguousarray(lons, np.float64)
    plat = np.ascontiguousarray(plat, np.float64)
    plon = np.ascontiguousarray(plon, np.float64)
    P = plat.shape[0]
    out = np.empty((P, R), np.float64)
    lib.rs_grid_at_points(field.reshape(-1), R, ny, nx, lats, lons, plat,
                          plon, P, 1 if flip_y else 0, mode,
                          out.reshape(-1), nthreads)
    return out


def interpolate_columns(station_offsets, raw_times, sim_times, values,
                        miss_thresh, nearest_next, nthreads: int = 0):
    """Batched station interpolation.  values: [V, total_raw]; returns
    [nstations, V, nsim].  Requires the native library (call load())."""
    lib = load()
    assert lib is not None, "native library not available"
    station_offsets = np.ascontiguousarray(station_offsets, np.int64)
    raw_times = np.ascontiguousarray(raw_times, np.int64)
    sim_times = np.ascontiguousarray(sim_times, np.int64)
    values = np.ascontiguousarray(values, np.float64)
    miss_thresh = np.ascontiguousarray(miss_thresh, np.float64)
    nearest_next = np.ascontiguousarray(nearest_next, np.int32)
    nstations = station_offsets.shape[0] - 1
    nvars, total_raw = values.shape
    nsim = sim_times.shape[0]
    out = np.empty((nstations, nvars, nsim), np.float64)
    lib.rs_interpolate_columns(
        station_offsets, nstations, raw_times, sim_times, nsim, values,
        nvars, total_raw, miss_thresh, nearest_next, out, nthreads)
    return out


def parse_ascii_obs(text: bytes, max_rows: int = 1 << 20):
    """Parse fixed-column ASCII obs rows; returns (epochs [N], values [8, N])."""
    lib = load()
    assert lib is not None, "native library not available"
    out_epoch = np.empty(max_rows, np.int64)
    out_vals = np.empty((8, max_rows), np.float64)
    n = lib.rs_parse_ascii_obs(text, len(text), out_epoch,
                               out_vals.reshape(-1), max_rows)
    return out_epoch[:n].copy(), out_vals[:, :n].copy()
