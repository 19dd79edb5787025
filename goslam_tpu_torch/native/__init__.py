"""Host C++ helpers of the backend and the mesher, bound with ctypes.

  * ``greedy_propose``: the backend's greedy, distance-sorted edge
    proposal with NMS suppression and the loop-closing vote
    (``greedy.cpp``);
  * ``marching_cubes``: iso-surface extraction by marching tetrahedra
    with vertex deduplication (``marching.cpp``);
  * ``render_depth``: a z-buffer depth rasterizer, the occlusion oracle
    of mesh culling (``raster.cpp``).

Each library is built at first use with the host C++ compiler into
``native/build/``, named by a hash of its source, so a changed source
rebuilds; the build writes a temporary file and renames it, so processes
that build at once do not see a half-written library.  A failed build
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Dict

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_libs: Dict[str, ctypes.CDLL] = {}


class _Mesh(ctypes.Structure):
    _fields_ = [
        ("verts", ctypes.POINTER(ctypes.c_float)),
        ("n_verts", ctypes.c_int64),
        ("tris", ctypes.POINTER(ctypes.c_int32)),
        ("n_tris", ctypes.c_int64),
    ]


def build(name: str) -> str:
    """Compile ``<name>.cpp`` unless it is built; returns the library."""
    src = os.path.join(_DIR, f"{name}.cpp")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    path = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    try:
        out = subprocess.run([cxx, *CXX_FLAGS, src, "-o", tmp],
                             capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"building {name}.cpp failed: no compiler "
                           f"{cxx!r}") from e
    if out.returncode != 0:
        raise RuntimeError(f"building {name}.cpp failed:\n{out.stderr}")
    os.replace(tmp, path)
    return path


def _lib(name: str) -> ctypes.CDLL:
    if name in _libs:
        return _libs[name]
    lib = ctypes.CDLL(build(name))
    f32p = ctypes.POINTER(ctypes.c_float)
    if name == "greedy":
        f64p = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.greedy_propose.restype = ctypes.c_int64
        lib.greedy_propose.argtypes = [
            f64p, f64p,                                # d (mutated), rawd
            ctypes.c_int64, ctypes.c_int64,            # ilen, jlen
            ctypes.c_double, ctypes.c_int64,           # thresh, nms
            ctypes.c_int64, ctypes.c_int64,            # es_len0, max_factors
            ctypes.c_int32, ctypes.c_int64,            # loop, n_neigh
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # t_*_loop/start/end
            i32p, i32p, ctypes.c_int64,                # out_i, out_j, out_cap
            ctypes.POINTER(ctypes.c_int64),            # n_accepts_out
        ]
    elif name == "marching":
        lib.mc_run.restype = ctypes.POINTER(_Mesh)
        lib.mc_run.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_float]
        lib.mc_free.restype = None
        lib.mc_free.argtypes = [ctypes.POINTER(_Mesh)]
    else:
        lib.render_depth.restype = None
        lib.render_depth.argtypes = [
            f32p, ctypes.c_int64,                             # verts
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,   # tris
            f32p, ctypes.c_int64,                             # w2c, n_cams
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float,                                   # fx fy cx cy
            ctypes.c_int, ctypes.c_int,                       # H, W
            ctypes.c_float, ctypes.c_float,                   # znear, zfar
            f32p,                                             # out
        ]
    _libs[name] = lib
    return lib


def greedy_propose(d: np.ndarray, rawd: np.ndarray, thresh: float,
                   nms: int, es_len0: int, max_factors: int, loop: bool,
                   n_neigh: int, t_start_loop: int, t_start: int,
                   t_end: int):
    """Run the greedy NMS proposal scan over the candidate matrix ``d``
    ([ilen, jlen] float64, C-contiguous), which the scan mutates by
    suppression as ``utils.greedy.greedy_nms_scan`` does.  ``rawd`` is the
    unmasked distance matrix that the loop vote reads; ``es_len0`` the
    number of edges already proposed (capacity accounting).  Returns
    (pairs [N, 2] int32 of global (i, j) edges to append, the number of
    loop candidates accepted)."""
    if d.dtype != np.float64 or not d.flags.c_contiguous or d.ndim != 2:
        # the scan writes to d through a raw double*
        raise ValueError("greedy_propose needs a C-contiguous float64 "
                         f"matrix, got {d.dtype} {d.shape} "
                         f"(contiguous={d.flags.c_contiguous})")
    ilen, jlen = d.shape
    rawd = np.ascontiguousarray(rawd, np.float64) if loop else d
    if rawd.shape != d.shape:
        raise ValueError(f"greedy_propose: rawd {rawd.shape} is not "
                         f"d's {d.shape}")
    # one accept appends at most (2 n_neigh + 1)^2 pairs (loop) or 2
    # (dense), and the scan stops once the count exceeds max_factors, so
    # the last accept overshoots by at most one batch
    batch = (2 * n_neigh + 1) ** 2 if loop else 2
    cap = max(int(max_factors) - int(es_len0), 0) + batch + 8
    out_i = np.empty(cap, np.int32)
    out_j = np.empty(cap, np.int32)
    n_acc = ctypes.c_int64(0)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n = _lib("greedy").greedy_propose(
        d.ctypes.data_as(f64p), rawd.ctypes.data_as(f64p), ilen, jlen,
        float(thresh), int(nms), int(es_len0), int(max_factors),
        int(bool(loop)), int(n_neigh), int(t_start_loop), int(t_start),
        int(t_end), out_i.ctypes.data_as(i32p), out_j.ctypes.data_as(i32p),
        cap, ctypes.byref(n_acc))
    if n < 0:
        raise RuntimeError("greedy_propose: output buffer overflow")
    return np.stack([out_i[:n], out_j[:n]], axis=1), int(n_acc.value)


def marching_cubes(grid: np.ndarray, iso: float = 0.0):
    """Iso-surface of grid [nx, ny, nz]: (vertices [V, 3] float32 in voxel
    coordinates, triangles [T, 3] int32)."""
    grid = np.ascontiguousarray(grid, np.float32)
    lib = _lib("marching")
    m = lib.mc_run(grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                   grid.shape[0], grid.shape[1], grid.shape[2],
                   ctypes.c_float(iso))
    try:
        nv, nt = m.contents.n_verts, m.contents.n_tris
        verts = np.ctypeslib.as_array(m.contents.verts, shape=(nv, 3)).copy() \
            if nv else np.zeros((0, 3), np.float32)
        tris = np.ctypeslib.as_array(m.contents.tris, shape=(nt, 3)).copy() \
            if nt else np.zeros((0, 3), np.int32)
    finally:
        lib.mc_free(m)
    return verts, tris


def render_depth(verts: np.ndarray, tris: np.ndarray, w2c: np.ndarray,
                 intrinsics, H: int, W: int, znear: float = 0.001,
                 zfar: float = 20.0) -> np.ndarray:
    """Z-buffer depth of the mesh (verts [V, 3], tris [T, 3]) at each
    world-to-camera pose w2c [N, 4, 4] (+z forward); intrinsics (fx, fy,
    cx, cy).  Returns [N, H, W] float32, 0 where nothing was hit."""
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    w2c = np.ascontiguousarray(w2c, np.float32).reshape(-1, 16)
    fx, fy, cx, cy = [float(x) for x in intrinsics]
    out = np.zeros((len(w2c), H, W), np.float32)
    if len(tris) == 0 or len(w2c) == 0:
        return out
    f32p = ctypes.POINTER(ctypes.c_float)
    _lib("raster").render_depth(
        verts.ctypes.data_as(f32p), len(verts),
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(tris),
        w2c.ctypes.data_as(f32p), len(w2c),
        fx, fy, cx, cy, H, W, znear, zfar, out.ctypes.data_as(f32p))
    return out
