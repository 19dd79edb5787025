"""Build, load and launch the hand-written CUDA kernels.

Each source in ``goslam_tpu_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded
with ``ctypes``.  The build runs at first use, one ``nvcc`` per source,
all started together, into ``csrc/build/`` keyed on a hash of the source
and the flags, so a changed source rebuilds and an unchanged one loads.

Every launch function checks the C entry's ``cudaGetLastError()`` and
counts the launch in the tracer's ``launch.<name>`` (``utils.trace``,
on or off); that count is how a run shows that the main path went
through the kernel.  Nothing here is imported or built on a machine
without CUDA unless a kernel is actually launched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List

import torch

from ..utils import trace

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")
SOURCES = {"edge_system": "edge_system.cu", "alt_corr": "alt_corr.cu",
           "schur_matvec": "schur_matvec.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "--ptxas-options=-v"]

# the alt-corr kernel is written for DROID's 128-channel features
ALT_CORR_CHANNELS = 128

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# the C entry <name>_launch of each source; the last pointer is the stream
_ARGTYPES = {
    "edge_system": [_PTR] * 8 + [_INT] * 4 + [_PTR] * 7,
    "alt_corr": [_PTR] * 3 + [_INT] * 2 + [_PTR] * 3 + [_INT] * 2
    + [_PTR] * 2,
    "schur_matvec": [_PTR] * 9 + [_INT] * 4 + [_PTR] * 4,
}

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from source at first use")
    return exe


def _lib_path(name: str) -> str:
    with open(os.path.join(_CSRC, SOURCES[name]), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names: List[str] | None = None) -> Dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet,
    one nvcc process per source, all running at once.  Returns the
    library paths.  Compiler output (registers, spills) is kept next to
    each library as ``<lib>.log``."""
    names = list(SOURCES) if names is None else names
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        log = open(path + ".log", "w")
        procs[n] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, SOURCES[n])],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    for n, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            with open(paths[n] + ".log") as f:
                raise RuntimeError(f"nvcc failed for {SOURCES[n]}:\n{f.read()}")
        os.replace(tmp, paths[n])
    return paths


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        paths = build()          # first use builds every kernel at once
        lib = ctypes.CDLL(paths[name])
        fn = getattr(lib, f"{name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _libs[name] = lib
    return _libs[name]


def _check(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    trace.launch(name)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def edge_system(poses, disps, intrinsics, target, weight, ii, jj, valid,
                H, v, Eii, Eij, Cii, bz):
    """Launch csrc/edge_system.cu once on tensors the caller has checked
    (dba.check_edge_args): poses [P,7], disps [P,ht,wd], intrinsics [4],
    target/weight [E,ht,wd,2] fp32, ii/jj [E] int64, valid [E] bool,
    all contiguous on one CUDA device, into preallocated H [E,12,12],
    v [E,12], Eii/Eij [E,6,hw], Cii/bz [E,hw].  Reads only metadata on the
    host."""
    P, ht, wd = disps.shape
    E, hw = ii.shape[0], ht * wd
    if E == 0:
        return
    err = _lib("edge_system").edge_system_launch(
        _ptr(poses), _ptr(disps), _ptr(intrinsics), _ptr(target),
        _ptr(weight), _ptr(ii), _ptr(jj), _ptr(valid), P, E, hw, wd,
        _ptr(H), _ptr(v), _ptr(Eii), _ptr(Eij), _ptr(Cii), _ptr(bz),
        _stream(disps))
    _check("edge_system", err)


def alt_corr(levels, coords, ii, jj, out):
    """Launch csrc/alt_corr.cu on checked tensors: levels [T,h_l,w_l,128]
    bf16, coords [E,h,w,2] fp32, ii/jj [E] int32, out [E,h,w,L*49] fp32."""
    n = len(levels)
    ptrs = (ctypes.c_void_p * 4)(*[f.data_ptr() for f in levels],
                                 *[0] * (4 - n))
    hs = (ctypes.c_int * 4)(*[f.shape[1] for f in levels], *[0] * (4 - n))
    ws = (ctypes.c_int * 4)(*[f.shape[2] for f in levels], *[0] * (4 - n))
    E = coords.shape[0]
    P1 = coords.shape[1] * coords.shape[2]
    err = _lib("alt_corr").alt_corr_launch(
        ptrs, hs, ws, n, levels[0].shape[0], _ptr(coords), _ptr(ii),
        _ptr(jj), E, P1, _ptr(out), _stream(coords))
    _check("alt_corr", err)


def schur_matvec(x, Ei, Q, H, Eij, jj, rowptr, colptr, cidx, yf, oc, y):
    """Launch csrc/schur_matvec.cu (one cooperative launch for the whole
    matvec) on checked tensors: x [P,6], Ei [P,6,hw], Q [P,hw], H [E,12,12]
    fp32, Eij [E,6,hw] bf16, jj [E] and rowptr [P+1] int32 (edges sorted by
    source frame), colptr [P+1] and cidx [E] int32 (the valid edges by
    target frame), all contiguous on one CUDA device, into the scratch
    yf [P,6] and oc [E,6] and the output y [P,6], fp32."""
    P, _, hw = Ei.shape
    # 16-byte row loads when every row starts on a 16-byte boundary
    vec = int(hw % 8 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (Ei, Q, Eij)))
    err = _lib("schur_matvec").schur_matvec_launch(
        _ptr(x), _ptr(Ei), _ptr(Q), _ptr(H), _ptr(Eij), _ptr(jj),
        _ptr(rowptr), _ptr(colptr), _ptr(cidx), P, Eij.shape[0], hw, vec,
        _ptr(yf), _ptr(oc), _ptr(y), _stream(x))
    _check("schur_matvec", err)
