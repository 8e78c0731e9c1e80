"""ctypes bindings for the native C++ host runtime.

The host front end around the device solve (MSH parsing, band-structure
building, closed-form assembly, the AMG setup products) runs in C++. The
sources are the port's own, `magnetite_tpu_torch/_native/src/*.cpp` (copies
of the JAX package's `magnetite_tpu/_native/src/`, at the same place in
the package; `tests/test_torch_native.py` holds every exported function's
output bit-identical to the original's), compiled with g++ into
`magnetite_tpu_torch/_build/libmagnetite_native.so` on first use, again
whenever a source is newer than the library.

Unlike the JAX package there is no numpy fallback behind these wrappers:
the port's solve path requires the library, and `require()` raises a typed
`SolverError` naming the missing toolchain. Only `msh_parse` keeps the
JAX package's contract (None when unavailable), because the MSH reader has a
numpy parser of its own.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from .errors import SolverError

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_PKG_DIR, "_native", "src")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SO_PATH = os.path.join(_BUILD_DIR, "libmagnetite_native.so")
_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

_lib = None
_lib_lock = threading.Lock()
_load_error: Optional[str] = None


def _sources() -> list:
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cpp")))


def _so_current(sources) -> bool:
    try:
        so_mtime = os.path.getmtime(_SO_PATH)
    except OSError:
        return False
    return all(so_mtime > os.path.getmtime(s) for s in sources)


def build() -> float:
    """Compile the host library (atomically: concurrent test workers may race
    on the same checkout) and return the seconds it took; raises SolverError
    when the sources or g++ are missing or the compile fails."""
    from .utils.logging import span

    sources = _sources()
    if not sources:
        raise SolverError(f"native host sources not found under {_SRC_DIR}")
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise SolverError("native host library needs g++, which is not on PATH")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    took: dict = {}
    with span("native.build", took, "s"):
        proc = subprocess.run(
            [cxx, *_CXXFLAGS, *sources, "-o", tmp],
            capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            raise SolverError(
                f"native host library failed to build:\n{proc.stderr[-2000:]}"
            )
        os.replace(tmp, _SO_PATH)
    return took["s"]


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _load_error
    if _lib is not None:
        return _lib
    if _load_error is not None:
        return None
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            if not _so_current(_sources()):
                build()
            lib = ctypes.CDLL(_SO_PATH)
            _bind(lib)
        except (SolverError, OSError, AttributeError) as err:
            _load_error = str(err)
            return None
        _lib = lib
        return _lib


def require() -> ctypes.CDLL:
    """The loaded library, or a typed error naming why it is missing."""
    lib = load()
    if lib is None:
        raise SolverError(
            "the native host library is required by the PyTorch port "
            f"(no numpy assembly fallback is ported): {_load_error}"
        )
    return lib


def _bind(lib) -> None:
    """Declare every exported symbol (raises AttributeError when stale)."""
    i64 = ctypes.c_int64
    lib.msh_count.restype = ctypes.c_int
    lib.msh_count.argtypes = [
        ctypes.c_char_p, i64,
        ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.POINTER(i64),
    ]
    lib.msh_fill.restype = ctypes.c_int
    lib.msh_fill.argtypes = [
        ctypes.c_char_p, i64,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        i64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    lib.ell_structure_width.restype = i64
    lib.ell_structure_width.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        i64, i64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ]
    lib.ell_structure_fill.restype = ctypes.c_int
    lib.ell_structure_fill.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        i64, i64, i64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ]
    lib.dia_structure.restype = i64
    lib.dia_structure.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        i64, i64, i64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.amg_assemble.restype = ctypes.c_int
    lib.amg_assemble.argtypes = [
        f64p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        i64,
        f64p,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        i64p, f64p,
    ]
    lib.sort_reduce_blocks.restype = i64
    lib.sort_reduce_blocks.argtypes = [
        i64p, f64p, i64, i64, i64p, f64p,
    ]
    lib.assemble_coo_blocks.restype = i64
    lib.assemble_coo_blocks.argtypes = [
        f64p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        i64, f64p,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        i64, i64p, f64p,
    ]
    lib.coo_matvec_blocks.restype = ctypes.c_int
    lib.coo_matvec_blocks.argtypes = [
        i64p, f64p, i64, i64, i64, f64p, f64p,
    ]
    lib.smooth_prolongator_blocks.restype = i64
    lib.smooth_prolongator_blocks.argtypes = [
        i64p, f64p, i64, i64, i64, f64p, f64p, i64, i64p, i64,
        ctypes.c_double, i64p, f64p,
    ]
    lib.rap_blocks.restype = i64
    lib.rap_blocks.argtypes = [
        i64p, f64p, i64, i64, i64, i64p, f64p, i64, i64, i64,
        i64p, f64p, i64,
    ]


# ------------------------------- wrappers ----------------------------------


def msh_parse(text: str):
    """Native MSH 4.1 parse -> (coords [N,2] f64, tris [E,3] i32) or None.

    Returns None when the native library is unavailable; raises ValueError
    for malformed input the same way the numpy parser does.
    """
    lib = load()
    if lib is None:
        return None
    buf = text.encode()
    n_nodes = ctypes.c_int64()
    n_tris = ctypes.c_int64()
    max_tag = ctypes.c_int64()
    rc = lib.msh_count(
        buf, len(buf),
        ctypes.byref(n_nodes), ctypes.byref(n_tris), ctypes.byref(max_tag),
    )
    if rc == -1:
        raise ValueError("mesh file has no $Nodes section")
    if rc == -2:
        raise ValueError("mesh file has no 2D elements")
    if rc == -3:
        raise ValueError("unsupported 2D element type (only 3-node triangles)")
    if rc != 0 or n_tris.value == 0:
        raise ValueError("mesh file has no 2D elements")

    coords = np.zeros((max_tag.value, 2), dtype=np.float64)
    tags = np.zeros(n_nodes.value, dtype=np.int64)
    tris = np.zeros((n_tris.value, 3), dtype=np.int32)
    rc = lib.msh_fill(buf, len(buf), coords, tags, max_tag.value, tris)
    if rc != 0:
        raise ValueError(f"malformed mesh file (native parser code {rc})")

    if n_nodes.value != max_tag.value:
        # sparse tags: compact through the live set
        live = np.zeros(max_tag.value, dtype=bool)
        live[tags - 1] = True
        remap = -np.ones(max_tag.value, dtype=np.int64)
        remap[live] = np.arange(int(live.sum()))
        coords = coords[live]
        tris = remap[tris].astype(np.int32)
        if (tris < 0).any():
            raise ValueError("element references unknown node tag")
    return coords, tris


def ell_structure(tris: np.ndarray, n_nodes: int):
    """Block-ELL structure -> (cols [N,K] i32, slot_ids [9E] i32, width)."""
    lib = require()
    tris = np.ascontiguousarray(tris, dtype=np.int32)
    e = tris.shape[0]
    scratch = np.empty(9 * e, dtype=np.int64)
    width = lib.ell_structure_width(tris, e, n_nodes, scratch)
    if width < 0:
        raise ValueError("element node index out of range")
    cols = np.empty((n_nodes, width), dtype=np.int32)
    slot_ids = np.empty(9 * e, dtype=np.int32)
    rc = lib.ell_structure_fill(tris, e, n_nodes, width, cols, slot_ids, scratch)
    if rc != 0:
        raise ValueError(f"ELL structure build failed (code {rc})")
    return cols, slot_ids, int(width)


def amg_assemble(coords, tris, free_mask, e_mod, nu, t, slot_ids_pm, n_slots):
    """BC-masked closed-form assembly into slot-flat [n_slots, 4] storage."""
    lib = require()
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    tris = np.ascontiguousarray(tris, dtype=np.int32)
    free_mask = np.ascontiguousarray(free_mask, dtype=np.float64)
    slot_ids_pm = np.ascontiguousarray(slot_ids_pm, dtype=np.int64)
    flat = np.zeros((int(n_slots), 4), dtype=np.float64)
    lib.amg_assemble(
        coords, tris, tris.shape[0], free_mask,
        float(e_mod), float(nu), float(t), slot_ids_pm, flat,
    )
    return flat


def sort_reduce_blocks(keys: np.ndarray, vals: np.ndarray):
    """Duplicate-key block reduction -> (uniq_keys, sums)."""
    lib = require()
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    shape = vals.shape[1:]
    if keys.size == 0:
        return keys.copy(), np.empty((0,) + shape)
    flat = np.ascontiguousarray(
        vals.reshape(vals.shape[0], -1), dtype=np.float64
    )
    out_keys = np.empty(keys.size, dtype=np.int64)
    out_vals = np.empty_like(flat)
    u = lib.sort_reduce_blocks(
        keys, flat, keys.size, flat.shape[1], out_keys, out_vals
    )
    return out_keys[:u].copy(), out_vals[:u].reshape(-1, *shape).copy()


def assemble_coo_blocks(coords, tris, free_mask, e_mod, nu, t, n_nodes):
    """Direct block-COO stiffness assembly -> (keys [u] sorted,
    vals [u,2,2]) with keys = row*n + col."""
    lib = require()
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    tris = np.ascontiguousarray(tris, dtype=np.int32)
    free_mask = np.ascontiguousarray(free_mask, dtype=np.float64)
    total = 9 * tris.shape[0]
    out_keys = np.empty(max(total, 1), dtype=np.int64)
    out_vals = np.empty((max(total, 1), 4), dtype=np.float64)
    u = lib.assemble_coo_blocks(
        coords, tris, tris.shape[0], free_mask,
        float(e_mod), float(nu), float(t), int(n_nodes), out_keys, out_vals,
    )
    return out_keys[:u].copy(), out_vals[:u].reshape(-1, 2, 2).copy()


def coo_matvec_blocks(keys, vals, n, x):
    """Block-COO matvec -> y [n, m]."""
    lib = require()
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    m = vals.shape[1]
    flat = np.ascontiguousarray(vals.reshape(vals.shape[0], -1), np.float64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.empty((int(n), m), dtype=np.float64)
    lib.coo_matvec_blocks(keys, flat, keys.size, m, int(n), x, y)
    return y


def smooth_prolongator_blocks(
    a_keys, a_vals, n, diag_inv, p0, agg, n_agg, omega
):
    """P = (I - omega Dinv A) P0 -> (keys [u] = i*n_agg + a sorted,
    vals [u, m, mc])."""
    lib = require()
    a_keys = np.ascontiguousarray(a_keys, dtype=np.int64)
    m, mc = p0.shape[1], p0.shape[2]
    a_flat = np.ascontiguousarray(a_vals.reshape(a_vals.shape[0], -1), np.float64)
    di_flat = np.ascontiguousarray(diag_inv.reshape(diag_inv.shape[0], -1), np.float64)
    p0_flat = np.ascontiguousarray(p0.reshape(p0.shape[0], -1), np.float64)
    agg = np.ascontiguousarray(agg, dtype=np.int64)
    total = a_keys.size + int(n)
    out_keys = np.empty(total, dtype=np.int64)
    out_vals = np.empty((total, m * mc), dtype=np.float64)
    u = lib.smooth_prolongator_blocks(
        a_keys, a_flat, a_keys.size, m, int(n), di_flat, p0_flat, mc,
        agg, int(n_agg), float(omega), out_keys, out_vals,
    )
    return out_keys[:u].copy(), out_vals[:u].reshape(-1, m, mc).copy()


def rap_blocks(a_keys, a_vals, n, p_keys, p_vals, n_agg):
    """Galerkin C = P^T A P -> (keys [u] = b*n_agg + a sorted,
    vals [u, mc, mc])."""
    lib = require()
    a_keys = np.ascontiguousarray(a_keys, dtype=np.int64)
    p_keys = np.ascontiguousarray(p_keys, dtype=np.int64)
    m = a_vals.shape[1]
    mc = p_vals.shape[2]
    a_flat = np.ascontiguousarray(a_vals.reshape(a_vals.shape[0], -1), np.float64)
    p_flat = np.ascontiguousarray(p_vals.reshape(p_vals.shape[0], -1), np.float64)
    cap = 64 * int(n_agg) + 64
    for _ in range(3):
        out_keys = np.empty(cap, dtype=np.int64)
        out_vals = np.empty((cap, mc * mc), dtype=np.float64)
        u = lib.rap_blocks(
            a_keys, a_flat, a_keys.size, m, int(n),
            p_keys, p_flat, p_keys.size, mc, int(n_agg),
            out_keys, out_vals, cap,
        )
        if u >= 0:
            return out_keys[:u].copy(), out_vals[:u].reshape(-1, mc, mc).copy()
        cap *= 8  # pathological coarse fill: retry with more room
    raise SolverError(
        f"Galerkin product fill exceeded {cap // 8} blocks; the JAX "
        "package's chunked numpy RAP is not ported"
    )


def dia_structure(tris: np.ndarray, n_nodes: int, max_diags: int):
    """DIA structure -> (offsets [D] i64, slot_ids [9E] i32), or False if
    the mesh exceeds max_diags."""
    lib = require()
    tris = np.ascontiguousarray(tris, dtype=np.int32)
    e = tris.shape[0]
    offsets = np.empty(min(max_diags, 512), dtype=np.int64)
    slot_ids = np.empty(9 * e, dtype=np.int32)
    n_diags = lib.dia_structure(
        tris, e, n_nodes, min(max_diags, 512), offsets, slot_ids
    )
    if n_diags < 0:
        return False
    return offsets[:n_diags].copy(), slot_ids
