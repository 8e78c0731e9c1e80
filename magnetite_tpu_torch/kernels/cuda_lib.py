"""Build and load the hand-written CUDA kernels (`magnetite_tpu_torch/csrc`).

The sources compile with nvcc for Hopper (`sm_90a`) into one shared library
with a plain C interface, `magnetite_tpu_torch/_build/libmagnetite_kernels.so`,
loaded with ctypes. The build runs at first use, and again whenever a source
is newer than the library; it takes seconds because no source includes
PyTorch's headers. Nothing here runs at import time, so the CPU-only tests
import every module without nvcc.

Every C entry returns the `cudaGetLastError()` code of its launch; `check`
turns a non-zero code into a `KernelError`. There is no fallback: a CUDA
request that cannot build or launch raises. `launch` is the one way a
wrapper calls an entry: it makes the operands' device current first (the
runtime launches on the current device, and a sharded solve holds its
shards on several), passes PyTorch's current stream of that device, and
counts the launch in `launches`.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess
import threading
from collections import Counter

import torch

from ..errors import SolverError
from ..utils.logging import span

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SO_PATH = os.path.join(BUILD_DIR, "libmagnetite_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# dtype codes of the C entries
DTYPE_CODES = {torch.float32: 0, torch.float64: 1}

_lib = None
_lock = threading.Lock()

# Launches per (entry, dtype, shape) of the tensor a wrapper hands `launch`,
# e.g. ("mt_dia_matvec", torch.float64, (2, N)): the route is the entry, the
# shape that tensor's (u or r, the field the kernel works on). Counted on
# the host once the C call has returned 0, so a CUDA graph's capture, which
# runs the wrappers, counts its kernels once, and a replay, which runs no
# wrapper, counts nothing.
launches: Counter = Counter()


class KernelError(SolverError):
    """A CUDA kernel failed to build, was refused at launch, or was handed
    tensors it does not take."""


def _sources() -> list:
    return sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cu"))
        + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    )


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _current(sources) -> bool:
    try:
        so_mtime = os.path.getmtime(SO_PATH)
    except OSError:
        return False
    return all(so_mtime > os.path.getmtime(s) for s in sources)


def build() -> tuple:
    """Compile every `csrc/*.cu` into the kernel library; returns (seconds,
    nvcc's ptxas report of registers, shared memory and spills).

    One nvcc per source, all started together, then one link. Writes
    per-process temp files and renames the library into place, so
    concurrent processes never load a half-written one."""
    sources = [s for s in _sources() if s.endswith(".cu")]
    if not sources:
        raise KernelError(f"no CUDA sources under {CSRC_DIR}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    took: dict = {}
    with span("cuda.build", took, "s"):
        objs, procs = [], []
        for src in sources:
            obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
        report = []
        try:
            for src, proc in zip(sources, procs):
                _, err = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise KernelError(f"nvcc failed on {src}:\n{err[-4000:]}")
                report.append(err)
            tmp = f"{SO_PATH}.{tag}"
            link = subprocess.run(
                [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", *objs, "-o", tmp],
                capture_output=True, text=True, timeout=600,
            )
            if link.returncode != 0:
                raise KernelError(f"nvcc link failed:\n{link.stderr[-4000:]}")
            os.replace(tmp, SO_PATH)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
    return took["s"], "".join(report)


def load() -> ctypes.CDLL:
    """The kernel library, built first when missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if not _current(_sources()):
                build()
            lib = ctypes.CDLL(SO_PATH)
            _bind(lib)
            _lib = lib
    return _lib


def _bind(lib) -> None:
    vp, i32, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
    lib.mt_dia_matvec.restype = i32
    lib.mt_dia_matvec.argtypes = [i32, i32, vp, vp, i32, vp, vp, i64, vp]
    lib.mt_prolong0.restype = i32
    lib.mt_prolong0.argtypes = [i32, vp, vp, vp, vp, i64, vp]
    lib.mt_restrict0.restype = i32
    lib.mt_restrict0.argtypes = [i32, vp, vp, vp, vp, i64, i64, i32, vp]
    lib.mt_stencil_matvec.restype = i32
    lib.mt_stencil_matvec.argtypes = [i32, i32, vp, vp, vp, i32, i32, vp]
    lib.mt_mg_presmooth.restype = i32
    lib.mt_mg_presmooth.argtypes = [i32, i32, vp, vp, vp, vp, vp, i32, i32, vp]
    lib.mt_mg_postsmooth.restype = i32
    lib.mt_mg_postsmooth.argtypes = [i32, i32, vp, vp, vp, vp, vp, vp, i32, i32, vp]
    lib.mt_df_dia_matvec.restype = i32
    lib.mt_df_dia_matvec.argtypes = [vp, vp, i32, vp, vp, i64, vp]
    lib.mt_lane_dia_matvec.restype = i32
    lib.mt_lane_dia_matvec.argtypes = [i32, vp, vp, i32, vp, vp, i64, i64, vp]
    lib.mt_lane_dia_ring.restype = i32
    lib.mt_lane_dia_ring.argtypes = [
        i32, vp, vp, i32, vp, vp, i64, i64, i32, i32, i32, i32, i64, i32, vp,
    ]
    lib.mt_lane_dia_ring3.restype = i32
    lib.mt_lane_dia_ring3.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, vp, i32, vp, vp, i64, i64, i32, i32, i32, i32, i64, i32, vp,
    ]
    lib.mt_lane_dia_matvec3.restype = i32
    lib.mt_lane_dia_matvec3.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, vp, i32, vp, vp, i64, i64, vp,
    ]
    lib.mt_lane_stencil_matvec.restype = i32
    lib.mt_lane_stencil_matvec.argtypes = [i32, i32, i32, vp, vp, vp, i32, i32, i64, i32, i32, vp]
    lib.mt_lane_stencil_matvec3.restype = i32
    lib.mt_lane_stencil_matvec3.argtypes = [
        i32, i32, i32, vp, vp, vp, vp, vp, vp, i32, i32, i64, i32, i32, vp,
    ]
    lib.mt_lane_coarse_smooth3.restype = i32
    lib.mt_lane_coarse_smooth3.argtypes = [
        i32, i32, vp, vp, vp, vp, vp, vp, vp, i32, i32, i64, i32, ctypes.c_double, vp,
    ]
    lib.mt_lane_ell_matvec.restype = i32
    lib.mt_lane_ell_matvec.argtypes = [i32, i32, i32, vp, vp, vp, vp, i64, i64, i32, i64, vp]
    lib.mt_ell_matvec.restype = i32
    lib.mt_ell_matvec.argtypes = [i32, vp, vp, vp, vp, i64, i64, i32, vp]
    lib.mt_launch_floor.restype = i32
    lib.mt_launch_floor.argtypes = [vp, vp, vp]
    lib.mt_assemble_count.restype = i32
    lib.mt_assemble_count.argtypes = [vp, vp, vp, i64, i64, f64, vp, vp, vp]
    lib.mt_assemble_fill.restype = i32
    lib.mt_assemble_fill.argtypes = [vp, i64, i64, vp, vp, vp]
    lib.mt_assemble_runs.restype = i32
    lib.mt_assemble_runs.argtypes = [
        i32, vp, vp, vp, i64, i64, i64, i64, i64, f64, f64, f64, vp, vp, vp,
    ]
    lib.mt_error_string.restype = ctypes.c_char_p
    lib.mt_error_string.argtypes = [i32]


def check(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.mt_error_string(rc).decode()
        raise KernelError(f"{name} launch failed: {msg} (cudaError {rc})")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, entry: str, t: torch.Tensor, *args) -> None:
    """Call the C entry `entry(*args, stream)` with `t`'s device current
    and PyTorch's current stream there; raise KernelError on a non-zero
    return, else count it in `launches`."""
    lib = load()
    with torch.cuda.device(t.device):
        rc = getattr(lib, entry)(*args, stream_of(t))
    check(lib, rc, name)
    launches[entry, t.dtype, tuple(t.shape)] += 1


def launched(*entries: str, dtype=None, counts: Counter = None) -> int:
    """Launches of any of `entries` (of `dtype` where given) in `counts`,
    by default `launches`."""
    counts = launches if counts is None else counts
    return sum(c for (entry, dt, _), c in counts.items()
               if entry in entries and (dtype is None or dt == dtype))


def launch_floor(x: torch.Tensor) -> torch.Tensor:
    """The card's floor for one call: a kernel that copies x[0] (f32, CUDA)
    into a new one-value tensor, launched as every kernel here is."""
    y = torch.empty(1, dtype=torch.float32, device=x.device)
    launch("launch_floor", "mt_launch_floor", x, x.data_ptr(), y.data_ptr())
    return y


def require_cuda(name: str, dtype, *tensors) -> None:
    """Every operand on one CUDA device, contiguous, in a supported dtype."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise KernelError(
                f"{name}: operands must all lie on one CUDA device "
                f"(got {[str(x.device) for x in tensors]})"
            )
        if not t.is_contiguous():
            raise KernelError(f"{name}: operands must be contiguous")
    if dtype not in DTYPE_CODES:
        raise KernelError(f"{name}: dtype {dtype} is not float32/float64")
