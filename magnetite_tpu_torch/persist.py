"""Case checkpoint/resume: persist mesh + BCs (+ sparsity structure) as npz
(the port's copy of magnetite_tpu/persist.py, which imports no JAX itself
but cannot be imported without the JAX package's `__init__`).

A solved-ready case (mesh arrays, BC masks, optionally the block-ELL
structure) round-trips through one compressed npz, so repeat runs skip
meshing entirely; the AMG hierarchy and the assembled operator persist
beside it (`save_amg`, `save_operator`), so a resumed compile also skips
the hierarchy build, the band structure, renumbering and the C++
assembly. The files are the JAX package's, byte for byte in schema: a
file written by either package loads in the other and reads back the
same arrays.

    save_case("case.npz", mesh, bca, metadata=md, structure=st)
    mesh, bca, md, st = load_case("case.npz")

CLI: `--save-case PATH` after meshing, `--load-case PATH` instead of
geometry files.
"""

from __future__ import annotations

import io
import os
import zipfile
from typing import Optional

import numpy as np

from .bc import BCArrays
from .config import ModelMetadata
from .errors import InputError
from .fem.assembly import EllStructure
from .meshing.core import Mesh

# v2: amg.setup_fingerprint switched its digest to sha1(mesh_state_hash +
# material) -- fingerprints stored by v1 files can never match the new
# digest for the same mesh. Only the AMG cache carries a fingerprint, so
# only it rejects v1 (a clear format error instead of a silent, and at
# scale slow, fingerprint-mismatch rebuild). Case checkpoints and
# operator caches kept their v1 schema and stay loadable: cases carry no
# hash at all, and the operator cache re-validates itself against the
# CURRENT mesh hash on load (a stale one is a cheap, explicit miss).
_FORMAT_VERSION = 3
# amg: v3 added the factored level-0 transfer arrays (fem/amg AMGSetup.fast0);
# older hierarchies would silently run the slow ELL transfer pair, so they
# rebuild once instead.
_MIN_VERSION = {"case": 1, "operator": 1, "amg": 3}


def _check_version(data: dict, kind: str, path: str) -> None:
    version = int(data.get("format_version", -1))
    if not _MIN_VERSION[kind] <= version <= _FORMAT_VERSION:
        raise InputError(
            f"{kind} file {path} has format version {version}, "
            f"expected {_MIN_VERSION[kind]}..{_FORMAT_VERSION}"
        )


def _write_npz(path: str, data: dict, compressed: bool) -> None:
    """Stream each member straight into the zip, no whole-file staging.

    Staging the whole npz in a BytesIO would transiently double host RAM
    for the operator cache (hundreds of MB at 1M elements); writing each
    array through `ZipFile.open(..., "w")` keeps numpy's serialization in
    ~16 MB buffered chunks (numpy.lib.format.write_array's non-file-object
    path), so peak extra memory is one chunk and the write stays
    CRC32 / disk bound. Matches np.savez's path semantics (appends .npz
    when missing).

    The file is written beside `path` and renamed over it: arrays read
    from the old file (`_read_npz` maps it) stay valid, where truncating
    a mapped file in place would fault their next read."""
    from numpy.lib import format as npf

    if not path.endswith(".npz"):
        path = path + ".npz"
    comp = zipfile.ZIP_DEFLATED if compressed else zipfile.ZIP_STORED
    tmp = path + ".partial"
    with zipfile.ZipFile(tmp, "w", compression=comp, allowZip64=True) as z:
        for key, val in data.items():
            arr = np.asarray(val)
            with z.open(key + ".npy", "w", force_zip64=True) as f:
                npf.write_array(f, arr, allow_pickle=False)
    os.replace(tmp, path)


def _read_npz(path: str) -> dict:
    """Load an npz as {name: array}, zero-copy for uncompressed members.

    The big payloads here (operator cache, AMG hierarchy) are saved
    STORED (uncompressed) on purpose, so their bytes can become ndarray
    views over one shared mmap of the file: no up-front read() copy, and
    pages fault in lazily -- for the operator that means the disk read
    overlaps the device upload instead of preceding it.
    Deflated members (the compressed case checkpoint) fall back to an
    in-memory inflate. Returned arrays are READ-ONLY views; every
    consumer here either uploads them or copies them."""
    import mmap as _mmap

    from numpy.lib import format as npf

    out: dict = {}
    with open(path, "rb") as f:
        mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        buf = memoryview(mm)
        with zipfile.ZipFile(f) as z:
            for info in z.infolist():
                name = info.filename
                key = name[:-4] if name.endswith(".npy") else name
                if info.compress_type == zipfile.ZIP_STORED:
                    # Data offset = local header (30 B) + name + extra.
                    # The central directory's name/extra lengths can
                    # differ from the local header's, so read the local
                    # ones (offsets 26/28) straight from the map.
                    ho = info.header_offset
                    nlen = int.from_bytes(mm[ho + 26 : ho + 28], "little")
                    elen = int.from_bytes(mm[ho + 28 : ho + 30], "little")
                    start = ho + 30 + nlen + elen
                    data = buf[start : start + info.file_size]
                else:
                    data = z.read(name)
                head = io.BytesIO(bytes(data[:4096]))
                version = npf.read_magic(head)
                # the public readers (numpy 2 dropped the private one)
                read_header = (
                    npf.read_array_header_1_0 if version == (1, 0)
                    else npf.read_array_header_2_0
                )
                shape, fortran, dtype = read_header(head)
                if dtype.hasobject or fortran:
                    out[key] = np.load(
                        io.BytesIO(bytes(data)), allow_pickle=False
                    )
                else:
                    out[key] = np.frombuffer(
                        data, dtype=dtype, offset=head.tell()
                    ).reshape(shape)
    return out


def save_case(
    path: str,
    mesh: Mesh,
    bca: BCArrays,
    metadata: Optional[ModelMetadata] = None,
    structure: Optional[EllStructure] = None,
) -> None:
    data = {
        "format_version": np.int64(_FORMAT_VERSION),
        "coords": mesh.coords,
        "tris": mesh.tris,
        "grid_shape": np.asarray(
            mesh.grid_shape if mesh.grid_shape is not None else (-1, -1),
            dtype=np.int64,
        ),
        "wrap_cols": np.bool_(mesh.wrap_cols),
        "grid_local": np.bool_(mesh.grid_local),
        "canonical_grid": np.bool_(mesh.canonical_grid),
        "u_known": bca.u_known,
        "u_value": bca.u_value,
        "f_value": bca.f_value,
    }
    if metadata is not None:
        data["metadata"] = np.asarray(
            [
                metadata.youngs_modulus,
                metadata.poisson_ratio,
                metadata.part_thickness,
                metadata.characteristic_length_min,
                metadata.characteristic_length_max,
            ],
            dtype=np.float64,
        )
    if structure is not None:
        data["ell_cols"] = structure.cols
        data["ell_slot_ids"] = structure.slot_ids
    _write_npz(path, data, compressed=True)


def save_amg(path: str, setup, values_dtype="float32") -> None:
    """Persist a fem/amg.AMGSetup (the host hierarchy build, the largest
    host cost of an unstructured compile) next to its case checkpoint; CLI
    --save-case does this automatically when the solve used the AMG
    preconditioner.

    `values_dtype` (default f32) casts the hierarchy's float arrays on
    save: halves the file, and a V-cycle PRECONDITIONER is f32-grade by
    construction -- the refined solve runs it in f32 anyway, and for plain
    f64 solves a preconditioner perturbation at 1e-7 costs at most an extra
    CG iteration, never accuracy. Pass values_dtype=None to keep f64
    values. Uncompressed: floats deflate poorly but cost seconds to
    (de)compress; `load_amg` reads either format."""
    from .fem.amg import setup_to_arrays

    data = setup_to_arrays(setup)
    if values_dtype is not None:
        vd = np.dtype(values_dtype)
        data = {
            k: v.astype(vd)
            if isinstance(v, np.ndarray) and v.dtype == np.float64
            else v
            for k, v in data.items()
        }
    _write_npz(
        path, {"format_version": np.int64(_FORMAT_VERSION), **data},
        compressed=False,
    )


def save_operator(path: str, problem) -> None:
    """Persist a CompiledProblem's assembled operator (fem/solve.
    OperatorCache): the slot-major flat stiffness values plus the format
    metadata (mode, band offsets, renumbering) keyed by the input-mesh
    hash. A matching `compile_problem(..., operator_cache=...)` skips
    structure build, renumbering, and the C++ assembly -- the resumed
    prep becomes one upload. Uncompressed on purpose: the payload is f64
    stiffness values (the symmetric d >= 0 half when the offsets allow;
    see fem/solve.OperatorCache.sym_half) that deflate poorly but cost
    seconds of (de)compression."""
    op = getattr(problem, "operator_host", None) or problem
    if not hasattr(op, "flat"):
        raise InputError(
            "problem has no host-assembled operator to save: compile with "
            "SolverOptions(keep_operator_host=True) (dense/stencil modes "
            "and the device-assembly fallback assemble in-solve and never "
            "have one)"
        )
    data = {
        "format_version": np.int64(_FORMAT_VERSION),
        "op_mesh_hash": np.asarray(op.mesh_hash),
        "op_material": np.asarray(op.material, dtype=np.float64),
        "op_mode": np.asarray(op.mode),
        "op_offsets": np.asarray(op.offsets, dtype=np.int64),
        "op_flat": op.flat,
        "op_sym_half": np.bool_(getattr(op, "sym_half", False)),
    }
    if op.cols is not None:
        data["op_cols"] = np.asarray(op.cols, dtype=np.int32)
    if op.perm is not None:
        data["op_perm"] = np.asarray(op.perm, dtype=np.int64)
    _write_npz(path, data, compressed=False)


def load_operator(path: str):
    """Load an OperatorCache saved by `save_operator`."""
    from .fem.solve import OperatorCache

    try:
        data = _read_npz(path)
    except Exception as err:
        raise InputError(f"cannot read operator cache {path}: {err}") from None
    _check_version(data, "operator", path)
    return OperatorCache(
        mesh_hash=str(data["op_mesh_hash"]),
        material=tuple(float(v) for v in data["op_material"]),
        mode=str(data["op_mode"]),
        offsets=tuple(int(o) for o in data["op_offsets"]),
        flat=data["op_flat"],
        cols=data.get("op_cols"),
        perm=data.get("op_perm"),
        sym_half=bool(data.get("op_sym_half", False)),
    )


def load_amg(path: str):
    """Load an AMGSetup saved by `save_amg`."""
    from .fem.amg import setup_from_arrays

    try:
        data = _read_npz(path)
    except Exception as err:
        raise InputError(f"cannot read AMG cache {path}: {err}") from None
    _check_version(data, "amg", path)
    return setup_from_arrays(data)


def load_case(
    path: str,
) -> tuple[Mesh, BCArrays, Optional[ModelMetadata], Optional[EllStructure]]:
    try:
        data = _read_npz(path)
    except Exception as err:
        raise InputError(f"cannot read case file {path}: {err}") from None
    _check_version(data, "case", path)
    gs = data["grid_shape"]
    mesh = Mesh(
        coords=data["coords"],
        tris=data["tris"],
        grid_shape=None if gs[0] < 0 else (int(gs[0]), int(gs[1])),
        wrap_cols=bool(data["wrap_cols"]),
        grid_local=bool(data["grid_local"]),
        # absent in pre-round-3 checkpoints: default False (safe -- only
        # disables the scatter-free assembly / stencil-sweep fast paths)
        canonical_grid=bool(data.get("canonical_grid", False)),
    )
    mesh.validate()
    bca = BCArrays(
        u_known=data["u_known"],
        u_value=data["u_value"],
        f_value=data["f_value"],
    )
    metadata = None
    if "metadata" in data:
        m = data["metadata"]
        metadata = ModelMetadata(
            youngs_modulus=float(m[0]),
            poisson_ratio=float(m[1]),
            part_thickness=float(m[2]),
            characteristic_length_min=float(m[3]),
            characteristic_length_max=float(m[4]),
        )
    structure = None
    if "ell_cols" in data:
        cols = data["ell_cols"]
        structure = EllStructure(
            cols=cols,
            slot_ids=data["ell_slot_ids"],
            n_nodes=int(cols.shape[0]),
            width=int(cols.shape[1]),
        )
    return mesh, bca, metadata, structure
