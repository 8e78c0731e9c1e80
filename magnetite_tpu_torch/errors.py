"""Typed error hierarchy for magnetite_tpu.

Mirrors the reference's four-variant error enum and its display format
(``"{stage} error: {msg}"``, reference: src/error.rs:3-22) so CLI output and
exit behavior stay familiar, while being ordinary Python exceptions.
"""

from __future__ import annotations


class MagnetiteError(Exception):
    """Base class for all magnetite_tpu errors. Fatal by design (fail-fast)."""

    stage = "Magnetite"

    def __str__(self) -> str:  # reference: src/error.rs:12-21
        return f"{self.stage} error: {self.args[0] if self.args else ''}"


class InputError(MagnetiteError):
    """Bad user input: JSON schema, geometry files, CLI arguments."""

    stage = "Input"


class MesherError(MagnetiteError):
    """Meshing failed: gmsh subprocess, MSH parse, degenerate geometry."""

    stage = "Mesher"


class SolverError(MagnetiteError):
    """Numeric solve failed: CG divergence, singular reduced system."""

    stage = "Solver"


class PostProcessorError(MagnetiteError):
    """Output stage failed: CSV write, plotting."""

    stage = "Post Processor"
