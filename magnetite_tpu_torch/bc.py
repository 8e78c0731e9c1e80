"""Boundary-condition application: rules -> flat device-ready mask arrays.

Node lifecycle (reference: src/mesher.rs:615-624, 913-927):
  1. Birth: displacements unknown, forces known and zero.
  2. Each rule, in declaration order, overwrites ALL FOUR per-node fields for
     every node strictly inside its region box; later rules win on overlap.

Instead of Option<f64> per field we carry dense mask/value arrays -- the
static-shape, jit-friendly encoding of known/unknown:
  u_known [N,2] bool, u_value [N,2] f64  (prescribed displacement where known)
  f_value [N,2] f64                      (applied force where u unknown)
Per-axis validation guarantees exactly one of displacement/force is known
(config.parse_boundary_rules), so f_known == ~u_known always.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .config import BoundaryRule
from .utils.logging import spanned


@dataclass
class BCArrays:
    u_known: np.ndarray  # [N,2] bool
    u_value: np.ndarray  # [N,2] f64, 0 where unknown
    f_value: np.ndarray  # [N,2] f64, 0 where unknown (i.e. where u is known)

    @property
    def num_constrained(self) -> int:
        return int(self.u_known.sum())


@spanned("bc.apply")
def apply_boundary_conditions(
    coords: np.ndarray, rules: tuple[BoundaryRule, ...]
) -> BCArrays:
    """Vectorized O(N * num_rules) rule application."""
    n = coords.shape[0]
    u_known = np.zeros((n, 2), dtype=bool)
    u_value = np.zeros((n, 2), dtype=np.float64)
    f_value = np.zeros((n, 2), dtype=np.float64)

    x, y = coords[:, 0], coords[:, 1]
    for rule in rules:
        r = rule.region
        # Strict inequalities, matching reference src/mesher.rs:915-918.
        hit = (x > r.x_min) & (x < r.x_max) & (y > r.y_min) & (y < r.y_max)
        t = rule.target
        for axis, (u_t, f_t) in enumerate([(t.ux, t.fx), (t.uy, t.fy)]):
            if u_t is not None:
                u_known[hit, axis] = True
                u_value[hit, axis] = u_t
                f_value[hit, axis] = 0.0
            else:
                # force known on this axis (validation guarantees f_t set)
                u_known[hit, axis] = False
                u_value[hit, axis] = 0.0
                f_value[hit, axis] = f_t

    return BCArrays(u_known=u_known, u_value=u_value, f_value=f_value)
