"""SVG geometry front-end.

Extracts OUTER/INNER vertex loops from ``polyline``/``polygon``/``rect``
elements, replicating the reference's semantics (src/mesher.rs:26-244):

  * y axis inverted (SVG y grows downward; the solver plane is y-up)
  * vertices equal to any earlier vertex in the loop are dropped
  * vertices closer than `min_element_length` to the previously accepted
    vertex are dropped (count reported)
  * loop role from the element's ``id`` attribute, falling back to the
    parent's ``id``: prefix OUTER -> the single outer loop (duplicate is an
    error), prefix INNER -> appended hole, other ids -> warn + skip,
    missing id -> error
  * polylines/polygons are scanned first (document order), then rects
  * rect: x/y default to 0 with a warning; width/height required

Returns loops as a list whose first entry is the OUTER loop.
"""

from __future__ import annotations

import math
import re
import xml.etree.ElementTree as ET
from typing import Callable, Optional

import numpy as np

from ..errors import InputError

_NUM_SPLIT = re.compile(r"[\s,]+")


def _local_name(tag: str) -> str:
    """Strip the XML namespace from an element tag."""
    return tag.rsplit("}", 1)[-1]


def _parse_points(points_attr: str, min_element_length: float) -> tuple[list, int]:
    """Parse a points attribute into a deduplicated vertex loop.

    Returns (vertices, skipped_count). Vertices are (x, -y) tuples.
    """
    raw = [tok for tok in _NUM_SPLIT.split(points_attr.strip()) if tok]
    try:
        nums = [float(tok) for tok in raw]
    except ValueError:
        raise InputError("Non-float value in svg points")
    verts: list[tuple[float, float]] = []
    skipped = 0
    for i in range(0, len(nums) - 1, 2):
        v = (nums[i], -nums[i + 1])  # invert y
        if v in verts:
            continue
        if verts:
            last = verts[-1]
            if math.hypot(last[0] - v[0], last[1] - v[1]) < min_element_length:
                skipped += 1
                continue
        verts.append(v)
    return verts, skipped


def _resolve_id(
    elem: ET.Element, parent_of: dict[ET.Element, ET.Element]
) -> Optional[str]:
    item_id = elem.get("id")
    if item_id is None:
        parent = parent_of.get(elem)
        if parent is not None:
            item_id = parent.get("id")
    return item_id


class _LoopCollector:
    def __init__(self, warn: Callable[[str], None]):
        self.outer: Optional[list] = None
        self.inners: list[list] = []
        self.warn = warn

    def add(self, item_id: Optional[str], verts: list, kind: str) -> None:
        if item_id is None:
            raise InputError(f"Error in svg file. Missing id field on {kind}")
        stripped = item_id.strip()
        if stripped.startswith("INNER"):
            self.inners.append(verts)
        elif stripped.startswith("OUTER"):
            if self.outer is None:
                self.outer = verts
            else:
                raise InputError("Multiple OUTER geometries in SVG")
        else:
            self.warn(
                f"warning: skipping {kind} geometry with id {item_id}. "
                "Only supports OUTER and INNER"
            )


def parse_svg(
    svg_file: str,
    min_element_length: float = 0.0,
    log: Callable[[str], None] = print,
) -> list[np.ndarray]:
    """Parse an SVG file into vertex loops [outer, inner...], each [V,2] f64."""
    try:
        with open(svg_file, "r") as f:
            contents = f.read()
    except OSError:
        raise InputError(f"Unable to open svg file {svg_file}")

    try:
        root = ET.fromstring(contents)
    except ET.ParseError as err:
        raise InputError(f"Error in svg file: {err}")

    parent_of: dict[ET.Element, ET.Element] = {
        child: parent for parent in root.iter() for child in parent
    }

    collector = _LoopCollector(log)
    total_skipped = 0

    # Pass 1: polylines and polygons, in document order.
    for elem in root.iter():
        name = _local_name(elem.tag)
        if name not in ("polyline", "polygon"):
            continue
        points_attr = elem.get("points")
        if points_attr is None:
            raise InputError(
                f"Error in svg file. No points in polyline element "
                f"{elem.get('id')!r}"
            )
        verts, skipped = _parse_points(points_attr, min_element_length)
        total_skipped += skipped
        collector.add(_resolve_id(elem, parent_of), verts, "polyline")

    # Pass 2: rects, in document order.
    for elem in root.iter():
        if _local_name(elem.tag) != "rect":
            continue
        rect_id = elem.get("id")

        def _coord(attr: str) -> float:
            value = elem.get(attr)
            if value is None:
                log(
                    f"warning [mesh]: Missing {attr} definition in rectangle "
                    f"{rect_id!r}. Assuming zero."
                )
                return 0.0
            try:
                return float(value)
            except ValueError:
                raise InputError(
                    f"Non-float value in svg points at node {rect_id!r}"
                )

        def _size(attr: str) -> float:
            value = elem.get(attr)
            if value is None:
                raise InputError(
                    f"Error in svg file. No {attr} definition in rectangle. "
                    f"Conflicting node: {rect_id!r}"
                )
            try:
                return float(value)
            except ValueError:
                raise InputError("Non-float value in svg points")

        x, y = _coord("x"), _coord("y")
        width, height = _size("width"), _size("height")
        verts = [
            (x, -y),
            (x + width, -y),
            (x + width, -y - height),
            (x, -y - height),
        ]
        collector.add(_resolve_id(elem, parent_of), verts, "rect")

    if total_skipped > 0:
        log(f"info: skipped {total_skipped} vertices during meshing")

    if collector.outer is None:
        raise InputError("No OUTER geometry")

    loops = [collector.outer] + collector.inners
    return [np.asarray(loop, dtype=np.float64) for loop in loops]
