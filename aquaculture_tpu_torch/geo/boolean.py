"""Exact boolean overlay for arbitrary simple polygons (GEOS overlay
replacement), a copy of aquaculture_tpu/geo/boolean.py. Each lattice sweep
runs on one of two engines of the same algorithm: "c++" (the default;
csrc/booleanop.cc through geo/native_boolean.py, built at first use) or
"python" (this module's sweep). ``set_sweep_engine`` or
``using_sweep_engine`` chooses; with neither, ``AQUAGEO_NO_NATIVE=1`` (the
JAX package's switch) selects "python". Nothing falls back from one engine
to the other: a library that does not build raises.

Implements the Martinez–Rueda–Feito sweep-line boolean algorithm
(F. Martinez et al., "A simple algorithm for Boolean operations on
polygons", Adv. Eng. Software 2013): a plane sweep subdivides both
operands' edges at every intersection, classifies each subdivided edge by
the op (intersection / union / difference / xor), and reconnects the
selected edges into output contours with correct hole nesting. Handles
non-convex operands, holes, multipolygons, and the degenerate cases the
2013 paper covers explicitly (shared vertices, vertex-on-edge, collinear
overlapping edges — the pixel-aligned geometry this pipeline produces).

This finishes the geometry engine: the reference gets these ops from GEOS
(gpd.overlay in reference src/utils.py:241-273, polygon dissection in
src/load_data/create_land_filter.py:129-137, unary_union in
src/utils_tonnage.py:617,1165). Rectilinear operands keep the exact
integer-free Region algebra fast path in geo/polygon.py; this module is
the general-operand path.

Coordinates are Python floats; orientation tests are plain double
arithmetic (same robustness class as the published algorithm). The fuzz
suite cross-checks against the signed-triangle-soup areas
(geo/triangulate.py) and the 2048px raster oracle.
"""

from __future__ import annotations

import contextlib
import heapq
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from aquaculture_tpu_torch.geo import polygon as _poly

# Operations
INTERSECTION = 0
UNION = 1
DIFFERENCE = 2
XOR = 3

_OPS = {
    "intersection": INTERSECTION,
    "union": UNION,
    "difference": DIFFERENCE,
    "xor": XOR,
}

# Sweep engines: the C++ library (geo/native_boolean.py) or this module's
# Python sweep. None = not set: "c++" unless AQUAGEO_NO_NATIVE is set.
SWEEP_ENGINES = ("c++", "python")
_sweep_engine: Optional[str] = None


def sweep_engine() -> str:
    """The engine that lattice sweeps run on now."""
    if _sweep_engine is not None:
        return _sweep_engine
    return "python" if os.environ.get("AQUAGEO_NO_NATIVE") else "c++"


def set_sweep_engine(engine: Optional[str]) -> Optional[str]:
    """Set the process's sweep engine ("c++" or "python"; None returns to
    the default) and return the previous setting."""
    global _sweep_engine
    if engine is not None and engine not in SWEEP_ENGINES:
        raise ValueError(f"unknown sweep engine {engine!r}; one of {SWEEP_ENGINES}")
    previous, _sweep_engine = _sweep_engine, engine
    return previous


@contextlib.contextmanager
def using_sweep_engine(engine: str):
    """Run the body's sweeps on ``engine``, then restore the setting."""
    previous = set_sweep_engine(engine)
    try:
        yield
    finally:
        set_sweep_engine(previous)


# Edge annotation for overlapping collinear segments
_NORMAL = 0
_NON_CONTRIBUTING = 1
_SAME_TRANSITION = 2
_DIFFERENT_TRANSITION = 3


def _signed_area(p0, p1, p2) -> float:
    return (p0[0] - p2[0]) * (p1[1] - p2[1]) - (p1[0] - p2[0]) * (p0[1] - p2[1])


def _sa_snap(p0, p1, p2) -> float:
    """Orientation of p2 vs segment p0->p1, snapped to 0 inside the lattice
    noise band.

    All sweep coordinates are integers, but segment SPLIT points are rounded
    to the lattice and may sit up to ~1 unit off their true line (and the
    base segment's own endpoints may be rounded split points too). |sa| =
    perp_distance x |p1-p0|, so anything within a few units x |p1-p0| is
    quantization residue, not a real side: treat it as collinear. Points
    genuinely off the line by more than ~3 lattice units (~1e-7 of the
    operand span) are classified exactly."""
    sa = _signed_area(p0, p1, p2)
    tol = 3.0 * (abs(p1[0] - p0[0]) + abs(p1[1] - p0[1]))
    return 0.0 if -tol <= sa <= tol else sa


_EVENT_COUNTER = iter(range(1 << 62))


class _SweepEvent:
    __slots__ = (
        "point", "left", "other", "is_subject", "type", "in_out",
        "other_in_out", "prev_in_result", "result_transition", "pos",
        "contour_id", "output_contour_id", "sid", "touch_requeues",
    )

    def __init__(self, point, left, other, is_subject):
        self.point = point
        self.left = left
        self.other: Optional[_SweepEvent] = other
        self.is_subject = is_subject
        self.type = _NORMAL
        self.in_out = False
        self.other_in_out = False
        self.prev_in_result: Optional[_SweepEvent] = None
        self.result_transition = 0        # +1 out->in, -1 in->out, 0 not in result
        self.pos = 0
        self.contour_id = 0
        self.output_contour_id = -1
        self.sid = next(_EVENT_COUNTER)   # total-order tiebreak (see _compare_events)
        self.touch_requeues = 0           # see the tangential-touch requeue in _subdivide

    @property
    def in_result(self) -> bool:
        return self.result_transition != 0

    def is_below(self, p) -> bool:
        if self.left:
            return _sa_snap(self.point, self.other.point, p) > 0
        return _sa_snap(self.other.point, self.point, p) > 0

    def is_above(self, p) -> bool:
        return not self.is_below(p)

    def is_vertical(self) -> bool:
        return self.point[0] == self.other.point[0]

    # heapq ordering (priority queue of events, x-then-y sweep order)
    def __lt__(self, other: "_SweepEvent") -> bool:
        return _compare_events(self, other) < 0


def _compare_events(e1: _SweepEvent, e2: _SweepEvent) -> int:
    """Sweep processing order: smaller x first; ties by y; right endpoints
    before left; bottom segment first; subject before clipping.

    This MUST be a strict total order: _order_events sorts with it, the
    C++ port feeds it to std::stable_sort (UB on non-strict-weak orders),
    and an inconsistent comparator made the old exchange sort cycle
    forever (hit by a ring x sub-lattice-width sliver,
    tests/test_boolean.py::test_ring_sliver_degenerate_terminates).

    Transitivity argument: all event coordinates live on the integer
    lattice (boolean_op snaps operands; splits round), so _signed_area is
    EXACT (|cross| <= 2^52) and the orientation branch uses it with NO
    snap band — a band makes "collinear" non-transitive (A~B, B~C but
    A<C). Both events here share a point and a left flag, so their other
    endpoints lie in one half-plane; exact cross-sign ordering over a
    half-plane is a transitive angular order. Exact collinearity falls to
    discrete keys (subject, other-endpoint lex — distance along the shared
    ray — contour id, serial id), never a constant."""
    if e1 is e2:
        return 0
    p1, p2 = e1.point, e2.point
    if p1[0] > p2[0]:
        return 1
    if p1[0] < p2[0]:
        return -1
    if p1[1] != p2[1]:
        return 1 if p1[1] > p2[1] else -1
    if e1.left != e2.left:
        return 1 if e1.left else -1
    o1, o2 = e1.other.point, e2.other.point
    sa = _signed_area(p1, o1, o2)
    if sa != 0.0:
        # bottom segment first (same convention as the original: e1 first
        # when e2's other endpoint lies above e1's segment). For right
        # events the segment runs other->point, which negates the
        # orientation.
        below = sa > 0 if e1.left else sa < 0
        return 1 if not below else -1
    if e1.is_subject != e2.is_subject:
        return 1 if not e1.is_subject else -1
    if o1 != o2:
        return 1 if (o1[0], o1[1]) > (o2[0], o2[1]) else -1
    if e1.contour_id != e2.contour_id:
        return 1 if e1.contour_id > e2.contour_id else -1
    return 1 if e1.sid > e2.sid else -1


def _compare_segments(le1: _SweepEvent, le2: _SweepEvent) -> int:
    """Status-line (sweep line) vertical order of two left events."""
    if le1 is le2:
        return 0
    if (
        _sa_snap(le1.point, le1.other.point, le2.point) != 0
        or _sa_snap(le1.point, le1.other.point, le2.other.point) != 0
    ):
        # Not collinear
        if le1.point == le2.point:
            return -1 if le1.is_below(le2.other.point) else 1
        if le1.point[0] == le2.point[0]:
            return -1 if le1.point[1] < le2.point[1] else 1
        if _compare_events(le1, le2) == 1:
            # le1 inserted after le2: le1.point is the current sweep point.
            # If it lies ON segment le2 (vertex-on-edge degeneracy, up to
            # lattice noise) the segments diverge rightward — order by
            # le1's right end.
            if _sa_snap(le2.point, le2.other.point, le1.point) == 0:
                return -1 if le2.is_above(le1.other.point) else 1
            return -1 if le2.is_above(le1.point) else 1
        # le2 inserted after le1: symmetric degeneracy check.
        if _sa_snap(le1.point, le1.other.point, le2.point) == 0:
            return -1 if le1.is_below(le2.other.point) else 1
        return -1 if le1.is_below(le2.point) else 1
    # Collinear
    if le1.is_subject == le2.is_subject:
        if le1.point == le2.point:
            if le1.other.point == le2.other.point:
                # Exactly coincident same-operand segments exist since the
                # interior-seam subdivision (members abutting along part of
                # an edge). Distinct objects MUST order strictly — a 0 here
                # makes the status line insert/remove the WRONG one and the
                # sweep silently corrupts.
                if le1.contour_id != le2.contour_id:
                    return 1 if le1.contour_id > le2.contour_id else -1
                return 1 if le1.sid > le2.sid else -1
            if le1.contour_id != le2.contour_id:
                return 1 if le1.contour_id > le2.contour_id else -1
            return 1 if _compare_events(le1, le2) == 1 else -1
    else:
        return -1 if le1.is_subject else 1
    return 1 if _compare_events(le1, le2) == 1 else -1


def _segment_intersection(a1, a2, b1, b2) -> List[Tuple[float, float]]:
    """0, 1 or 2 intersection points of segments [a1,a2] and [b1,b2];
    endpoints snap exactly to the input tuples.

    Collinearity is decided with the SAME lattice-noise band as the
    comparator (_sa_snap), not exact cross products: rounding the
    endpoints of exactly-collinear DIAGONAL segments bends them ~1 unit,
    and an exact parallelism test then routes them to the crossing branch,
    whose position error is amplified 1/sin(theta) — unbounded for these
    near-parallel pairs (a fuzz finding: two triangles with
    partially overlapping diagonal edges returned UNION = EMPTY). The band
    test uses the longer segment's line (a short split piece's own line
    direction is rounding noise)."""
    va = (a2[0] - a1[0], a2[1] - a1[1])
    vb = (b2[0] - b1[0], b2[1] - b1[1])
    e = (b1[0] - a1[0], b1[1] - a1[1])
    kross = va[0] * vb[1] - va[1] * vb[0]
    if abs(va[0]) + abs(va[1]) >= abs(vb[0]) + abs(vb[1]):
        collinear = _sa_snap(a1, a2, b1) == 0.0 and _sa_snap(a1, a2, b2) == 0.0
    else:
        collinear = _sa_snap(b1, b2, a1) == 0.0 and _sa_snap(b1, b2, a2) == 0.0
    if not collinear:
        if kross == 0.0:
            return []  # parallel, outside the collinearity band
        s = (e[0] * vb[1] - e[1] * vb[0]) / kross
        if s < 0.0 or s > 1.0:
            return []
        t = (e[0] * va[1] - e[1] * va[0]) / kross
        if t < 0.0 or t > 1.0:
            return []
        if s == 0.0:
            return [a1]
        if s == 1.0:
            return [a2]
        if t == 0.0:
            return [b1]
        if t == 1.0:
            return [b2]
        return [(a1[0] + s * va[0], a1[1] + s * va[1])]
    # Collinear (within band): overlap interval in a's parameterization
    len2 = va[0] * va[0] + va[1] * va[1]
    if len2 == 0.0:
        return []
    s0 = (e[0] * va[0] + e[1] * va[1]) / len2
    s1 = s0 + (vb[0] * va[0] + vb[1] * va[1]) / len2
    smin, smax = min(s0, s1), max(s0, s1)
    lo, hi = max(0.0, smin), min(1.0, smax)
    if lo > hi:
        return []

    def _pt(s):
        if s == 0.0:
            return a1
        if s == 1.0:
            return a2
        if s == s0:
            return b1
        if s == s1:
            return b2
        return (a1[0] + s * va[0], a1[1] + s * va[1])

    if lo == hi:
        return [_pt(lo)]
    return [_pt(lo), _pt(hi)]


def _divide_segment(se: _SweepEvent, p, queue: list) -> None:
    """Split the segment of left event se at interior point p."""
    r = _SweepEvent(p, False, se, se.is_subject)
    l = _SweepEvent(p, True, se.other, se.is_subject)
    r.contour_id = l.contour_id = se.contour_id
    if _compare_events(l, se.other) > 0:
        # Rounding pushed the new left event past the right end: flip so
        # processing order stays consistent (known Martinez fix).
        se.other.left = True
        l.left = False
    se.other.other = l
    se.other = r
    heapq.heappush(queue, l)
    heapq.heappush(queue, r)


def _possible_intersection(se1: _SweepEvent, se2: _SweepEvent, queue: list) -> int:
    inter = _segment_intersection(se1.point, se1.other.point, se2.point, se2.other.point)
    n = len(inter)
    if n == 0:
        return 0
    if n == 1 and (se1.point == se2.point or se1.other.point == se2.other.point):
        return 0  # segments share an endpoint only
    same_operand = se1.is_subject == se2.is_subject
    # n == 2 with same_operand is NOT ignorable: a MultiPolygon whose
    # members abut along part of an edge (exactly what region.to_geometry
    # used to emit for staircase dissolves) puts two collinear overlapping
    # edges in ONE operand. Skipping them leaves the overlap unsubdivided,
    # so parity flips at misaligned points and union/difference silently
    # corrupt (the partial-abutment bug). The overlap machinery
    # below subdivides them like cross-operand overlaps; the left-coincide
    # branch then marks the coincident portion as an interior seam.
    if n == 1:
        # Snap the computed crossing to the integer lattice the operands
        # live on (see boolean_op): the rounded point stays strictly inside
        # each segment's bbox, and a crossing that rounds onto an endpoint
        # becomes a vertex-on-edge touch handled by the != checks below.
        p = (round(inter[0][0]), round(inter[0][1]))
        if se1.point != p and se1.other.point != p and se2.point != p and se2.other.point != p:
            # Vertex-on-edge: an endpoint of one segment lying within 2
            # PERPENDICULAR lattice units of the other segment (inside its
            # span) IS the crossing. Endpoint rounding displaces the
            # computed line-line crossing by O(1/sin theta) units — the
            # a semantic-fuzz finding was a triangle vertex exactly
            # on the clipping edge whose crossing landed 3 units away, so
            # the walk dead-ended on the identity mismatch and UNION
            # returned EMPTY. A Chebyshev window on p cannot fix this
            # (any window wide enough also bridges sub-lattice slivers,
            # e.g. the 2.85-unit ring sliver regression); the perp test is
            # scale-free and leaves genuine nearby crossings alone.
            best = None
            best_d = 2.0  # max perpendicular distance, lattice units
            for q, r0, r1 in (
                (se1.point, se2.point, se2.other.point),
                (se1.other.point, se2.point, se2.other.point),
                (se2.point, se1.point, se1.other.point),
                (se2.other.point, se1.point, se1.other.point),
            ):
                dx, dy = r1[0] - r0[0], r1[1] - r0[1]
                len2 = dx * dx + dy * dy
                if len2 == 0.0:
                    continue
                sa = (r0[0] - q[0]) * (r1[1] - q[1]) - (r1[0] - q[0]) * (r0[1] - q[1])
                d = abs(sa) / (len2 ** 0.5)
                if d > best_d:
                    continue
                t = (q[0] - r0[0]) * dx + (q[1] - r0[1]) * dy
                slack = 2.0 * len2 ** 0.5
                if -slack <= t <= len2 + slack:
                    best, best_d = q, d
            if best is not None:
                p = best
            else:
                # A crossing within lattice noise of an existing endpoint
                # IS that endpoint (rounded split points shift the
                # computed position by ~1 unit). Snapping keeps point
                # identity exact for the contour-connect phase.
                for q in (se1.point, se1.other.point, se2.point, se2.other.point):
                    if abs(p[0] - q[0]) <= 2.0 and abs(p[1] - q[1]) <= 2.0:
                        p = q
                        break
        if se1.point != p and se1.other.point != p:
            _divide_segment(se1, p, queue)
        if se2.point != p and se2.other.point != p:
            _divide_segment(se2, p, queue)
        return 1

    # The segments overlap (collinear; opposite operands, or an interior
    # seam between members of one operand)
    events: List[_SweepEvent] = []
    left_coincide = se1.point == se2.point
    right_coincide = se1.other.point == se2.other.point
    if not left_coincide:
        if _compare_events(se1, se2) > 0:
            events.extend([se2, se1])
        else:
            events.extend([se1, se2])
    if not right_coincide:
        if _compare_events(se1.other, se2.other) > 0:
            events.extend([se2.other, se1.other])
        else:
            events.extend([se1.other, se2.other])

    if left_coincide:
        # Equal segments or shared left endpoint
        se2.type = _NON_CONTRIBUTING
        if same_operand:
            # Interior seam of one operand (members abutting edge-to-edge):
            # a VALID MultiPolygon's members have disjoint interiors, so
            # coincident same-operand edges always bound opposite sides —
            # the operand's interior is continuous across them and the
            # coincident portion is a boundary of NOTHING. Drop both from
            # every result. Parity stays correct because _compute_fields
            # still counts both edges (two flips = net zero across the
            # seam). Do NOT consult in_out here: unlike the cross-operand
            # case, se2's own-operand parity is stale at marking time (se1
            # was just inserted into the same chain). Self-overlapping
            # (invalid) operands degrade to even-odd annihilation.
            se1.type = _NON_CONTRIBUTING
        else:
            se1.type = _SAME_TRANSITION if se2.in_out == se1.in_out else _DIFFERENT_TRANSITION
        if not right_coincide:
            _divide_segment(events[1].other, events[0].point, queue)
        return 2
    if right_coincide:
        _divide_segment(events[0], events[1].point, queue)
        return 3
    if events[0] is not events[3].other:
        # Partial overlap, neither contains the other
        _divide_segment(events[0], events[1].point, queue)
        _divide_segment(events[1], events[2].point, queue)
        return 3
    # One segment fully contains the other
    _divide_segment(events[0], events[1].point, queue)
    _divide_segment(events[3].other, events[2].point, queue)
    return 3


def _remark_overlap(lower: _SweepEvent, upper: _SweepEvent, operation: int) -> None:
    """Re-derive the SAME/DIFFERENT_TRANSITION marking of a left-coincide
    cross-operand overlap AFTER the caller refreshed both events' fields.

    _possible_intersection classifies the kept edge by comparing the two
    events' in_out parity, but at marking time the upper event's fields
    can predate an edge inserted BELOW it since its own insertion (the
    a pinwheel fuzz finding: a tiny operand scaled from the same
    shape makes its edges near-collinear with the subject's inside the
    _sa_snap band; the band merges them into an equal-segment overlap
    whose upper event still carries parity from before the lower operand's
    base edge existed, the pair is marked DIFFERENT_TRANSITION instead of
    SAME, and union drops the whole face). The caller's r==2 branch
    recomputes lower from a fresh parity chain and upper across lower, so
    re-marking here uses correct values. The kept edge is always the
    LOWER (both call sites pass se2 = the upper, which gets
    NON_CONTRIBUTING)."""
    if lower.is_subject == upper.is_subject:
        return  # same-operand seam: both NON_CONTRIBUTING, nothing to re-mark
    if upper.type != _NON_CONTRIBUTING or lower.type not in (
        _SAME_TRANSITION, _DIFFERENT_TRANSITION
    ):
        return
    lower.type = (
        _SAME_TRANSITION if upper.in_out == lower.in_out else _DIFFERENT_TRANSITION
    )
    lower.result_transition = (
        _result_transition(lower, operation) if _in_result(lower, operation) else 0
    )
    # upper's prev_in_result chains off lower's (possibly changed)
    # in_result status — recompute its dependent fields too.
    _compute_fields(upper, lower, operation)


def _in_result(event: _SweepEvent, operation: int) -> bool:
    t = event.type
    if t == _NORMAL:
        if operation == INTERSECTION:
            return not event.other_in_out
        if operation == UNION:
            return event.other_in_out
        if operation == DIFFERENCE:
            return (event.is_subject and event.other_in_out) or (
                not event.is_subject and not event.other_in_out
            )
        return True  # XOR
    if t == _SAME_TRANSITION:
        return operation in (INTERSECTION, UNION)
    if t == _DIFFERENT_TRANSITION:
        return operation == DIFFERENCE
    return False  # NON_CONTRIBUTING


def _result_transition(event: _SweepEvent, operation: int) -> int:
    t = event.type
    if t == _SAME_TRANSITION:
        # Coincident cross-operand edges, interiors on the SAME side (in
        # result for INTERSECTION/UNION): the result region lies on the
        # shared interior side — own-operand parity alone decides. The
        # generic formula below reads other_in_out, which is stale on
        # seams, and mis-signed the transition: a hole whose surrounding
        # face starts on such a seam was emitted as a standalone positive
        # face (a fuzz finding, B\A on donuts sharing edges).
        return 1 if not event.in_out else -1
    if t == _DIFFERENT_TRANSITION:
        # Interiors on OPPOSITE sides (in result for DIFFERENCE): the
        # result is on the subject-interior (= not clipping-interior)
        # side.
        if event.is_subject:
            return 1 if not event.in_out else -1
        return 1 if event.in_out else -1
    this_in = not event.in_out
    that_in = not event.other_in_out
    if operation == INTERSECTION:
        is_in = this_in and that_in
    elif operation == UNION:
        is_in = this_in or that_in
    elif operation == XOR:
        is_in = this_in != that_in
    else:  # DIFFERENCE
        if event.is_subject:
            is_in = this_in and not that_in
        else:
            is_in = that_in and not this_in
    return 1 if is_in else -1


def _compute_fields(event: _SweepEvent, prev: Optional[_SweepEvent], operation: int) -> None:
    if prev is None:
        event.in_out = False
        event.other_in_out = True
    elif event.is_subject == prev.is_subject:
        event.in_out = not prev.in_out
        event.other_in_out = prev.other_in_out
    else:
        event.in_out = not prev.other_in_out
        event.other_in_out = (not prev.in_out) if prev.is_vertical() else prev.in_out

    if prev is not None:
        event.prev_in_result = (
            prev.prev_in_result
            if (not _in_result(prev, operation) or prev.is_vertical())
            else prev
        )
    event.result_transition = (
        _result_transition(event, operation) if _in_result(event, operation) else 0
    )


class _StatusLine:
    """Ordered active-segment list under _compare_segments.

    Binary insertion; identity removal falls back to a linear scan when
    float drift makes the binary probe miss."""

    __slots__ = ("items",)

    def __init__(self):
        self.items: List[_SweepEvent] = []

    def insert(self, ev: _SweepEvent) -> int:
        lo, hi = 0, len(self.items)
        while lo < hi:
            mid = (lo + hi) // 2
            if _compare_segments(self.items[mid], ev) < 0:
                lo = mid + 1
            else:
                hi = mid
        self.items.insert(lo, ev)
        return lo

    def index(self, ev: _SweepEvent) -> int:
        lo, hi = 0, len(self.items)
        while lo < hi:
            mid = (lo + hi) // 2
            c = _compare_segments(self.items[mid], ev)
            if self.items[mid] is ev:
                return mid
            if c < 0:
                lo = mid + 1
            else:
                hi = mid
        # probe neighbors of the insertion point, then full scan
        for i in range(max(0, lo - 2), min(len(self.items), lo + 3)):
            if self.items[i] is ev:
                return i
        for i, it in enumerate(self.items):
            if it is ev:
                return i
        return -1

    def remove_at(self, i: int) -> None:
        del self.items[i]


def _parity_prev(status: _StatusLine, pos: int) -> Optional[_SweepEvent]:
    """The event that seeds position ``pos``'s parity fields: the first
    NON-VERTICAL edge below it in the status line.

    Parity fields (in_out / other_in_out) describe the cross-section just
    RIGHT of the sweep line. A vertical edge lives in the status only
    while the sweep sits at its own x, and an upward ray at x+eps never
    crosses it — so verticals must be TRANSPARENT when chaining fields.
    The published algorithm's one-step is_vertical corrections in
    _compute_fields approximate this for a single vertical prev, but
    mis-sign an edge starting ON a vertical edge when the chain crosses
    operands (a semantic-fuzz finding: union of a box with a star
    whose edge passed through the box corner and whose vertex lay on the
    box's vertical right edge dropped the star's outside lobe entirely).
    Verticals stay in the status for intersection tests — only the field
    chain skips them."""
    i = pos - 1
    while i >= 0 and status.items[i].is_vertical():
        i -= 1
    return status.items[i] if i >= 0 else None


def _fill_queue(subject_rings, clipping_rings) -> list:
    """Rings must already be on the integer lattice (see boolean_op)."""
    queue: list = []
    contour_id = 0
    for rings, is_subject in ((subject_rings, True), (clipping_rings, False)):
        for ring in rings:
            contour_id += 1
            pts = [(float(x), float(y)) for x, y in ring]
            if len(pts) >= 2 and pts[0] == pts[-1]:
                pts = pts[:-1]
            n = len(pts)
            if n < 3:
                continue
            # A zero-area ring (collinear points — a degenerate input hole,
            # or a sliver that snap-collapsed onto one lattice line) bounds
            # nothing, but its back-and-forth edges desynchronize the
            # sweep's in_out parity and corrupted difference/xor by the
            # whole region behind them (a semantic-fuzz finding).
            # Shoelace in exact (arbitrary-precision) int arithmetic: the
            # coordinates are integer-valued lattice floats.
            area2 = 0
            for i in range(n):
                x1, y1 = pts[i]
                x2, y2 = pts[(i + 1) % n]
                area2 += int(x1) * int(y2) - int(x2) * int(y1)
            if area2 == 0:
                continue
            for i in range(n):
                p1 = pts[i]
                p2 = pts[(i + 1) % n]
                if p1 == p2:
                    continue  # zero-length edge
                e1 = _SweepEvent(p1, False, None, is_subject)
                e2 = _SweepEvent(p2, False, e1, is_subject)
                e1.other = e2
                e1.contour_id = e2.contour_id = contour_id
                if _compare_events(e1, e2) < 0:
                    e1.left = True
                else:
                    e2.left = True
                heapq.heappush(queue, e1)
                heapq.heappush(queue, e2)
    return queue


def _subdivide(queue: list, operation: int, s_maxx: float, minmaxx: float) -> List[_SweepEvent]:
    status = _StatusLine()
    sorted_events: List[_SweepEvent] = []
    while queue:
        event = heapq.heappop(queue)
        sorted_events.append(event)
        if (operation == INTERSECTION and event.point[0] > minmaxx) or (
            operation == DIFFERENCE and event.point[0] > s_maxx
        ):
            break
        if event.left:
            pos = status.insert(event)
            prev = status.items[pos - 1] if pos > 0 else None
            nxt = status.items[pos + 1] if pos + 1 < len(status.items) else None
            _compute_fields(event, _parity_prev(status, pos), operation)
            r_nxt = r_prev = 0
            if nxt is not None:
                r_nxt = _possible_intersection(event, nxt, queue)
                if r_nxt == 2:
                    _compute_fields(event, _parity_prev(status, pos), operation)
                    _compute_fields(nxt, event, operation)
                    _remark_overlap(event, nxt, operation)
            if prev is not None:
                r_prev = _possible_intersection(prev, event, queue)
                if r_prev == 2:
                    i = status.index(prev)
                    _compute_fields(prev, _parity_prev(status, i), operation)
                    _compute_fields(event, prev, operation)
                    _remark_overlap(prev, event, operation)
            # Tangential vertex-on-edge touch AT this event's left endpoint:
            # the intersection test just split a neighbor exactly at
            # event.point, so that neighbor now ENDS here — its parity
            # fields describe the cross-section LEFT of this point, and any
            # field chained off it (this event's, and transitively every
            # later insert above it) is stale: the fuzzed failure was a box
            # corner lying ON a needle operand's edge, where the box's top
            # edge seeded in_out from the un-split needle edge and the
            # difference/union results dropped a 0.5-area face. Re-queue
            # this event: the heap replays it AFTER the neighbor's right
            # event at this point (right-before-left) and after the
            # neighbor's continuation piece (bottom-first among same-point
            # left events), so the re-insert chains off fresh fields. The
            # re-pop cannot split THAT neighbor at this point again (the
            # continuation piece now SHARES the endpoint — returns 0), but
            # with three or more edges concurrent at one lattice vertex the
            # replayed insertion can land next to a DIFFERENT edge that also
            # passes exactly through event.point and split it too — the same
            # dropped-face staleness one degeneracy deeper (a review
            # finding). So requeue on EVERY fresh split-at-own-point, with a
            # counter capped by the status size: each requeue consumes one
            # distinct edge through the point (its continuation shares the
            # endpoint afterwards), and at most len(status) edges cross the
            # sweep line, so the cap is never the binding limit on correct
            # input — it only guarantees termination.
            if event.touch_requeues <= len(status.items) and (
                (r_prev == 1 and prev.other.point == event.point)
                or (r_nxt == 1 and nxt.other.point == event.point)
            ):
                i = status.index(event)
                if i >= 0:
                    status.remove_at(i)
                sorted_events.pop()
                event.touch_requeues += 1
                heapq.heappush(queue, event)
                continue
        else:
            le = event.other
            i = status.index(le)
            if i >= 0:
                prev = status.items[i - 1] if i > 0 else None
                nxt = status.items[i + 1] if i + 1 < len(status.items) else None
                status.remove_at(i)
                if prev is not None and nxt is not None:
                    # NB: a left-coincide overlap first detected HERE (two
                    # edges becoming adjacent only at a removal) is marked
                    # with whatever fields the pair carries — there is no
                    # field refresh at removal time in the published
                    # algorithm, so _remark_overlap has no hook (it fixes
                    # the insertion-time branches, where a refresh already
                    # exists). Such a pair must share a left endpoint yet
                    # first touch at a later removal — the semantic-fuzz
                    # campaigns (20k+ pairs incl. the pinwheel/coincidence
                    # generators) have not produced this configuration.
                    _possible_intersection(prev, nxt, queue)
    return sorted_events


def _order_events(sorted_events: List[_SweepEvent]) -> List[_SweepEvent]:
    import functools

    result: List[_SweepEvent] = []
    for ev in sorted_events:
        if (ev.left and ev.in_result) or (not ev.left and ev.other.in_result):
            result.append(ev)
    # Overlapping-edge splits can leave the list slightly unsorted; the
    # comparator is a strict total order (see _compare_events), so a real
    # sort is safe — the previous exchange-sort loop span forever on
    # comparator cycles.
    result.sort(key=functools.cmp_to_key(_compare_events))
    for i, ev in enumerate(result):
        ev.pos = i
    # Right events adopt their left counterpart's position
    for ev in result:
        if not ev.left:
            ev.pos, ev.other.pos = ev.other.pos, ev.pos
    return result


def _cw_class(r, u) -> int:
    """Rank of u by clockwise angle from r: (0,180) cw side first, then
    exactly opposite, then the ccw side, then exactly-r last (a full turn
    back along the arrival segment). Exact for lattice-point vectors."""
    c = r[0] * u[1] - r[1] * u[0]
    if c < 0:
        return 0
    if c > 0:
        return 2
    d = r[0] * u[0] + r[1] * u[1]
    return 1 if d < 0 else 3


def _cw_before(r, u, v) -> bool:
    """True if u comes strictly before v rotating clockwise from r."""
    ku, kv = _cw_class(r, u), _cw_class(r, v)
    if ku != kv:
        return ku < kv
    if ku in (1, 3):
        return False  # exact angular tie
    return (u[0] * v[1] - u[1] * v[0]) < 0


def _next_pos(pos: int, result: List[_SweepEvent], processed, orig: int) -> int:
    """Pick the next result event at the current point.

    Where several result edges meet (contours touching at a vertex — the
    case the original Martinez point-walk pairs incorrectly), apply
    rightmost-turn face tracing: continue with the first unprocessed edge
    CLOCKWISE from the reversed incoming direction. This keeps the face
    interior on the left, so holes touching their shell are traversed with
    the correct winding. All angle tests are exact (lattice coordinates)."""
    p = result[pos].point
    n = len(result)
    cands: List[int] = []
    j = pos + 1
    while j < n and result[j].point == p:
        if not processed[j]:
            cands.append(j)
        j += 1
    j = pos - 1
    while j >= 0 and result[j].point == p:
        if not processed[j]:
            cands.append(j)
        j -= 1
    if not cands:
        return orig
    # When back at the contour's start point, closing the ring competes
    # with the remaining edges: represent it by the initial edge's
    # direction. Without this the walk is forced through every touching
    # ring at the start point and can build a bowtie.
    at_start = result[orig].point == p
    if not at_start and len(cands) == 1:
        return cands[0]
    prev_pt = result[pos].other.point
    r = (prev_pt[0] - p[0], prev_pt[1] - p[1])
    best = cands[0]
    o = result[best].other.point
    best_u = (o[0] - p[0], o[1] - p[1])
    for c in cands[1:]:
        o = result[c].other.point
        u = (o[0] - p[0], o[1] - p[1])
        if _cw_before(r, u, best_u):
            best, best_u = c, u
    if at_start:
        o = result[orig].other.point
        u0 = (o[0] - p[0], o[1] - p[1])
        if not _cw_before(r, best_u, u0):
            return orig
    return best


class _Contour:
    __slots__ = ("points", "hole_ids", "hole_of", "depth")

    def __init__(self):
        self.points: List[Tuple[float, float]] = []
        self.hole_ids: List[int] = []
        self.hole_of: Optional[int] = None
        self.depth = 0


def _initialize_contour(event: _SweepEvent, contours: List[_Contour], cid: int) -> _Contour:
    contour = _Contour()
    if event.prev_in_result is not None:
        lower = event.prev_in_result
        lower_cid = lower.output_contour_id
        if lower_cid < 0:
            # The lower event's ring hasn't been walked yet — possible under
            # extreme quantization degeneracies (sub-lattice slivers). A
            # Python negative index would silently nest under the LAST ring
            # (and the C++ port would read out of bounds): treat as no
            # parent instead; _contours_to_geometry's degenerate-promotion
            # handles any stray face.
            pass
        elif lower.result_transition > 0:
            lower_contour = contours[lower_cid]
            if lower_contour.hole_of is not None:
                parent = lower_contour.hole_of
                contours[parent].hole_ids.append(cid)
                contour.hole_of = parent
                contour.depth = lower_contour.depth
            else:
                contours[lower_cid].hole_ids.append(cid)
                contour.hole_of = lower_cid
                contour.depth = lower_contour.depth + 1
        else:
            contour.hole_of = None
            contour.depth = contours[lower_cid].depth if lower_cid >= 0 else 0
    return contour


def _cancel_seam_twins(sorted_events: List[_SweepEvent]) -> None:
    """Cancel IDENTICAL result segments with opposite transitions.

    Snap degeneracies (a pinched-donut fuzz finding: a hole vertex pinching
    its own shell edge rounds ~1 lattice unit off and double-splits the
    edge) can leave twin in-result edges over the exact same segment, one
    +1 and one -1 — a zero-width slit. The transitions are individually
    correct, but the contour walk threads the slit (doubled vertices) and
    the face STARTED from a twin inherits its shell/hole classification:
    the fuzzed failure emitted a union's hole-overlap face as a
    standalone POSITIVE island (+8 area on the repro). Crossing both
    twins leaves parity unchanged, so cancelling each (+1,-1) pair is
    exact; prev_in_result pointers that referenced a cancelled twin
    re-chain through it so hole parenting still sees the pair's true
    lower neighbor."""
    from collections import defaultdict

    groups = defaultdict(list)
    for ev in sorted_events:
        if ev.left and ev.in_result:
            groups[(ev.point, ev.other.point)].append(ev)
    cancelled = set()
    for evs in groups.values():
        if len(evs) < 2:
            continue
        pos = [e for e in evs if e.result_transition > 0]
        neg = [e for e in evs if e.result_transition < 0]
        k = min(len(pos), len(neg))
        for e in pos[:k] + neg[:k]:
            e.result_transition = 0
            cancelled.add(id(e))
    if not cancelled:
        return
    for ev in sorted_events:
        p = ev.prev_in_result
        while p is not None and id(p) in cancelled:
            p = p.prev_in_result
        ev.prev_in_result = p


def _connect_edges(sorted_events: List[_SweepEvent]) -> List[_Contour]:
    _cancel_seam_twins(sorted_events)
    result = _order_events(sorted_events)
    n = len(result)
    processed = [False] * n
    contours: List[_Contour] = []
    for i in range(n):
        if processed[i]:
            continue
        cid = len(contours)
        contour = _initialize_contour(result[i], contours, cid)
        contours.append(contour)
        pos = i
        contour.points.append(result[i].point)
        while True:
            processed[pos] = True
            result[pos].output_contour_id = cid
            pos = result[pos].pos
            processed[pos] = True
            result[pos].output_contour_id = cid
            contour.points.append(result[pos].point)
            pos = _next_pos(pos, result, processed, i)
            if pos == i or pos >= n or pos < 0:
                break
    return contours


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _geometry_rings(g: _poly.Geometry) -> List[np.ndarray]:
    polys = g.geoms if isinstance(g, _poly.MultiPolygon) else [g]
    rings = []
    for p in polys:
        if not isinstance(p, _poly.Polygon) or p.is_empty:
            continue
        rings.append(p.exterior)
        rings.extend(p.holes)
    return rings


def _contours_to_geometry(contours: List[_Contour]) -> _poly.Geometry:
    def _degenerate(c: _Contour) -> bool:
        if len(c.points) < 4:  # closed ring needs >= 3 distinct + repeat
            return True
        ring = np.asarray(c.points, np.float64)
        return abs(_poly._ring_area(ring[:-1])) <= 0.0

    polys: List[_poly.Polygon] = []
    for c in contours:
        if c.hole_of is not None:
            # A hole whose parent contour is degenerate (a dead-end walk,
            # possible under extreme quantization collisions) is a real
            # face: promote it to a standalone polygon instead of dropping
            # it with its parent.
            if not _degenerate(contours[c.hole_of]):
                continue
        ext = np.asarray(c.points, np.float64)
        if len(ext) < 3:
            continue
        holes = []
        for hid in c.hole_ids:
            h = np.asarray(contours[hid].points, np.float64)
            if len(h) >= 3:
                holes.append(h)
        p = _poly.Polygon(ext, holes)
        if not p.is_empty and p.area > 0.0:
            polys.append(p)
    if not polys:
        return _poly.EMPTY
    if len(polys) == 1:
        return polys[0]
    return _poly.MultiPolygon(polys)


def _members_touch(g: _poly.Geometry) -> bool:
    """Bbox screen: do any two members of a MultiPolygon touch/overlap?

    The sweep assumes each operand's members have disjoint boundaries
    except at finitely many points (OGC validity). Members abutting along
    part of an edge — what region.to_geometry emits for staircase
    dissolves — put collinear overlapping edges into ONE operand; the
    sweep's same-operand seam handling covers horizontal seams exactly,
    but vertical seams hit a parity weakness inherited from the published
    algorithm (its same-operand inOut chain has no vertical correction).
    Such operands are dissolved with pairwise CROSS-operand unions — ON
    THE JOINT LATTICE of the outer op (_lattice_dissolve): dissolving in
    original coordinates and re-snapping double-quantizes, and a value
    near a half-quantum flips its rounding, so a previously exact
    cross-operand collinear overlap lands one lattice row apart and the
    comparator/point-identity machinery corrupts union/difference/xor
    (the corner-touch fuzz finding). Disjoint-member
    MultiPolygons (the common case) pay one vectorized check."""
    if not isinstance(g, _poly.MultiPolygon):
        return False
    members = g.geoms
    if len(members) <= 1:
        return False
    bb = np.asarray([m.bounds for m in members], np.float64)
    for i in range(len(members) - 1):
        o = bb[i + 1:]
        hit = ~(
            (bb[i, 2] < o[:, 0]) | (o[:, 2] < bb[i, 0])
            | (bb[i, 3] < o[:, 1]) | (o[:, 3] < bb[i, 1])
        )
        if hit.any():
            return True
    return False


def _lattice_sweep(subj_rings, clip_rings, operation, s_maxx, minmaxx):
    """Run one sweep on lattice-integral rings, on ``sweep_engine()``.

    Returns the contour list (points stay ON the lattice — crossing
    splits round back onto it), so the output can feed another sweep on
    the same lattice with exact point identity."""
    if sweep_engine() == "c++":
        from aquaculture_tpu_torch.geo import native_boolean

        contours = []
        for pts, hole_of in native_boolean.sweep_native(subj_rings, clip_rings, operation, s_maxx, minmaxx):
            c = _Contour()
            c.points = [(float(x), float(y)) for x, y in pts]
            c.hole_of = hole_of if hole_of >= 0 else None
            contours.append(c)
        for cid, c in enumerate(contours):
            # bounds check is defense-in-depth: the C++ engine guards the
            # degenerate lower_cid=-1 case itself (booleanop.cc
            # initialize_contour), but a stray parent id must never crash
            if c.hole_of is not None and 0 <= c.hole_of < len(contours):
                contours[c.hole_of].hole_ids.append(cid)
            else:
                c.hole_of = None
        return contours
    queue = _fill_queue(subj_rings, clip_rings)
    sorted_events = _subdivide(queue, operation, s_maxx, minmaxx)
    return _connect_edges(sorted_events)


def _clean_lattice_ring(ring: np.ndarray) -> Optional[np.ndarray]:
    """Collapse SUB-LATTICE features of a snapped ring: consecutive
    vertices within 2 lattice units (L_inf) merge, and exact spikes
    (p[i-1] == p[i+1]) drop.

    Real-world rings carry micrometer jogs (the humanlabels corpus has
    vertex pairs 1.5e-6 m apart at ~25 m extents); after the joint-lattice
    snap these become 0-2-unit micro edges — BELOW the engine's resolution
    contract — and they detonate the sweep's degeneracy handling: the
    an audit found pairwise unions of two ordinary overlapping
    14/22-gons returning EMPTY (−349 m² per merge; the corpus dissolve ran
    6% below a Monte-Carlo point oracle, with one dropped duplicate vertex
    restoring the exact area). Collapsing ≤2-unit edges changes area by
    ≤ perimeter x 2 quanta — inside the documented snap tolerance.
    Returns None when fewer than 3 vertices survive."""
    pts = np.asarray(ring, np.float64)
    changed = True
    while changed and len(pts) >= 3:
        changed = False
        nxt = np.roll(pts, -1, axis=0)
        d = np.maximum(np.abs(pts[:, 0] - nxt[:, 0]), np.abs(pts[:, 1] - nxt[:, 1]))
        keep = d > 2.0
        if not keep.all():
            pts = pts[keep]
            changed = True
            continue
        prv = np.roll(pts, 1, axis=0)
        nxt = np.roll(pts, -1, axis=0)
        spike = (prv[:, 0] == nxt[:, 0]) & (prv[:, 1] == nxt[:, 1])
        if spike.any():
            pts = pts[~spike]
            changed = True
    return pts if len(pts) >= 3 else None


def _rings_touch_lattice(r1: np.ndarray, r2: np.ndarray, tol: float = 3.0) -> bool:
    """Conservative: do two snapped rings come within `tol` lattice units
    (segment-to-segment)? Cheap O(n*m) over the small rings this engine
    sees; bbox prefilter first."""
    a1 = np.asarray(r1, np.float64)
    a2 = np.asarray(r2, np.float64)
    if (a1[:, 0].max() + tol < a2[:, 0].min() or a2[:, 0].max() + tol < a1[:, 0].min()
            or a1[:, 1].max() + tol < a2[:, 1].min() or a2[:, 1].max() + tol < a1[:, 1].min()):
        return False
    segs1 = np.stack([a1, np.roll(a1, -1, axis=0)], axis=1)
    p2 = a2

    def _pts_to_segs_min(pts, segs):
        a = segs[:, 0][None]            # (1,m,2)
        b = segs[:, 1][None]
        ab = b - a
        ap = pts[:, None, :] - a        # (n,m,2)
        denom = np.maximum((ab * ab).sum(-1), 1e-300)
        t = np.clip((ap * ab).sum(-1) / denom, 0.0, 1.0)
        proj = a + t[..., None] * ab
        return np.sqrt(((pts[:, None, :] - proj) ** 2).sum(-1)).min()

    # vertex-to-segment both ways bounds segment-segment distance for the
    # touching cases that matter here (a crossing pair is ALSO degenerate
    # for same-operand rings, and crossings imply vertices within tol of
    # the other ring after snapping in every observed failure class; the
    # even-odd semantics of a clean crossing are handled by the sweep
    # itself)
    segs2 = np.stack([a2, np.roll(a2, -1, axis=0)], axis=1)
    d = min(_pts_to_segs_min(p2, segs1), _pts_to_segs_min(a1, segs2))
    return d <= tol


def _normalize_polygon_rings(rings: List[np.ndarray]) -> List[np.ndarray]:
    """Normalize ONE polygon's snapped rings when its holes touch each
    other or the shell (the pinched-donut fuzz class).

    A hole vertex pinching its own shell edge (or two holes sharing a
    vertex) puts same-operand ring contacts into the sweep; after the
    joint-lattice snap the contact rounds ~1 unit off and the connect
    walk threads figure-eight circuits through the pinch, splitting the
    boundary into open chains and corrupting hole parenting (union came
    back EMPTY on the fuzzed repro). Rebuilding the polygon as
    shell MINUS dissolved-holes — a CROSS-operand difference on the SAME
    lattice — resolves every contact through the hardened two-operand
    machinery (perp merge, requeue, overlap re-marking) and feeds the
    main sweep clean simple rings with exact point identity."""
    shell, holes = rings[0], rings[1:]
    if not holes:
        return rings
    touch = any(
        _rings_touch_lattice(shell, h) for h in holes
    ) or any(
        _rings_touch_lattice(holes[i], holes[j])
        for i in range(len(holes) - 1)
        for j in range(i + 1, len(holes))
    )
    if not touch:
        return rings
    inf = float("inf")
    hole_rings = (
        _lattice_dissolve([[h] for h in holes]) if len(holes) > 1 else list(holes)
    )
    contours = _lattice_sweep([shell], hole_rings, DIFFERENCE, inf, inf)
    out = [np.asarray(c.points, np.float64) for c in contours if len(c.points) >= 3]
    return out if out else rings


def _lattice_dissolve(member_rings: List[List[np.ndarray]]) -> List[np.ndarray]:
    """Union a touching-member MultiPolygon's members on the lattice.

    Folds members with pairwise cross-operand unions (exact for abutment
    in every orientation) entirely in lattice coordinates — no inverse
    transform, no re-snap, so downstream point identity vs the other
    operand is preserved. Output rings are fed to the main sweep with
    even-odd semantics (shells and holes alike)."""
    acc = member_rings[0]
    inf = float("inf")
    for rings in member_rings[1:]:
        contours = _lattice_sweep(acc, rings, UNION, inf, inf)
        acc = [np.asarray(c.points, np.float64) for c in contours
               if len(c.points) >= 3]
    return acc


def boolean_op(subject: _poly.Geometry, clipping: _poly.Geometry, op: str,
               _normalize: bool = True) -> _poly.Geometry:
    """intersection / union / difference / xor of two polygonal geometries.

    Operands may be Polygon or MultiPolygon, with holes, non-convex.
    Result hole nesting is reconstructed from sweep depth.
    """
    operation = _OPS[op]
    for g, name in ((subject, "subject"), (clipping, "clipping")):
        if not g.is_empty and not isinstance(g, (_poly.Polygon, _poly.MultiPolygon)):
            # Silently treating a Point/LineString operand as empty would
            # corrupt union/xor results (the operand vanishes from the
            # dissolve); fail loudly like the pre-overlay engine did.
            raise TypeError(
                f"boolean_op {name} operand must be polygonal (Polygon/"
                f"MultiPolygon/Empty), got {type(g).__name__}"
            )
    s_empty = subject.is_empty
    c_empty = clipping.is_empty
    if s_empty and c_empty:
        return _poly.EMPTY
    if s_empty:
        return _poly.EMPTY if operation in (INTERSECTION, DIFFERENCE) else clipping
    if c_empty:
        return _poly.EMPTY if operation == INTERSECTION else subject

    sb, cb = subject.bounds, clipping.bounds
    disjoint = sb[0] > cb[2] or cb[0] > sb[2] or sb[1] > cb[3] or cb[1] > sb[3]
    if disjoint:
        if operation == INTERSECTION:
            return _poly.EMPTY
        if operation == DIFFERENCE:
            return subject
        # union / xor of disjoint operands: concatenate
        parts = []
        for g in (subject, clipping):
            parts.extend(g.geoms if isinstance(g, _poly.MultiPolygon) else [g])
        return _poly.MultiPolygon(parts)

    # MEMBER-LEVEL disjointness: when either operand is a
    # MultiPolygon, only the members whose bboxes can interact with the
    # OTHER operand's members enter the sweep — the rest pass through
    # EXACTLY (union/xor: concatenated; difference: subject-side kept;
    # intersection: dropped). This matters enormously for corpus-scale
    # union trees: without it, every top-level merge re-snaps EVERY
    # member to the pair's corpus-wide joint bbox (quantum ~ span/2^25),
    # and tiny features far from any actual interaction re-quantize at
    # every tree level — the 4,142-cage humanlabels dissolve measured
    # ~6% BELOW a Monte-Carlo point oracle (127.3k vs 135.2k m²) from
    # exactly this drift. With the partition, the interacting core also
    # snaps to a TIGHTER bbox (finer lattice), and the same drive lands
    # inside the oracle's confidence interval.
    if _normalize and (
        isinstance(subject, _poly.MultiPolygon) or isinstance(clipping, _poly.MultiPolygon)
    ):
        a_mem = list(subject.geoms) if isinstance(subject, _poly.MultiPolygon) else [subject]
        b_mem = list(clipping.geoms) if isinstance(clipping, _poly.MultiPolygon) else [clipping]
        if len(a_mem) > 1 or len(b_mem) > 1:
            ab = np.asarray([m.bounds for m in a_mem], np.float64).reshape(-1, 4)
            bb = np.asarray([m.bounds for m in b_mem], np.float64).reshape(-1, 4)
            hit = ~(
                (ab[:, None, 2] < bb[None, :, 0])
                | (bb[None, :, 2] < ab[:, None, 0])
                | (ab[:, None, 3] < bb[None, :, 1])
                | (bb[None, :, 3] < ab[:, None, 1])
            )
            a_in = hit.any(axis=1)
            b_in = hit.any(axis=0)
            if not a_in.all() or not b_in.all():
                def _mp(members):
                    if not members:
                        return _poly.EMPTY
                    return members[0] if len(members) == 1 else _poly.MultiPolygon(members)

                core = boolean_op(
                    _mp([m for m, k in zip(a_mem, a_in) if k]),
                    _mp([m for m, k in zip(b_mem, b_in) if k]),
                    op,
                )
                passthrough: List[_poly.Polygon] = []
                if operation in (UNION, XOR):
                    passthrough += [m for m, k in zip(a_mem, a_in) if not k]
                    passthrough += [m for m, k in zip(b_mem, b_in) if not k]
                elif operation == DIFFERENCE:
                    passthrough += [m for m, k in zip(a_mem, a_in) if not k]
                # intersection: non-interacting members contribute nothing
                if not passthrough:
                    return core
                parts = [] if core.is_empty else (
                    list(core.geoms) if isinstance(core, _poly.MultiPolygon) else [core]
                )
                parts += passthrough
                return _mp(parts)

    # Snap both operands to a shared 2^25 integer lattice over their joint
    # bbox. Every orientation test in the sweep then runs on integer-valued
    # float64s: coordinate differences are <= 2^26, cross products <= 2^52,
    # so _signed_area is EXACT — the comparator degeneracy branches see
    # true zeros instead of 1e-16 residue (the classic Martinez float
    # failure mode). Computed crossings are rounded back onto the lattice
    # (resolution ~1.5e-8 of the operand span; quantization is the only
    # approximation in the result).
    minx, miny = min(sb[0], cb[0]), min(sb[1], cb[1])
    maxx, maxy = max(sb[2], cb[2]), max(sb[3], cb[3])
    span = max(maxx - minx, maxy - miny)
    if span <= 0.0 or not np.isfinite(span):
        return _poly.EMPTY
    f = float(1 << 25) / span
    cx, cy = 0.5 * (minx + maxx), 0.5 * (miny + maxy)

    def _fwd(ring: np.ndarray) -> np.ndarray:
        r = np.asarray(ring, np.float64)
        return np.stack(
            [np.round((r[:, 0] - cx) * f), np.round((r[:, 1] - cy) * f)], axis=1
        )

    def _polygon_rings(p: _poly.Polygon) -> List[np.ndarray]:
        rings = [_fwd(p.exterior)] + [_fwd(h) for h in p.holes]
        if _normalize:
            cleaned = [_clean_lattice_ring(r) for r in rings]
            rings = [r for r in cleaned if r is not None]
            if not rings or cleaned[0] is None:
                return []
            if len(rings) > 1:
                rings = _normalize_polygon_rings(rings)
        return rings

    def _operand_rings(g: _poly.Geometry) -> List[np.ndarray]:
        """Snap an operand's rings to the joint lattice; normalize
        self-touching polygons (holes pinching shell/each other — see
        _normalize_polygon_rings) and dissolve a touching-member
        MultiPolygon there (see _members_touch: dissolving in original
        coordinates and re-snapping double-quantizes)."""
        polys = g.geoms if isinstance(g, _poly.MultiPolygon) else [g]
        polys = [p for p in polys if isinstance(p, _poly.Polygon) and not p.is_empty]
        if _normalize and _members_touch(g):
            member_rings = [_polygon_rings(m) for m in polys]
            return _lattice_dissolve(member_rings)
        out: List[np.ndarray] = []
        for p in polys:
            out.extend(_polygon_rings(p))
        return out

    subj_rings = _operand_rings(subject)
    clip_rings = _operand_rings(clipping)
    s_maxx_t = (sb[2] - cx) * f + 1.0
    minmaxx_t = (min(sb[2], cb[2]) - cx) * f + 1.0

    # the sweep runs on sweep_engine(): the C++ library (the GEOS-equivalent
    # component; same algorithm on the same lattice) or the Python sweep
    contours = _lattice_sweep(subj_rings, clip_rings, operation, s_maxx_t, minmaxx_t)
    inv = 1.0 / f
    for c in contours:
        c.points = [(x * inv + cx, y * inv + cy) for x, y in c.points]
    return _contours_to_geometry(contours)


def union_area(geometries) -> float:
    """Area of the dissolved union of one or many geometries.

    Accepts a single Geometry (MultiPolygon members dissolve), or an
    iterable of Geometries. Replaces ``unary_union(...).area``
    (reference utils_tonnage.py:617,1165) when only the measure is needed.
    """
    if isinstance(geometries, _poly.Geometry):
        geoms: List[_poly.Geometry] = (
            list(geometries.geoms) if isinstance(geometries, _poly.MultiPolygon) else [geometries]
        )
    else:
        geoms = [g for g in geometries if g is not None]
    geoms = [g for g in geoms if not g.is_empty]
    if not geoms:
        return 0.0
    return unary_union_tree(geoms).area


def unary_union_tree(geoms: Sequence[_poly.Geometry]) -> _poly.Geometry:
    """Divide-and-conquer union of many geometries (balanced union tree:
    O(n log n) boolean ops instead of the O(n^2) left fold).

    All-rectilinear inputs (the pipeline's cage boxes) stay in Region
    space for the whole tree: one from_geometry per leaf and ONE
    to_geometry at the root — the per-node geometry<->Region round-trips
    of the generic path dominated large dissolves (the 4,142-cage corpus
    dropped ~20x with this)."""
    items = [g for g in geoms if g is not None and not g.is_empty]
    if not items:
        return _poly.EMPTY
    if len(items) > 2 and _poly._all_rectilinear(*items):
        from aquaculture_tpu_torch.geo import region

        regs = [region.from_geometry(g) for g in items]
        while len(regs) > 1:
            nxt = []
            for i in range(0, len(regs) - 1, 2):
                nxt.append(regs[i].union(regs[i + 1]))
            if len(regs) % 2:
                nxt.append(regs[-1])
            regs = nxt
        return region.to_geometry(regs[0])
    # Spatially sort the leaves (Morton order on centroids) so OVERLAPPING
    # geometries merge at the LOWEST tree levels, where the pair's joint
    # bbox — and therefore the snap quantum and the comparator's lattice-
    # noise bands — is tight. In file order, near-duplicate features can
    # first meet near the ROOT, where the corpus-wide span makes the
    # quantum ~span/2^25 and the sliver-merging bands grow with it: the
    # 4,142-cage humanlabels dissolve measured 3-6% below a Monte-Carlo
    # point oracle before this (with member partitioning
    # + Morton order it lands inside the oracle's interval).
    if len(items) > 2:
        bs = np.asarray([g.bounds for g in items], np.float64).reshape(-1, 4)
        cxs = 0.5 * (bs[:, 0] + bs[:, 2])
        cys = 0.5 * (bs[:, 1] + bs[:, 3])
        qx = np.clip(((cxs - cxs.min()) / max(float(np.ptp(cxs)), 1e-300) * 65535), 0, 65535).astype(np.uint64)
        qy = np.clip(((cys - cys.min()) / max(float(np.ptp(cys)), 1e-300) * 65535), 0, 65535).astype(np.uint64)

        def _interleave(v):
            v = (v | (v << 8)) & np.uint64(0x00FF00FF)
            v = (v | (v << 4)) & np.uint64(0x0F0F0F0F)
            v = (v | (v << 2)) & np.uint64(0x33333333)
            v = (v | (v << 1)) & np.uint64(0x55555555)
            return v

        morton = _interleave(qx) | (_interleave(qy) << np.uint64(1))
        items = [items[i] for i in np.argsort(morton, kind="stable")]
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            nxt.append(_poly.union(items[i], items[i + 1]))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]
