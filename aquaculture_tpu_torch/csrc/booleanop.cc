// Native boolean-overlay engine: Martinez-Rueda-Feito sweep on the integer
// lattice. C++ port of aquaculture_tpu/geo/boolean.py (the GEOS-equivalent
// component: the reference gets polygon overlay from GEOS, a C++ library;
// this keeps the rebuild's native runtime at parity). The Python module
// remains the reference implementation and the fallback; inputs arrive
// already snapped to the 2^25 lattice (integer-valued doubles), so every
// orientation test here is exact in double arithmetic (|cross| <= 2^52).
//
// ABI (ctypes, see aquaculture_tpu/geo/native_boolean.py):
//   aq_bool_op(...)        -> opaque result handle (contours)
//   aq_bool_ncontours(h)   -> contour count
//   aq_bool_contour(h,i,..)-> npoints + hole_of for contour i
//   aq_bool_points(h,i,out)-> copy xy pairs
//   aq_bool_free(h)
//
// Behavioral parity notes (mirrors boolean.py exactly, same names):
//  * _sa_snap tolerance band 3*(|dx|+|dy|)
//  * crossing points rounded with banker's rounding (nearbyint under the
//    default FE_TONEAREST mode == numpy/python round)
//  * endpoint snap: vertex-on-edge perp test (2 units) + +/-2 unit window
//  * rightmost-turn face tracing at multi-edge vertices (_next_pos)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <queue>
#include <set>
#include <tuple>
#include <vector>

namespace {

enum Op { INTERSECTION = 0, UNION = 1, DIFFERENCE = 2, XOR = 3 };
enum EdgeType { NORMAL = 0, NON_CONTRIBUTING = 1, SAME_TRANSITION = 2, DIFFERENT_TRANSITION = 3 };

struct Pt {
  double x, y;
  bool operator==(const Pt& o) const { return x == o.x && y == o.y; }
  bool operator!=(const Pt& o) const { return !(*this == o); }
};

struct SweepEvent {
  Pt point{};
  bool left = false;
  SweepEvent* other = nullptr;
  bool is_subject = false;
  int type = NORMAL;
  bool in_out = false;
  bool other_in_out = false;
  SweepEvent* prev_in_result = nullptr;
  int result_transition = 0;  // +1 out->in, -1 in->out, 0 not in result
  int pos = 0;
  int contour_id = 0;
  int output_contour_id = -1;
  int64_t sid = 0;  // total-order tiebreak (see compare_events)
  int touch_requeues = 0;  // tangential-touch replay counter (see subdivide)

  bool in_result() const { return result_transition != 0; }
  bool is_vertical() const { return point.x == other->point.x; }
};

inline double signed_area(const Pt& p0, const Pt& p1, const Pt& p2) {
  return (p0.x - p2.x) * (p1.y - p2.y) - (p1.x - p2.x) * (p0.y - p2.y);
}

// Orientation snapped to 0 inside the lattice-noise band (boolean.py _sa_snap).
inline double sa_snap(const Pt& p0, const Pt& p1, const Pt& p2) {
  double sa = signed_area(p0, p1, p2);
  double tol = 3.0 * (std::fabs(p1.x - p0.x) + std::fabs(p1.y - p0.y));
  return (sa >= -tol && sa <= tol) ? 0.0 : sa;
}

inline bool is_below(const SweepEvent* e, const Pt& p) {
  if (e->left) return sa_snap(e->point, e->other->point, p) > 0;
  return sa_snap(e->other->point, e->point, p) > 0;
}

inline bool is_above(const SweepEvent* e, const Pt& p) { return !is_below(e, p); }

// Sweep processing order (boolean.py _compare_events). MUST be a strict
// total order: order_events feeds it to std::stable_sort (UB on
// non-strict-weak orders). Transitivity: event coordinates are lattice
// integers, so signed_area is EXACT and the orientation branch runs with
// NO snap band — a band made "collinear" non-transitive (A~B, B~C but
// A<C), which both hung the old exchange sort and broke strict-weak
// ordering. Exact collinearity falls to discrete keys.
int compare_events(const SweepEvent* e1, const SweepEvent* e2) {
  if (e1 == e2) return 0;
  const Pt& p1 = e1->point;
  const Pt& p2 = e2->point;
  if (p1.x > p2.x) return 1;
  if (p1.x < p2.x) return -1;
  if (p1.y != p2.y) return p1.y > p2.y ? 1 : -1;
  if (e1->left != e2->left) return e1->left ? 1 : -1;
  const Pt& o1 = e1->other->point;
  const Pt& o2 = e2->other->point;
  const double sa = signed_area(p1, o1, o2);
  if (sa != 0.0) {
    const bool below = e1->left ? (sa > 0) : (sa < 0);
    return below ? -1 : 1;
  }
  if (e1->is_subject != e2->is_subject) return e1->is_subject ? -1 : 1;
  if (o1 != o2) {
    if (o1.x != o2.x) return o1.x > o2.x ? 1 : -1;
    return o1.y > o2.y ? 1 : -1;
  }
  if (e1->contour_id != e2->contour_id)
    return e1->contour_id > e2->contour_id ? 1 : -1;
  return e1->sid > e2->sid ? 1 : -1;
}

// Status-line vertical order (boolean.py _compare_segments).
int compare_segments(const SweepEvent* le1, const SweepEvent* le2) {
  if (le1 == le2) return 0;
  if (sa_snap(le1->point, le1->other->point, le2->point) != 0.0 ||
      sa_snap(le1->point, le1->other->point, le2->other->point) != 0.0) {
    // Not collinear
    if (le1->point == le2->point)
      return is_below(le1, le2->other->point) ? -1 : 1;
    if (le1->point.x == le2->point.x)
      return le1->point.y < le2->point.y ? -1 : 1;
    if (compare_events(le1, le2) == 1) {
      // le1 inserted after le2: le1.point is the current sweep point.
      if (sa_snap(le2->point, le2->other->point, le1->point) == 0.0)
        return is_above(le2, le1->other->point) ? -1 : 1;
      return is_above(le2, le1->point) ? -1 : 1;
    }
    if (sa_snap(le1->point, le1->other->point, le2->point) == 0.0)
      return is_below(le1, le2->other->point) ? -1 : 1;
    return is_below(le1, le2->point) ? -1 : 1;
  }
  // Collinear
  if (le1->is_subject == le2->is_subject) {
    if (le1->point == le2->point) {
      if (le1->other->point == le2->other->point) {
        // Coincident same-operand seam pieces (interior-seam subdivision)
        // MUST order strictly: a 0 for distinct objects corrupts the
        // status line (behavioral parity with boolean.py).
        if (le1->contour_id != le2->contour_id)
          return le1->contour_id > le2->contour_id ? 1 : -1;
        return le1->sid > le2->sid ? 1 : -1;
      }
      if (le1->contour_id != le2->contour_id)
        return le1->contour_id > le2->contour_id ? 1 : -1;
      return compare_events(le1, le2) == 1 ? 1 : -1;
    }
  } else {
    return le1->is_subject ? -1 : 1;
  }
  return compare_events(le1, le2) == 1 ? 1 : -1;
}

// 0, 1 or 2 intersection points; endpoints snap exactly to the inputs.
// Collinearity uses the sa_snap lattice-noise band, not exact cross
// products: rounded endpoints bend exactly-collinear DIAGONAL segments
// ~1 unit, and an exact test routes them to the crossing branch with
// 1/sin(theta)-amplified position error (mirrors boolean.py, round-4c
// fix). The band test uses the longer segment's line.
int segment_intersection(const Pt& a1, const Pt& a2, const Pt& b1, const Pt& b2,
                         Pt out[2]) {
  const double vax = a2.x - a1.x, vay = a2.y - a1.y;
  const double vbx = b2.x - b1.x, vby = b2.y - b1.y;
  const double ex = b1.x - a1.x, ey = b1.y - a1.y;
  const double kross = vax * vby - vay * vbx;
  bool collinear;
  if (std::fabs(vax) + std::fabs(vay) >= std::fabs(vbx) + std::fabs(vby)) {
    collinear = sa_snap(a1, a2, b1) == 0.0 && sa_snap(a1, a2, b2) == 0.0;
  } else {
    collinear = sa_snap(b1, b2, a1) == 0.0 && sa_snap(b1, b2, a2) == 0.0;
  }
  if (!collinear) {
    if (kross == 0.0) return 0;  // parallel, outside the collinearity band
    const double s = (ex * vby - ey * vbx) / kross;
    if (s < 0.0 || s > 1.0) return 0;
    const double t = (ex * vay - ey * vax) / kross;
    if (t < 0.0 || t > 1.0) return 0;
    if (s == 0.0) { out[0] = a1; return 1; }
    if (s == 1.0) { out[0] = a2; return 1; }
    if (t == 0.0) { out[0] = b1; return 1; }
    if (t == 1.0) { out[0] = b2; return 1; }
    out[0] = Pt{a1.x + s * vax, a1.y + s * vay};
    return 1;
  }
  const double len2 = vax * vax + vay * vay;
  if (len2 == 0.0) return 0;
  const double s0 = (ex * vax + ey * vay) / len2;
  const double s1 = s0 + (vbx * vax + vby * vay) / len2;
  const double smin = std::min(s0, s1), smax = std::max(s0, s1);
  const double lo = std::max(0.0, smin), hi = std::min(1.0, smax);
  if (lo > hi) return 0;
  auto pt_at = [&](double s) -> Pt {
    if (s == 0.0) return a1;
    if (s == 1.0) return a2;
    if (s == s0) return b1;
    if (s == s1) return b2;
    return Pt{a1.x + s * vax, a1.y + s * vay};
  };
  if (lo == hi) { out[0] = pt_at(lo); return 1; }
  out[0] = pt_at(lo);
  out[1] = pt_at(hi);
  return 2;
}

struct EventCmpGreater {
  bool operator()(const SweepEvent* a, const SweepEvent* b) const {
    return compare_events(a, b) > 0;  // min-heap (heapq semantics)
  }
};

using Queue = std::priority_queue<SweepEvent*, std::vector<SweepEvent*>, EventCmpGreater>;

struct Engine {
  std::deque<SweepEvent> pool;  // pointer-stable storage

  SweepEvent* make(Pt p, bool left, SweepEvent* other, bool is_subject) {
    pool.emplace_back();
    SweepEvent* e = &pool.back();
    e->point = p;
    e->left = left;
    e->other = other;
    e->is_subject = is_subject;
    e->sid = static_cast<int64_t>(pool.size());  // creation order, like Python
    return e;
  }

  void divide_segment(SweepEvent* se, Pt p, Queue& queue) {
    SweepEvent* r = make(p, false, se, se->is_subject);
    SweepEvent* l = make(p, true, se->other, se->is_subject);
    r->contour_id = l->contour_id = se->contour_id;
    if (compare_events(l, se->other) > 0) {
      se->other->left = true;
      l->left = false;
    }
    se->other->other = l;
    se->other = r;
    queue.push(l);
    queue.push(r);
  }

  int possible_intersection(SweepEvent* se1, SweepEvent* se2, Queue& queue) {
    Pt inter[2];
    int n = segment_intersection(se1->point, se1->other->point, se2->point,
                                 se2->other->point, inter);
    if (n == 0) return 0;
    if (n == 1 && (se1->point == se2->point || se1->other->point == se2->other->point))
      return 0;  // shared endpoint only
    // n == 2 with a same-operand pair is NOT ignorable (behavioral parity
    // with boolean.py): members of one MultiPolygon abutting along part of
    // an edge must be subdivided like cross-operand overlaps, then the
    // coincident portion is an interior seam (boundary of nothing).
    const bool same_operand = se1->is_subject == se2->is_subject;
    if (n == 1) {
      // Banker's rounding == numpy round (FE_TONEAREST default).
      Pt p{std::nearbyint(inter[0].x), std::nearbyint(inter[0].y)};
      if (se1->point != p && se1->other->point != p && se2->point != p &&
          se2->other->point != p) {
        // Vertex-on-edge: an endpoint of one segment within 2
        // PERPENDICULAR lattice units of the other segment (inside its
        // span) IS the crossing — endpoint rounding displaces the
        // computed line-line crossing by O(1/sin theta) units. Mirrors
        // boolean.py _possible_intersection (round-4c fix: a triangle
        // vertex on the clipping edge dead-ended the contour walk and
        // union returned EMPTY).
        struct Cand { const Pt* q; const SweepEvent* a; const SweepEvent* b; };
        const Cand cands[4] = {{&se1->point, se2, se2->other},
                               {&se1->other->point, se2, se2->other},
                               {&se2->point, se1, se1->other},
                               {&se2->other->point, se1, se1->other}};
        const Pt* best = nullptr;
        double best_d = 2.0;
        for (const Cand& c : cands) {
          const double dx = c.b->point.x - c.a->point.x;
          const double dy = c.b->point.y - c.a->point.y;
          const double len2 = dx * dx + dy * dy;
          if (len2 == 0.0) continue;
          const double sa = (c.a->point.x - c.q->x) * (c.b->point.y - c.q->y) -
                            (c.b->point.x - c.q->x) * (c.a->point.y - c.q->y);
          const double d = std::fabs(sa) / std::sqrt(len2);
          if (d > best_d) continue;
          const double t = (c.q->x - c.a->point.x) * dx +
                           (c.q->y - c.a->point.y) * dy;
          const double slack = 2.0 * std::sqrt(len2);
          if (-slack <= t && t <= len2 + slack) {
            best = c.q;
            best_d = d;
          }
        }
        if (best != nullptr) {
          p = *best;
        } else {
          const Pt* snaps[4] = {&se1->point, &se1->other->point, &se2->point,
                                &se2->other->point};
          for (const Pt* q : snaps) {
            if (std::fabs(p.x - q->x) <= 2.0 && std::fabs(p.y - q->y) <= 2.0) {
              p = *q;
              break;
            }
          }
        }
      }
      if (se1->point != p && se1->other->point != p) divide_segment(se1, p, queue);
      if (se2->point != p && se2->other->point != p) divide_segment(se2, p, queue);
      return 1;
    }
    // Collinear overlap, opposite operands
    std::vector<SweepEvent*> events;
    const bool left_coincide = se1->point == se2->point;
    const bool right_coincide = se1->other->point == se2->other->point;
    if (!left_coincide) {
      if (compare_events(se1, se2) > 0) {
        events.push_back(se2);
        events.push_back(se1);
      } else {
        events.push_back(se1);
        events.push_back(se2);
      }
    }
    if (!right_coincide) {
      if (compare_events(se1->other, se2->other) > 0) {
        events.push_back(se2->other);
        events.push_back(se1->other);
      } else {
        events.push_back(se1->other);
        events.push_back(se2->other);
      }
    }
    if (left_coincide) {
      se2->type = NON_CONTRIBUTING;
      if (same_operand) {
        // Interior seam: drop both coincident edges from every result
        // (parity still counts both — net zero across the seam). in_out is
        // NOT consulted: same-operand parity is stale at marking time
        // (behavioral parity with boolean.py).
        se1->type = NON_CONTRIBUTING;
      } else {
        se1->type = (se2->in_out == se1->in_out) ? SAME_TRANSITION : DIFFERENT_TRANSITION;
      }
      if (!right_coincide) divide_segment(events[1]->other, events[0]->point, queue);
      return 2;
    }
    if (right_coincide) {
      divide_segment(events[0], events[1]->point, queue);
      return 3;
    }
    if (events[0] != events[3]->other) {
      divide_segment(events[0], events[1]->point, queue);
      divide_segment(events[1], events[2]->point, queue);
      return 3;
    }
    divide_segment(events[0], events[1]->point, queue);
    divide_segment(events[3]->other, events[2]->point, queue);
    return 3;
  }
};

bool in_result(const SweepEvent* event, int operation) {
  switch (event->type) {
    case NORMAL:
      switch (operation) {
        case INTERSECTION:
          return !event->other_in_out;
        case UNION:
          return event->other_in_out;
        case DIFFERENCE:
          return (event->is_subject && event->other_in_out) ||
                 (!event->is_subject && !event->other_in_out);
        default:
          return true;  // XOR
      }
    case SAME_TRANSITION:
      return operation == INTERSECTION || operation == UNION;
    case DIFFERENT_TRANSITION:
      return operation == DIFFERENCE;
    default:
      return false;  // NON_CONTRIBUTING
  }
}

int result_transition(const SweepEvent* event, int operation) {
  // Seam-typed events (coincident cross-operand edges): other_in_out is
  // stale on seams, so derive the transition from the seam type + own
  // parity (mirrors boolean.py _result_transition, round-4c fix: a hole
  // whose surrounding face starts on a seam was emitted as a standalone
  // positive face).
  if (event->type == SAME_TRANSITION)
    return event->in_out ? -1 : 1;  // result on the shared interior side
  if (event->type == DIFFERENT_TRANSITION) {
    if (event->is_subject) return event->in_out ? -1 : 1;
    return event->in_out ? 1 : -1;  // subject side = not clipping side
  }
  const bool this_in = !event->in_out;
  const bool that_in = !event->other_in_out;
  bool is_in;
  switch (operation) {
    case INTERSECTION:
      is_in = this_in && that_in;
      break;
    case UNION:
      is_in = this_in || that_in;
      break;
    case XOR:
      is_in = this_in != that_in;
      break;
    default:  // DIFFERENCE
      is_in = event->is_subject ? (this_in && !that_in) : (that_in && !this_in);
  }
  return is_in ? 1 : -1;
}

void compute_fields(SweepEvent* event, SweepEvent* prev, int operation) {
  if (prev == nullptr) {
    event->in_out = false;
    event->other_in_out = true;
  } else if (event->is_subject == prev->is_subject) {
    event->in_out = !prev->in_out;
    event->other_in_out = prev->other_in_out;
  } else {
    event->in_out = !prev->other_in_out;
    event->other_in_out = prev->is_vertical() ? !prev->in_out : prev->in_out;
  }
  if (prev != nullptr) {
    event->prev_in_result =
        (!in_result(prev, operation) || prev->is_vertical()) ? prev->prev_in_result
                                                             : prev;
  }
  event->result_transition =
      in_result(event, operation) ? result_transition(event, operation) : 0;
}

// Re-derive the SAME/DIFFERENT_TRANSITION marking of a left-coincide
// cross-operand overlap AFTER the caller refreshed both events' fields:
// at marking time inside possible_intersection the upper event's parity
// can predate an edge inserted below it since its own insertion, so the
// in_out comparison can mis-type the kept (lower) edge and union drops
// the whole face (round-5 pinwheel fuzz finding; mirrors boolean.py
// _remark_overlap). Both r==2 call sites pass se2 = the upper event,
// which carries NON_CONTRIBUTING — the kept edge is always the lower.
void remark_overlap(SweepEvent* lower, SweepEvent* upper, int operation) {
  if (lower->is_subject == upper->is_subject) return;
  if (upper->type != NON_CONTRIBUTING ||
      (lower->type != SAME_TRANSITION && lower->type != DIFFERENT_TRANSITION))
    return;
  lower->type =
      (upper->in_out == lower->in_out) ? SAME_TRANSITION : DIFFERENT_TRANSITION;
  lower->result_transition =
      in_result(lower, operation) ? result_transition(lower, operation) : 0;
  // upper's prev_in_result chains off lower's (possibly changed) in_result
  compute_fields(upper, lower, operation);
}

// Ordered active-segment list (boolean.py _StatusLine): binary insert,
// identity removal with neighbor-probe then linear-scan fallback.
struct StatusLine {
  std::vector<SweepEvent*> items;

  int insert(SweepEvent* ev) {
    int lo = 0, hi = static_cast<int>(items.size());
    while (lo < hi) {
      int mid = (lo + hi) / 2;
      if (compare_segments(items[mid], ev) < 0)
        lo = mid + 1;
      else
        hi = mid;
    }
    items.insert(items.begin() + lo, ev);
    return lo;
  }

  int index(SweepEvent* ev) const {
    int lo = 0, hi = static_cast<int>(items.size());
    while (lo < hi) {
      int mid = (lo + hi) / 2;
      if (items[mid] == ev) return mid;
      if (compare_segments(items[mid], ev) < 0)
        lo = mid + 1;
      else
        hi = mid;
    }
    for (int i = std::max(0, lo - 2);
         i < std::min(static_cast<int>(items.size()), lo + 3); ++i)
      if (items[i] == ev) return i;
    for (int i = 0; i < static_cast<int>(items.size()); ++i)
      if (items[i] == ev) return i;
    return -1;
  }

  void remove_at(int i) { items.erase(items.begin() + i); }
};

// The event seeding position pos's parity fields: the first NON-VERTICAL
// edge below it. Parity describes the cross-section just right of the
// sweep line; an upward ray at x+eps never crosses a vertical edge at x,
// so verticals are transparent for field chaining (mirrors the Python
// twin's _parity_prev — the one-step is_vertical corrections in
// compute_fields mis-sign an edge starting ON a vertical edge when the
// chain crosses operands; round-4c semantic-fuzz finding).
SweepEvent* parity_prev(const StatusLine& status, int pos) {
  int i = pos - 1;
  while (i >= 0 && status.items[i]->is_vertical()) --i;
  return i >= 0 ? status.items[i] : nullptr;
}

std::vector<SweepEvent*> subdivide(Engine& eng, Queue& queue, int operation,
                                   double s_maxx, double minmaxx) {
  StatusLine status;
  std::vector<SweepEvent*> sorted_events;
  while (!queue.empty()) {
    SweepEvent* event = queue.top();
    queue.pop();
    sorted_events.push_back(event);
    if ((operation == INTERSECTION && event->point.x > minmaxx) ||
        (operation == DIFFERENCE && event->point.x > s_maxx))
      break;
    if (event->left) {
      int pos = status.insert(event);
      SweepEvent* prev = pos > 0 ? status.items[pos - 1] : nullptr;
      SweepEvent* nxt = (pos + 1 < static_cast<int>(status.items.size()))
                            ? status.items[pos + 1]
                            : nullptr;
      compute_fields(event, parity_prev(status, pos), operation);
      int r_nxt = 0, r_prev = 0;
      if (nxt != nullptr) {
        r_nxt = eng.possible_intersection(event, nxt, queue);
        if (r_nxt == 2) {
          compute_fields(event, parity_prev(status, pos), operation);
          compute_fields(nxt, event, operation);
          remark_overlap(event, nxt, operation);
        }
      }
      if (prev != nullptr) {
        r_prev = eng.possible_intersection(prev, event, queue);
        if (r_prev == 2) {
          int i = status.index(prev);
          compute_fields(prev, parity_prev(status, i), operation);
          compute_fields(event, prev, operation);
          remark_overlap(prev, event, operation);
        }
      }
      // Tangential vertex-on-edge touch AT this event's left endpoint: the
      // intersection test split a neighbor exactly at event->point, so the
      // neighbor now ENDS here and its parity fields describe the
      // cross-section LEFT of this point — chaining off it is stale
      // (boolean.py _subdivide, same fix: a box corner lying ON a needle
      // operand's edge dropped a 0.5-area face from union/difference).
      // Re-queue this event: the heap replays it after the neighbor's
      // right event here (right-before-left) and after its continuation
      // piece (bottom-first), so the re-insert chains off fresh fields.
      // With >=3 edges concurrent at one vertex the replay can split a
      // DIFFERENT edge at the same point, so requeue on every fresh
      // split-at-own-point; each requeue consumes one distinct edge
      // through the point (its continuation then shares the endpoint), so
      // a counter capped by the status size bounds termination without
      // ever binding on correct input (Python twin: boolean.py).
      if (event->touch_requeues <= static_cast<int>(status.items.size()) &&
          ((r_prev == 1 && prev->other->point == event->point) ||
           (r_nxt == 1 && nxt->other->point == event->point))) {
        int i = status.index(event);
        if (i >= 0) status.remove_at(i);
        sorted_events.pop_back();
        event->touch_requeues += 1;
        queue.push(event);
        continue;
      }
    } else {
      SweepEvent* le = event->other;
      int i = status.index(le);
      if (i >= 0) {
        SweepEvent* prev = i > 0 ? status.items[i - 1] : nullptr;
        SweepEvent* nxt = (i + 1 < static_cast<int>(status.items.size()))
                              ? status.items[i + 1]
                              : nullptr;
        status.remove_at(i);
        if (prev != nullptr && nxt != nullptr)
          eng.possible_intersection(prev, nxt, queue);
      }
    }
  }
  return sorted_events;
}

// Cancel IDENTICAL result segments with opposite transitions — zero-width
// seam slits left by snap degeneracies (mirrors boolean.py
// _cancel_seam_twins; round-5 pinched-donut fuzz). Crossing both twins
// leaves parity unchanged, so each (+1,-1) pair cancels exactly;
// prev_in_result pointers re-chain through cancelled twins.
void cancel_seam_twins(const std::vector<SweepEvent*>& sorted_events) {
  std::map<std::tuple<double, double, double, double>,
           std::vector<SweepEvent*>> groups;
  for (SweepEvent* ev : sorted_events) {
    if (ev->left && ev->in_result()) {
      groups[std::make_tuple(ev->point.x, ev->point.y, ev->other->point.x,
                             ev->other->point.y)]
          .push_back(ev);
    }
  }
  std::set<const SweepEvent*> cancelled;
  for (auto& kv : groups) {
    auto& evs = kv.second;
    if (evs.size() < 2) continue;
    std::vector<SweepEvent*> pos, neg;
    for (SweepEvent* e : evs) {
      (e->result_transition > 0 ? pos : neg).push_back(e);
    }
    const size_t k = std::min(pos.size(), neg.size());
    for (size_t i = 0; i < k; ++i) {
      pos[i]->result_transition = 0;
      neg[i]->result_transition = 0;
      cancelled.insert(pos[i]);
      cancelled.insert(neg[i]);
    }
  }
  if (cancelled.empty()) return;
  for (SweepEvent* ev : sorted_events) {
    SweepEvent* p = ev->prev_in_result;
    while (p != nullptr && cancelled.count(p)) p = p->prev_in_result;
    ev->prev_in_result = p;
  }
}

std::vector<SweepEvent*> order_events(const std::vector<SweepEvent*>& sorted_events) {
  std::vector<SweepEvent*> result;
  for (SweepEvent* ev : sorted_events) {
    if ((ev->left && ev->in_result()) || (!ev->left && ev->other->in_result()))
      result.push_back(ev);
  }
  // Overlapping-edge splits can leave the list slightly unsorted; the
  // comparator is a strict total order, so a real sort is safe (the old
  // exchange-sort loop span forever on comparator cycles).
  std::stable_sort(result.begin(), result.end(),
                   [](const SweepEvent* a, const SweepEvent* b) {
                     return compare_events(a, b) < 0;
                   });
  for (size_t i = 0; i < result.size(); ++i) result[i]->pos = static_cast<int>(i);
  for (SweepEvent* ev : result) {
    if (!ev->left) std::swap(ev->pos, ev->other->pos);
  }
  return result;
}

// Clockwise angular rank of u relative to r (boolean.py _cw_class / _cw_before).
inline int cw_class(const Pt& r, const Pt& u) {
  const double c = r.x * u.y - r.y * u.x;
  if (c < 0) return 0;
  if (c > 0) return 2;
  const double d = r.x * u.x + r.y * u.y;
  return d < 0 ? 1 : 3;
}

inline bool cw_before(const Pt& r, const Pt& u, const Pt& v) {
  const int ku = cw_class(r, u), kv = cw_class(r, v);
  if (ku != kv) return ku < kv;
  if (ku == 1 || ku == 3) return false;  // exact angular tie
  return (u.x * v.y - u.y * v.x) < 0;
}

int next_pos(int pos, const std::vector<SweepEvent*>& result,
             const std::vector<char>& processed, int orig) {
  const Pt p = result[pos]->point;
  const int n = static_cast<int>(result.size());
  std::vector<int> cands;
  for (int j = pos + 1; j < n && result[j]->point == p; ++j)
    if (!processed[j]) cands.push_back(j);
  for (int j = pos - 1; j >= 0 && result[j]->point == p; --j)
    if (!processed[j]) cands.push_back(j);
  if (cands.empty()) return orig;
  const bool at_start = result[orig]->point == p;
  if (!at_start && cands.size() == 1) return cands[0];
  const Pt prev_pt = result[pos]->other->point;
  const Pt r{prev_pt.x - p.x, prev_pt.y - p.y};
  int best = cands[0];
  Pt o = result[best]->other->point;
  Pt best_u{o.x - p.x, o.y - p.y};
  for (size_t ci = 1; ci < cands.size(); ++ci) {
    o = result[cands[ci]]->other->point;
    const Pt u{o.x - p.x, o.y - p.y};
    if (cw_before(r, u, best_u)) {
      best = cands[ci];
      best_u = u;
    }
  }
  if (at_start) {
    o = result[orig]->other->point;
    const Pt u0{o.x - p.x, o.y - p.y};
    if (!cw_before(r, best_u, u0)) return orig;
  }
  return best;
}

struct Contour {
  std::vector<Pt> points;
  int hole_of = -1;  // parent contour id, or -1 for a shell
  int depth = 0;
};

Contour initialize_contour(const SweepEvent* event, std::vector<Contour>& contours,
                           int cid) {
  Contour contour;
  if (event->prev_in_result != nullptr) {
    const SweepEvent* lower = event->prev_in_result;
    const int lower_cid = lower->output_contour_id;
    if (lower_cid < 0) {
      // lower's ring not walked yet (sub-lattice degeneracies): no parent —
      // indexing contours[-1] here would be out-of-bounds UB.
    } else if (lower->result_transition > 0) {
      const Contour& lower_contour = contours[lower_cid];
      if (lower_contour.hole_of >= 0) {
        const int parent = lower_contour.hole_of;
        contour.hole_of = parent;
        contour.depth = lower_contour.depth;
      } else {
        contour.hole_of = lower_cid;
        contour.depth = lower_contour.depth + 1;
      }
    } else {
      contour.hole_of = -1;
      contour.depth = lower_cid >= 0 ? contours[lower_cid].depth : 0;
    }
  }
  return contour;
}

std::vector<Contour> connect_edges(const std::vector<SweepEvent*>& sorted_events) {
  cancel_seam_twins(sorted_events);
  std::vector<SweepEvent*> result = order_events(sorted_events);
  const int n = static_cast<int>(result.size());
  std::vector<char> processed(n, 0);
  std::vector<Contour> contours;
  for (int i = 0; i < n; ++i) {
    if (processed[i]) continue;
    const int cid = static_cast<int>(contours.size());
    contours.push_back(initialize_contour(result[i], contours, cid));
    Contour& contour = contours.back();
    int pos = i;
    contour.points.push_back(result[i]->point);
    while (true) {
      processed[pos] = 1;
      result[pos]->output_contour_id = cid;
      pos = result[pos]->pos;
      processed[pos] = 1;
      result[pos]->output_contour_id = cid;
      contour.points.push_back(result[pos]->point);
      pos = next_pos(pos, result, processed, i);
      if (pos == i || pos >= n || pos < 0) break;
    }
  }
  return contours;
}

struct BoolResult {
  std::vector<Contour> contours;
};

}  // namespace

extern "C" {

// rings: flat xy array; ring_sizes[i] = point count of ring i (unclosed or
// closed — a closing duplicate point is stripped, matching _fill_queue).
// Returns an opaque handle (never null; empty result has 0 contours).
void* aq_bool_op(const double* subj_xy, const int32_t* subj_sizes, int32_t subj_nrings,
                 const double* clip_xy, const int32_t* clip_sizes, int32_t clip_nrings,
                 int32_t op, double s_maxx, double minmaxx) {
  Engine eng;
  Queue queue;
  int contour_id = 0;
  const double* xys[2] = {subj_xy, clip_xy};
  const int32_t* sizes[2] = {subj_sizes, clip_sizes};
  const int32_t nrings[2] = {subj_nrings, clip_nrings};
  for (int s = 0; s < 2; ++s) {
    const bool is_subject = (s == 0);
    const double* xy = xys[s];
    for (int32_t ri = 0; ri < nrings[s]; ++ri) {
      ++contour_id;
      int32_t npts = sizes[s][ri];
      const double* base = xy;
      xy += 2 * npts;
      if (npts >= 2 && base[0] == base[2 * (npts - 1)] &&
          base[1] == base[2 * (npts - 1) + 1])
        --npts;  // strip closing duplicate
      if (npts < 3) continue;
      // Drop zero-area rings (degenerate holes / snap-collapsed slivers):
      // their back-and-forth edges desynchronize in_out parity and
      // corrupt difference/xor. Exact: lattice coords are integers
      // <= 2^26, so each i128 term and the sum are exact. Mirrors
      // boolean.py _fill_queue (round-4c fix).
      __int128 area2 = 0;
      for (int32_t i = 0; i < npts; ++i) {
        const int32_t j = (i + 1) % npts;
        const __int128 x1 = (int64_t)base[2 * i], y1 = (int64_t)base[2 * i + 1];
        const __int128 x2 = (int64_t)base[2 * j], y2 = (int64_t)base[2 * j + 1];
        area2 += x1 * y2 - x2 * y1;
      }
      if (area2 == 0) continue;
      for (int32_t i = 0; i < npts; ++i) {
        const Pt p1{base[2 * i], base[2 * i + 1]};
        const int32_t j = (i + 1) % npts;
        const Pt p2{base[2 * j], base[2 * j + 1]};
        if (p1 == p2) continue;  // zero-length edge
        SweepEvent* e1 = eng.make(p1, false, nullptr, is_subject);
        SweepEvent* e2 = eng.make(p2, false, e1, is_subject);
        e1->other = e2;
        e1->contour_id = e2->contour_id = contour_id;
        if (compare_events(e1, e2) < 0)
          e1->left = true;
        else
          e2->left = true;
        queue.push(e1);
        queue.push(e2);
      }
    }
  }
  std::vector<SweepEvent*> sorted_events = subdivide(eng, queue, op, s_maxx, minmaxx);
  auto* res = new BoolResult();
  res->contours = connect_edges(sorted_events);
  return res;
}

int32_t aq_bool_ncontours(void* handle) {
  return static_cast<int32_t>(static_cast<BoolResult*>(handle)->contours.size());
}

// Fills npoints and hole_of for contour i; returns 0 on success.
int32_t aq_bool_contour(void* handle, int32_t i, int32_t* npoints, int32_t* hole_of) {
  auto* res = static_cast<BoolResult*>(handle);
  if (i < 0 || i >= static_cast<int32_t>(res->contours.size())) return -1;
  *npoints = static_cast<int32_t>(res->contours[i].points.size());
  *hole_of = res->contours[i].hole_of;
  return 0;
}

int32_t aq_bool_points(void* handle, int32_t i, double* out_xy) {
  auto* res = static_cast<BoolResult*>(handle);
  if (i < 0 || i >= static_cast<int32_t>(res->contours.size())) return -1;
  const auto& pts = res->contours[i].points;
  for (size_t j = 0; j < pts.size(); ++j) {
    out_xy[2 * j] = pts[j].x;
    out_xy[2 * j + 1] = pts[j].y;
  }
  return 0;
}

void aq_bool_free(void* handle) { delete static_cast<BoolResult*>(handle); }

}  // extern "C"
