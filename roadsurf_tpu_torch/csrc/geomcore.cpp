// geomcore — the port's host geometry core (host C++, not a device kernel).
//
// A copy of the reference package's roadsurf_tpu/geom/native/geomcore.cpp:
// the sweep-line boolean operations (Martinez–Rueda–Feito, "A new algorithm
// for computing Boolean operations on polygons", 2009, with the
// overlap-handling refinements of the martinez JS package), the cascaded
// union, line and polygon buffers, point-in-polygon-set and polygon-set
// intersection tests, the even-odd polygon fill of the training loader
// (geom_rasterize) and the mask boundary tracer of the detection host stage
// (geom_trace_mask). Built with the host C++ compiler by geom/_native.py and
// loaded with ctypes.
//
// Changes from the reference, each for a configuration the reference
// computes wrong. For a vertex of one polygon that lies on an edge or a
// vertex of the other (what every de-overlap cut of the label preparation
// leaves behind): the clipping set's vertices within a few ulps of a subject
// vertex become that vertex (unifyVertices), a crossing computed within a
// few ulps of a vertex is that vertex (snapVertex), an edge that starts on
// the interior of a neighbour's edge is sorted again once the neighbour is
// split there (Martinez::subdivide), and an edge another edge runs along
// from a vertex on its interior is split at that vertex before the sweep
// (splitAtVertices). A zero-width spike that runs along the other operand's
// edge is dropped before the sweep (removeSpikes). buffer(0) of a polygon
// whose hole leaves its shell is the shell minus its holes, not the
// even-odd reading of the rings (shellsMinusHoles). Every other line
// computes what the reference computes, so results agree bit for bit
// wherever the reference's are right.
//
// C ABI (ctypes-friendly). A polygon *set* (multipolygon with holes) is
// passed as:
//   xy          : double[2*total_points]  (rings are implicitly closed; the
//                                          closing point may be present or not)
//   ring_sizes  : int32[nrings]           (points per ring)
//   poly_rings  : int32[npolys]           (rings per polygon; first ring of a
//                                          polygon is the exterior shell)
// Results are returned through an opaque handle + accessors, freed by caller.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <queue>
#include <set>
#include <vector>

namespace {

struct Pt {
  double x, y;
  bool operator==(const Pt& o) const { return x == o.x && y == o.y; }
  bool operator!=(const Pt& o) const { return !(*this == o); }
};

// Snap-rounding grid. All input coordinates and computed intersection points
// are rounded to multiples of SNAP, which keeps the sweep-line comparators
// consistent in near-degenerate configurations (vertex-on-edge, slivers).
// 1e-9 is far below any geodetic/metric precision the pipeline needs.
static const double SNAP = 1e-9;
static inline double snap1(double v) { return std::round(v / SNAP) * SNAP; }
static inline Pt snapPt(const Pt& p) { return Pt{snap1(p.x), snap1(p.y)}; }

static inline double signedArea(const Pt& p0, const Pt& p1, const Pt& p2) {
  return (p0.x - p2.x) * (p1.y - p2.y) - (p1.x - p2.x) * (p0.y - p2.y);
}

enum Op { OP_INTERSECTION = 0, OP_UNION = 1, OP_DIFFERENCE = 2, OP_XOR = 3 };
enum EdgeType { NORMAL, NON_CONTRIBUTING, SAME_TRANSITION, DIFFERENT_TRANSITION };

struct SweepEvent {
  Pt point;
  bool left = false;
  SweepEvent* otherEvent = nullptr;
  bool isSubject = false;
  EdgeType type = NORMAL;
  bool inOut = false;
  bool otherInOut = false;
  SweepEvent* prevInResult = nullptr;
  int resultTransition = 0;  // 0 = not in result; +1 in->out below; -1 out->in
  int contourId = 0;
  int outputContourId = -1;
  int pos = 0;
  bool isExteriorRing = true;

  bool inResult() const { return resultTransition != 0; }
  bool isBelow(const Pt& p) const {
    return left ? signedArea(point, otherEvent->point, p) > 0
                : signedArea(otherEvent->point, point, p) > 0;
  }
  bool isAbove(const Pt& p) const { return !isBelow(p); }
  bool isVertical() const { return point.x == otherEvent->point.x; }
};

// ---------------------------------------------------------------------------
// event ordering (priority queue order: x, then y, right-before-left, below-first)

static int compareEvents(const SweepEvent* e1, const SweepEvent* e2) {
  const Pt& p1 = e1->point;
  const Pt& p2 = e2->point;
  if (p1.x > p2.x) return 1;
  if (p1.x < p2.x) return -1;
  if (p1.y != p2.y) return p1.y > p2.y ? 1 : -1;
  // same point
  if (e1->left != e2->left) return e1->left ? 1 : -1;
  if (signedArea(p1, e1->otherEvent->point, e2->otherEvent->point) != 0.0) {
    return !e1->isBelow(e2->otherEvent->point) ? 1 : -1;
  }
  return (!e1->isSubject && e2->isSubject) ? 1 : -1;
}

struct EventGreater {
  bool operator()(const SweepEvent* a, const SweepEvent* b) const {
    int c = compareEvents(a, b);
    if (c != 0) return c > 0;
    return a > b;
  }
};

// sweep-line status order: lower segment first
static int compareSegments(const SweepEvent* le1, const SweepEvent* le2) {
  if (le1 == le2) return 0;
  if (signedArea(le1->point, le1->otherEvent->point, le2->point) != 0.0 ||
      signedArea(le1->point, le1->otherEvent->point, le2->otherEvent->point) != 0.0) {
    // not collinear
    if (le1->point == le2->point)
      return le1->isBelow(le2->otherEvent->point) ? -1 : 1;
    if (le1->point.x == le2->point.x)
      return le1->point.y < le2->point.y ? -1 : 1;
    if (compareEvents(le1, le2) == 1)  // le2 inserted first
      return le2->isAbove(le1->point) ? -1 : 1;
    return le1->isBelow(le2->point) ? -1 : 1;
  }
  // collinear
  if (le1->isSubject == le2->isSubject) {
    if (le1->point == le2->point) {
      if (le1->otherEvent->point == le2->otherEvent->point) {
        return le1 < le2 ? -1 : 1;  // total-order fallback
      }
      return le1->contourId > le2->contourId ? 1 : -1;
    }
  } else {
    return le1->isSubject ? -1 : 1;
  }
  return compareEvents(le1, le2) == 1 ? 1 : -1;
}

struct SegmentLess {
  bool operator()(const SweepEvent* a, const SweepEvent* b) const {
    return compareSegments(a, b) < 0;
  }
};

// ---------------------------------------------------------------------------
// segment intersection (double arithmetic, endpoint-exact as in martinez js)

static inline double crossP(double ax, double ay, double bx, double by) {
  return ax * by - ay * bx;
}

// The port's vertex snap (the second change from the reference): a crossing
// computed within snapTol of an endpoint of either segment is that
// endpoint. The reference keeps the rounded point, which then lies a
// nanometre or two from the vertex (where a vertex of one polygon lies on
// an edge of the other and t or s rounds off 0 or 1): both edges are split
// there, the vertex's own edge into a segment a few snap units long, and
// the sweep orders such segments inconsistently, so an edge's right event
// no longer finds its left event in the sweep line and the stale edge
// corrupts every field computed beside it. Snapped to the vertex, the
// crossing is the exact T-junction that Martinez::subdivide repairs.
// 8 units in the last place of the larger coordinate: two steps of the 1e-9
// snap grid at LV95 coordinates (~2.6e6, where a step is two ulps), where
// rounding leaves a vertex and a point computed onto it; ~1e-14 near the
// origin, so no distinct vertex of small coordinates is merged.
static inline double snapTol(const Pt& p) {
  double m = std::max(std::fabs(p.x), std::fabs(p.y));
  return 8.0 * (std::nextafter(m, HUGE_VAL) - m);
}

static inline Pt snapVertex(const Pt& p, const Pt& a1, const Pt& a2,
                            const Pt& b1, const Pt& b2) {
  const Pt* best = nullptr;
  double bestd = snapTol(p);
  for (const Pt* q : {&a1, &a2, &b1, &b2}) {
    double d = std::max(std::fabs(p.x - q->x), std::fabs(p.y - q->y));
    if (d <= bestd) {
      best = q;
      bestd = d;
    }
  }
  return best ? *best : p;
}

static int segmentIntersection(const Pt& a1, const Pt& a2, const Pt& b1,
                               const Pt& b2, Pt out[2]) {
  const double vax = a2.x - a1.x, vay = a2.y - a1.y;
  const double vbx = b2.x - b1.x, vby = b2.y - b1.y;
  const double ex = b1.x - a1.x, ey = b1.y - a1.y;
  double kross = crossP(vax, vay, vbx, vby);
  const double sqrLenA = vax * vax + vay * vay;
  if (kross * kross > 0.0) {
    const double s = crossP(ex, ey, vbx, vby) / kross;
    if (s < 0.0 || s > 1.0) return 0;
    const double t = crossP(ex, ey, vax, vay) / kross;
    if (t < 0.0 || t > 1.0) return 0;
    Pt p;
    if (s == 0.0) p = a1;
    else if (s == 1.0) p = a2;
    else if (t == 0.0) p = b1;
    else if (t == 1.0) p = b2;
    else p = snapVertex(snapPt(Pt{a1.x + s * vax, a1.y + s * vay}),
                        a1, a2, b1, b2);
    out[0] = p;
    return 1;
  }
  // parallel
  kross = crossP(ex, ey, vax, vay);
  if (kross * kross > 0.0) return 0;  // parallel, not collinear
  // collinear: project b endpoints onto a
  const double sa = (vax * ex + vay * ey) / sqrLenA;
  const double sb = sa + (vax * vbx + vay * vby) / sqrLenA;
  const double smin = std::min(sa, sb), smax = std::max(sa, sb);
  if (smin <= 1.0 && smax >= 0.0) {
    double lo = std::max(smin, 0.0), hi = std::min(smax, 1.0);
    auto at = [&](double s) -> Pt {
      if (s == 0.0) return a1;
      if (s == 1.0) return a2;
      if (s == sa) return b1;
      if (s == sb) return b2;
      return snapPt(Pt{a1.x + s * vax, a1.y + s * vay});
    };
    if (lo == hi) { out[0] = at(lo); return 1; }
    out[0] = at(lo);
    out[1] = at(hi);
    return 2;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// the boolean-op machine

struct PolySet {
  // rings[i] = vector of points (not closed)
  std::vector<std::vector<Pt>> rings;
  std::vector<int> poly_ring_counts;  // rings per polygon
  double minx = 1e300, miny = 1e300, maxx = -1e300, maxy = -1e300;

  void updateBBox() {
    minx = miny = 1e300;
    maxx = maxy = -1e300;
    for (auto& r : rings)
      for (auto& p : r) {
        minx = std::min(minx, p.x);
        miny = std::min(miny, p.y);
        maxx = std::max(maxx, p.x);
        maxy = std::max(maxy, p.y);
      }
  }
  bool empty() const {
    for (auto& r : rings)
      if (r.size() >= 3) return false;
    return true;
  }
};

struct Contour {
  std::vector<Pt> points;
  std::vector<int> holeIds;
  int holeOf = -1;
  int depth = 0;
};

class Martinez {
 public:
  Martinez(const PolySet& subj, const PolySet& clip, Op op)
      : subject(subj), clipping(clip), operation(op) {}

  std::vector<Contour> run() {
    fillQueue();
    subdivide();
    return connectEdges();
  }

 private:
  const PolySet& subject;
  const PolySet& clipping;
  Op operation;
  std::deque<SweepEvent> arena;
  std::priority_queue<SweepEvent*, std::vector<SweepEvent*>, EventGreater> eq;
  std::vector<SweepEvent*> sortedEvents;
  double rightbound = 0;

  SweepEvent* newEvent(const Pt& p, bool left, SweepEvent* other, bool isSubject) {
    arena.push_back(SweepEvent{});
    SweepEvent* e = &arena.back();
    e->point = p;
    e->left = left;
    e->otherEvent = other;
    e->isSubject = isSubject;
    return e;
  }

  void processRing(const std::vector<Pt>& ring, bool isSubject, int contourId,
                   bool isExteriorRing) {
    size_t n = ring.size();
    for (size_t i = 0; i < n; i++) {
      const Pt& s1 = ring[i];
      const Pt& s2 = ring[(i + 1) % n];
      if (s1 == s2) continue;
      SweepEvent* e1 = newEvent(s1, false, nullptr, isSubject);
      SweepEvent* e2 = newEvent(s2, false, e1, isSubject);
      e1->otherEvent = e2;
      e1->contourId = e2->contourId = contourId;
      e1->isExteriorRing = e2->isExteriorRing = isExteriorRing;
      if (compareEvents(e1, e2) > 0) e2->left = true;
      else e1->left = true;
      eq.push(e1);
      eq.push(e2);
    }
  }

  void fillQueue() {
    int contourId = 0;
    size_t ri = 0;
    for (int pc : subject.poly_ring_counts) {
      contourId++;
      for (int k = 0; k < pc; k++, ri++)
        processRing(subject.rings[ri], true, contourId, k == 0);
    }
    ri = 0;
    for (int pc : clipping.poly_ring_counts) {
      contourId++;
      for (int k = 0; k < pc; k++, ri++)
        processRing(clipping.rings[ri], false, contourId, k == 0);
    }
    rightbound = std::min(subject.maxx, clipping.maxx);
  }

  void divideSegment(SweepEvent* se, const Pt& p) {
    SweepEvent* r = newEvent(p, false, se, se->isSubject);
    SweepEvent* l = newEvent(p, true, se->otherEvent, se->isSubject);
    r->contourId = l->contourId = se->contourId;
    r->isExteriorRing = l->isExteriorRing = se->isExteriorRing;
    if (compareEvents(l, se->otherEvent) > 0) {  // rounding degeneracy guard
      se->otherEvent->left = true;
      l->left = false;
    }
    se->otherEvent->otherEvent = l;
    se->otherEvent = r;
    eq.push(l);
    eq.push(r);
  }

  // 0: no subdivision, 1: crossing subdivided, 2: overlap left-coincident,
  // 3: overlap other
  int possibleIntersection(SweepEvent* se1, SweepEvent* se2) {
    Pt inter[2];
    int n = segmentIntersection(se1->point, se1->otherEvent->point, se2->point,
                                se2->otherEvent->point, inter);
    if (n == 0) return 0;
    if (n == 1 && (se1->point == se2->point ||
                   se1->otherEvent->point == se2->otherEvent->point))
      return 0;  // share an endpoint only
    if (n == 2 && se1->isSubject == se2->isSubject) return 0;  // same-poly overlap

    if (n == 1) {
      if (se1->point != inter[0] && se1->otherEvent->point != inter[0])
        divideSegment(se1, inter[0]);
      if (se2->point != inter[0] && se2->otherEvent->point != inter[0])
        divideSegment(se2, inter[0]);
      return 1;
    }

    // overlapping segments from different polygon sets
    std::vector<SweepEvent*> events;
    bool leftCoincide = false, rightCoincide = false;
    if (se1->point == se2->point) leftCoincide = true;
    else if (compareEvents(se1, se2) == 1) { events.push_back(se2); events.push_back(se1); }
    else { events.push_back(se1); events.push_back(se2); }
    if (se1->otherEvent->point == se2->otherEvent->point) rightCoincide = true;
    else if (compareEvents(se1->otherEvent, se2->otherEvent) == 1) {
      events.push_back(se2->otherEvent); events.push_back(se1->otherEvent);
    } else {
      events.push_back(se1->otherEvent); events.push_back(se2->otherEvent);
    }

    if ((leftCoincide && rightCoincide) || leftCoincide) {
      se2->type = NON_CONTRIBUTING;
      se1->type = (se2->inOut == se1->inOut) ? SAME_TRANSITION : DIFFERENT_TRANSITION;
      if (leftCoincide && !rightCoincide)
        divideSegment(events[1]->otherEvent, events[0]->point);
      return 2;
    }
    if (rightCoincide) {
      divideSegment(events[0], events[1]->point);
      return 3;
    }
    if (events[0] != events[3]->otherEvent) {
      divideSegment(events[0], events[1]->point);
      divideSegment(events[1], events[2]->point);
      return 3;
    }
    divideSegment(events[0], events[1]->point);
    divideSegment(events[3]->otherEvent, events[2]->point);
    return 3;
  }

  bool inResultFilter(const SweepEvent* e) const {
    switch (e->type) {
      case NORMAL:
        switch (operation) {
          case OP_INTERSECTION: return !e->otherInOut;
          case OP_UNION: return e->otherInOut;
          case OP_DIFFERENCE:
            return (e->isSubject && e->otherInOut) ||
                   (!e->isSubject && !e->otherInOut);
          case OP_XOR: return true;
        }
        break;
      case SAME_TRANSITION:
        return operation == OP_INTERSECTION || operation == OP_UNION;
      case DIFFERENT_TRANSITION:
        return operation == OP_DIFFERENCE;
      case NON_CONTRIBUTING:
        return false;
    }
    return false;
  }

  int resultTransitionOf(const SweepEvent* e) const {
    bool thisIn = !e->inOut;
    bool thatIn = !e->otherInOut;
    bool isIn = false;
    switch (operation) {
      case OP_INTERSECTION: isIn = thisIn && thatIn; break;
      case OP_UNION: isIn = thisIn || thatIn; break;
      case OP_XOR: isIn = thisIn != thatIn; break;
      case OP_DIFFERENCE:
        isIn = e->isSubject ? (thisIn && !thatIn) : (thatIn && !thisIn);
        break;
    }
    return isIn ? 1 : -1;
  }

  void computeFields(SweepEvent* e, SweepEvent* prev) {
    if (prev == nullptr) {
      e->inOut = false;
      e->otherInOut = true;
    } else {
      if (e->isSubject == prev->isSubject) {
        e->inOut = !prev->inOut;
        e->otherInOut = prev->otherInOut;
      } else {
        e->inOut = !prev->otherInOut;
        e->otherInOut = prev->isVertical() ? !prev->inOut : prev->inOut;
      }
      e->prevInResult =
          (!inResultFilter(prev) || prev->isVertical()) ? prev->prevInResult : prev;
    }
    bool inRes = inResultFilter(e);
    e->resultTransition = inRes ? resultTransitionOf(e) : 0;
  }

  void subdivide() {
    std::set<SweepEvent*, SegmentLess> sl;
    const double sbbox_maxx = subject.maxx;
    while (!eq.empty()) {
      SweepEvent* event = eq.top();
      eq.pop();
      if ((operation == OP_INTERSECTION && event->point.x > rightbound) ||
          (operation == OP_DIFFERENCE && event->point.x > sbbox_maxx))
        break;
      sortedEvents.push_back(event);

      if (event->left) {
        auto it = sl.insert(event).first;
        auto next = std::next(it);
        auto prevIt = it;
        SweepEvent* prevEv =
            (it == sl.begin()) ? nullptr : *std::prev(prevIt);
        computeFields(event, prevEv);
        // T-junction repair (the one change from the reference). When the
        // new edge starts on the interior of a neighbour's edge (a vertex
        // of one polygon lying on an edge of the other), its place beside
        // that neighbour was decided by the sign of signedArea(neighbour,
        // vertex), a rounding residue of a value that is zero in the
        // geometry, and computeFields took the neighbour as the edge below
        // whatever the new edge's direction. possibleIntersection then
        // splits the neighbour at the vertex, so the new edge starts where
        // the two halves meet, but its fields were never recomputed: every
        // later edge of its polygon inherits the wrong inside/outside flag
        // (a polygon that only touches the other came back inside it, so
        // p2 - p1 was empty and p1 - p2 grew). The repair takes the event
        // out of the sweep and queues it again: the neighbour's left half
        // ends at the vertex and, being a right event there, leaves first;
        // the event is then ordered against the edges that start at the
        // vertex by its other end, and its fields come from its true
        // neighbour below.
        // Only a split made here counts (the neighbour's right end is a
        // new event at the vertex): a neighbour that merely ends there
        // leaves no stale fields, and re-queueing for it would not end.
        bool requeue = false;
        if (next != sl.end()) {
          SweepEvent* nextEv = *next;
          SweepEvent* nextEnd = nextEv->otherEvent;
          int r = possibleIntersection(event, nextEv);
          if (r == 2) {
            computeFields(event, prevEv);
            computeFields(nextEv, event);
          } else if (r == 1 && nextEv->otherEvent != nextEnd &&
                     nextEv->otherEvent->point == event->point) {
            requeue = true;
          }
        }
        if (prevEv != nullptr) {
          SweepEvent* prevEnd = prevEv->otherEvent;
          int r = possibleIntersection(prevEv, event);
          if (r == 2) {
            auto prevOfPrev = sl.find(prevEv);
            SweepEvent* pp = (prevOfPrev == sl.begin())
                                 ? nullptr
                                 : *std::prev(prevOfPrev);
            computeFields(prevEv, pp);
            computeFields(event, prevEv);
          } else if (r == 1 && prevEv->otherEvent != prevEnd &&
                     prevEv->otherEvent->point == event->point) {
            requeue = true;
          }
        }
        if (requeue) {
          sl.erase(it);
          sortedEvents.pop_back();
          eq.push(event);
        }
      } else {
        SweepEvent* leftEv = event->otherEvent;
        auto it = sl.find(leftEv);
        if (it != sl.end()) {
          SweepEvent* prevEv = (it == sl.begin()) ? nullptr : *std::prev(it);
          auto next = std::next(it);
          SweepEvent* nextEv = (next == sl.end()) ? nullptr : *next;
          sl.erase(it);
          if (nextEv && prevEv) possibleIntersection(prevEv, nextEv);
        }
      }
    }
  }

  std::vector<SweepEvent*> orderEvents() {
    std::vector<SweepEvent*> resultEvents;
    for (SweepEvent* ev : sortedEvents) {
      if ((ev->left && ev->inResult()) ||
          (!ev->left && ev->otherEvent->inResult()))
        resultEvents.push_back(ev);
    }
    // insertion-type sort: events may be out of order after subdivision
    bool sorted = false;
    while (!sorted) {
      sorted = true;
      for (size_t i = 0; i + 1 < resultEvents.size(); i++) {
        if (compareEvents(resultEvents[i], resultEvents[i + 1]) == 1) {
          std::swap(resultEvents[i], resultEvents[i + 1]);
          sorted = false;
        }
      }
    }
    for (size_t i = 0; i < resultEvents.size(); i++) resultEvents[i]->pos = (int)i;
    for (size_t i = 0; i < resultEvents.size(); i++) {
      SweepEvent* ev = resultEvents[i];
      if (!ev->left) std::swap(ev->pos, ev->otherEvent->pos);
    }
    return resultEvents;
  }

  int nextPos(int pos, const std::vector<SweepEvent*>& resultEvents,
              const std::vector<bool>& processed, int origPos) {
    int newPos = pos + 1;
    int n = (int)resultEvents.size();
    const Pt& p = resultEvents[pos]->point;
    while (newPos < n && resultEvents[newPos]->point == p) {
      if (!processed[newPos]) return newPos;
      newPos++;
    }
    newPos = pos - 1;
    while (newPos > origPos && processed[newPos]) newPos--;
    return newPos;
  }

  std::vector<Contour> connectEdges() {
    auto resultEvents = orderEvents();
    int n = (int)resultEvents.size();
    std::vector<bool> processed(n, false);
    std::vector<Contour> contours;

    for (int i = 0; i < n; i++) {
      if (processed[i]) continue;
      int contourId = (int)contours.size();
      Contour contour;
      // hole / depth bookkeeping from the previous-in-result edge
      SweepEvent* prevInResult = resultEvents[i]->prevInResult;
      if (prevInResult != nullptr) {
        int lowerContourId = prevInResult->outputContourId;
        if (lowerContourId >= 0 && prevInResult->resultTransition > 0) {
          Contour& lower = contours[lowerContourId];
          if (lower.holeOf >= 0) {
            contours[lower.holeOf].holeIds.push_back(contourId);
            contour.holeOf = lower.holeOf;
            contour.depth = lower.depth;
          } else {
            contours[lowerContourId].holeIds.push_back(contourId);
            contour.holeOf = lowerContourId;
            contour.depth = lower.depth + 1;
          }
        } else {
          contour.holeOf = -1;
          contour.depth = (lowerContourId >= 0) ? contours[lowerContourId].depth : 0;
        }
      }

      int pos = i;
      int origPos = i;
      contour.points.push_back(resultEvents[i]->point);
      while (true) {
        processed[pos] = true;
        resultEvents[pos]->outputContourId = contourId;
        pos = resultEvents[pos]->pos;
        if (pos < 0 || pos >= n) break;
        processed[pos] = true;
        resultEvents[pos]->outputContourId = contourId;
        contour.points.push_back(resultEvents[pos]->point);
        pos = nextPos(pos, resultEvents, processed, origPos);
        if (pos == origPos || pos < 0 || pos >= n) break;
      }
      contours.push_back(std::move(contour));
    }
    return contours;
  }
};

// ---------------------------------------------------------------------------
// helpers: ring area / orientation, point in polygon

static double ringArea(const std::vector<Pt>& r) {
  double a = 0;
  size_t n = r.size();
  for (size_t i = 0; i < n; i++) {
    const Pt& p = r[i];
    const Pt& q = r[(i + 1) % n];
    a += p.x * q.y - q.x * p.y;
  }
  return 0.5 * a;
}

static void orientRing(std::vector<Pt>& r, bool ccw) {
  double a = ringArea(r);
  if ((ccw && a < 0) || (!ccw && a > 0)) std::reverse(r.begin(), r.end());
}

// winding-number point in ring
static bool pointInRing(double px, double py, const Pt* r, int n) {
  int wn = 0;
  for (int i = 0; i < n; i++) {
    const Pt& a = r[i];
    const Pt& b = r[(i + 1) % n];
    if (a.y <= py) {
      if (b.y > py && (b.x - a.x) * (py - a.y) - (px - a.x) * (b.y - a.y) > 0) wn++;
    } else {
      if (b.y <= py && (b.x - a.x) * (py - a.y) - (px - a.x) * (b.y - a.y) < 0) wn--;
    }
  }
  return wn != 0;
}

// ---------------------------------------------------------------------------
// flat-format marshalling

static PolySet readPolySet(const double* xy, const int32_t* ring_sizes,
                           int nrings, const int32_t* poly_rings, int npolys) {
  PolySet ps;
  const double* p = xy;
  for (int i = 0; i < nrings; i++) {
    int sz = ring_sizes[i];
    std::vector<Pt> ring;
    ring.reserve(sz);
    for (int j = 0; j < sz; j++) {
      ring.push_back(snapPt(Pt{p[0], p[1]}));
      p += 2;
    }
    // drop explicit closing point
    while (ring.size() > 1 && ring.front() == ring.back()) ring.pop_back();
    // drop consecutive duplicates
    std::vector<Pt> clean;
    for (auto& q : ring)
      if (clean.empty() || !(clean.back() == q)) clean.push_back(q);
    ps.rings.push_back(std::move(clean));
  }
  for (int i = 0; i < npolys; i++) ps.poly_ring_counts.push_back(poly_rings[i]);
  ps.updateBBox();
  return ps;
}

struct GeomResult {
  std::vector<double> xy;
  std::vector<int32_t> ring_sizes;
  std::vector<int32_t> poly_rings;
};

static GeomResult* contoursToResult(std::vector<Contour>& contours) {
  auto* res = new GeomResult();
  for (size_t i = 0; i < contours.size(); i++) {
    Contour& c = contours[i];
    if (c.holeOf >= 0) continue;          // handled with its parent
    if (c.points.size() < 3) continue;
    orientRing(c.points, true);           // exterior CCW
    res->ring_sizes.push_back((int32_t)c.points.size());
    for (auto& p : c.points) {
      res->xy.push_back(p.x);
      res->xy.push_back(p.y);
    }
    int nr = 1;
    for (int hid : c.holeIds) {
      Contour& h = contours[hid];
      if (h.points.size() < 3) continue;
      orientRing(h.points, false);        // holes CW
      res->ring_sizes.push_back((int32_t)h.points.size());
      for (auto& p : h.points) {
        res->xy.push_back(p.x);
        res->xy.push_back(p.y);
      }
      nr++;
    }
    res->poly_rings.push_back(nr);
  }
  return res;
}

static GeomResult* polySetToResult(const PolySet& ps) {
  auto* res = new GeomResult();
  size_t ri = 0;
  for (int pc : ps.poly_ring_counts) {
    int nr = 0;
    for (int k = 0; k < pc; k++, ri++) {
      const auto& r = ps.rings[ri];
      // degenerate shell: skip this polygon's remaining rings entirely
      // (break bypasses the loop's ri++, so advance by the full pc - k)
      if (r.size() < 3 && k == 0) { ri += pc - k; break; }
      if (r.size() < 3) continue;
      res->ring_sizes.push_back((int32_t)r.size());
      for (auto& p : r) {
        res->xy.push_back(p.x);
        res->xy.push_back(p.y);
      }
      nr++;
    }
    if (nr > 0) res->poly_rings.push_back(nr);
  }
  return res;
}

// The port's vertex unification: a vertex of the clipping set within
// snapTol of a vertex of the subject becomes that vertex, so two polygons
// cut from one another meet in shared vertices, not in pairs a nanometre
// apart that the sweep orders one way in one test and the other way in the
// next. A ring that collapses to fewer than three vertices is emptied.
static void unifyVertices(const PolySet& subj, PolySet& clip) {
  std::vector<Pt> pts;
  for (auto& r : subj.rings) pts.insert(pts.end(), r.begin(), r.end());
  std::sort(pts.begin(), pts.end(), [](const Pt& a, const Pt& b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  for (auto& r : clip.rings) {
    for (Pt& q : r) {
      const double tol = snapTol(q);
      auto it = std::lower_bound(
          pts.begin(), pts.end(), q.x - tol,
          [](const Pt& a, double x) { return a.x < x; });
      const Pt* best = nullptr;
      double bestd = tol;
      for (; it != pts.end() && it->x <= q.x + tol; ++it) {
        double d = std::max(std::fabs(it->x - q.x), std::fabs(it->y - q.y));
        if (d <= bestd) {
          best = &*it;
          bestd = d;
        }
      }
      if (best) q = *best;
    }
    // drop the repeats a snap can make, as readPolySet does
    std::vector<Pt> clean;
    for (auto& q : r)
      if (clean.empty() || !(clean.back() == q)) clean.push_back(q);
    while (clean.size() > 1 && clean.front() == clean.back()) clean.pop_back();
    if (clean.size() < 3) clean.clear();
    r = std::move(clean);
  }
  clip.updateBBox();
}

// The tolerance of the port's two input repairs below: four steps of the
// snap grid, or snapTol where coordinates are large enough that its ulps
// are coarser. A snapped intersection point lies within ~0.7 of a step of
// the true point, so a vertex computed onto an edge lies well inside it.
static inline double nearTol(const Pt& p) {
  return std::max(4.0 * SNAP, snapTol(p));
}

// The port's spike removal: a vertex where the ring turns back on itself
// along one line (a zero-width spike, or one a few snap steps wide) bounds no
// area. The sweep sees a spike as two collinear edges of one polygon, which
// it never types as an overlap; where an edge of the other operand lies
// along the spike, the three collinear edges leave the in/out fields of the
// edges above them wrong (two polygons that touch along a side, one with a
// spike along it: their intersection came out 36.79 m² where it is empty,
// their union 125.59 m² where the two hold 218.93). Such a spike is
// dropped, repeatedly, until none is left; a spike that runs along no edge
// of the other operand stays, as the reference keeps it.
static bool isSpike(const Pt& a, const Pt& b, const Pt& c) {
  if (a == c) return !(a == b);
  const double abx = b.x - a.x, aby = b.y - a.y;
  const double bcx = c.x - b.x, bcy = c.y - b.y;
  if (abx * bcx + aby * bcy >= 0.0) return false;  // no turn back at b
  const double ab = std::hypot(abx, aby), bc = std::hypot(bcx, bcy);
  const double tol = nearTol(b);
  // both arms longer than the tolerance (not a vertex a snap step from its
  // neighbour), and the nearer end within it of the longer arm's line
  return std::min(ab, bc) > tol &&
         std::fabs(crossP(abx, aby, bcx, bcy)) / std::max(ab, bc) <= tol;
}

// Whether an edge of ``other`` overlaps the segment p-q along its line (both
// of its ends within nearTol of the line, their projections overlapping
// p-q over more than a point).
static bool runsAlong(const Pt& p, const Pt& q, const PolySet& other) {
  const double tol = std::max(nearTol(p), nearTol(q));
  const double vx = q.x - p.x, vy = q.y - p.y;
  const double len2 = vx * vx + vy * vy;
  if (len2 == 0.0) return false;
  const double len = std::sqrt(len2);
  const double lox = std::min(p.x, q.x) - tol, hix = std::max(p.x, q.x) + tol;
  const double loy = std::min(p.y, q.y) - tol, hiy = std::max(p.y, q.y) + tol;
  for (auto& r : other.rings) {
    const size_t n = r.size();
    for (size_t i = 0; i < n; i++) {
      const Pt& u = r[i];
      const Pt& w = r[(i + 1) % n];
      if (std::max(u.x, w.x) < lox || std::min(u.x, w.x) > hix ||
          std::max(u.y, w.y) < loy || std::min(u.y, w.y) > hiy)
        continue;
      if (std::fabs(crossP(vx, vy, u.x - p.x, u.y - p.y)) / len > tol ||
          std::fabs(crossP(vx, vy, w.x - p.x, w.y - p.y)) / len > tol)
        continue;
      const double tu = ((u.x - p.x) * vx + (u.y - p.y) * vy) / len2;
      const double tw = ((w.x - p.x) * vx + (w.y - p.y) * vy) / len2;
      if (std::min(std::max(tu, tw), 1.0) - std::max(std::min(tu, tw), 0.0) >
          tol / len)
        return true;
    }
  }
  return false;
}

static void removeSpikes(std::vector<Pt>& r, const PolySet& other) {
  bool again = true;
  while (again && r.size() >= 3) {
    again = false;
    const size_t n = r.size();
    for (size_t i = 0; i < n; i++) {
      const Pt& a = r[(i + n - 1) % n];
      const Pt& b = r[i];
      const Pt& c = r[(i + 1) % n];
      if (!isSpike(a, b, c)) continue;
      // the spike's longer arm, from its base to its tip b
      const Pt& base = (std::hypot(b.x - a.x, b.y - a.y) >=
                        std::hypot(c.x - b.x, c.y - b.y)) ? a : c;
      if (!runsAlong(base, b, other)) continue;
      r.erase(r.begin() + (long)i);
      std::vector<Pt> clean;
      for (auto& q : r)
        if (clean.empty() || !(clean.back() == q)) clean.push_back(q);
      while (clean.size() > 1 && clean.front() == clean.back())
        clean.pop_back();
      r = std::move(clean);
      again = true;
      break;
    }
  }
  if (r.size() < 3) r.clear();
}

static void removeSpikes(PolySet& ps, const PolySet& other) {
  for (auto& r : ps.rings) removeSpikes(r, other);
  ps.updateBBox();
}

// The port's vertex-on-edge split: where an edge of one operand runs along
// an edge of the other from a vertex that lies within nearTol of the other
// edge's interior, that vertex becomes a vertex of the other edge too. A
// vertex computed onto an edge (where a road's buffer meets its
// neighbour's, or a cut leaves a corner on the other road's side) lies a
// snap step or less off it: the sweep sees two edges from the shared end
// that almost coincide, orders them by that residue, and, once a crossing
// further on cuts the longer edge at the same vertex, holds two equal edges
// of the two operands in an order its comparator contradicts. Their overlap
// is never typed, and the right event of one no longer finds its left event
// in the sweep line, whose stale edge then corrupts the in/out fields of
// every edge computed beside it: a union of road buffers loses the holes of
// the fields they enclose. Split there, the two edges are equal from the
// start and the sweep types their overlap as it types any shared edge. A
// vertex on an edge that no edge of its own runs along (a T-junction) is
// left to the sweep, as in the reference.
struct RingVertex {
  Pt p, prev, next;
};

static void splitAtVertices(PolySet& edges, const PolySet& other) {
  std::vector<RingVertex> byX;
  for (auto& r : other.rings) {
    const size_t n = r.size();
    for (size_t i = 0; i < n; i++)
      byX.push_back({r[i], r[(i + n - 1) % n], r[(i + 1) % n]});
  }
  if (byX.empty()) return;
  std::vector<RingVertex> byY = byX;
  std::sort(byX.begin(), byX.end(), [](const RingVertex& a, const RingVertex& b) {
    return a.p.x < b.p.x;
  });
  std::sort(byY.begin(), byY.end(), [](const RingVertex& a, const RingVertex& b) {
    return a.p.y < b.p.y;
  });
  for (auto& r : edges.rings) {
    const size_t n = r.size();
    std::vector<Pt> out;
    bool split = false;
    for (size_t i = 0; i < n; i++) {
      const Pt a = r[i], b = r[(i + 1) % n];
      out.push_back(a);
      const double tol = std::max(nearTol(a), nearTol(b));
      const double lox = std::min(a.x, b.x) - tol, hix = std::max(a.x, b.x) + tol;
      const double loy = std::min(a.y, b.y) - tol, hiy = std::max(a.y, b.y) + tol;
      if (lox > other.maxx || hix < other.minx || loy > other.maxy ||
          hiy < other.miny)
        continue;
      const double vx = b.x - a.x, vy = b.y - a.y;
      const double len2 = vx * vx + vy * vy;
      if (len2 == 0.0) continue;
      const double len = std::sqrt(len2);
      auto onLine = [&](const Pt& q) {
        return std::fabs(crossP(vx, vy, q.x - a.x, q.y - a.y)) / len <= tol;
      };
      auto nearEnd = [&](const Pt& q) {
        return std::hypot(q.x - a.x, q.y - a.y) <= tol ||
               std::hypot(q.x - b.x, q.y - b.y) <= tol;
      };
      // q lies on the interior: on the line, off both ends by more than tol
      auto onInterior = [&](const Pt& q) {
        const double t = ((q.x - a.x) * vx + (q.y - a.y) * vy) / len2;
        return t * len > tol && (1.0 - t) * len > tol && onLine(q);
      };
      // an edge from an interior q to w runs along a-b: w is on the line,
      // and an end of a-b or off both (the other operand's edge then
      // holds that end on its interior, and is split there in turn); a w
      // a snap step from an end would leave a sliver between the two
      auto along = [&](const Pt& w) {
        return onLine(w) && (w == a || w == b || !nearEnd(w));
      };
      // scan the vertices along the edge's shorter extent
      const bool alongX = hix - lox <= hiy - loy;
      const auto& pts = alongX ? byX : byY;
      auto it = alongX
          ? std::lower_bound(pts.begin(), pts.end(), lox,
                             [](const RingVertex& v, double x) { return v.p.x < x; })
          : std::lower_bound(pts.begin(), pts.end(), loy,
                             [](const RingVertex& v, double y) { return v.p.y < y; });
      std::vector<std::pair<double, Pt>> cuts;
      for (; it != pts.end() && (alongX ? it->p.x <= hix : it->p.y <= hiy); ++it) {
        const Pt& q = it->p;
        if (q.x < lox || q.x > hix || q.y < loy || q.y > hiy) continue;
        if (!onInterior(q) || !(along(it->prev) || along(it->next))) continue;
        cuts.push_back({((q.x - a.x) * vx + (q.y - a.y) * vy) / len2, q});
      }
      if (cuts.empty()) continue;
      std::sort(cuts.begin(), cuts.end(),
                [](const std::pair<double, Pt>& u, const std::pair<double, Pt>& v) {
                  return u.first < v.first;
                });
      for (auto& c : cuts)
        if (!(out.back() == c.second)) out.push_back(c.second);
      split = true;
    }
    if (!split) continue;
    std::vector<Pt> clean;
    for (auto& q : out)
      if (clean.empty() || !(clean.back() == q)) clean.push_back(q);
    while (clean.size() > 1 && clean.front() == clean.back()) clean.pop_back();
    r = std::move(clean);
  }
  edges.updateBBox();
}

static GeomResult* booleanOp(const PolySet& subj, const PolySet& clip, Op op) {
  // trivial cases
  bool se = subj.empty(), ce = clip.empty();
  if (se && ce) return new GeomResult();
  if (se) {
    if (op == OP_INTERSECTION || op == OP_DIFFERENCE) return new GeomResult();
    return polySetToResult(clip);
  }
  if (ce) {
    if (op == OP_INTERSECTION) return new GeomResult();
    return polySetToResult(subj);
  }
  // disjoint bboxes
  if (subj.minx > clip.maxx || subj.maxx < clip.minx || subj.miny > clip.maxy ||
      subj.maxy < clip.miny) {
    if (op == OP_INTERSECTION) return new GeomResult();
    if (op == OP_DIFFERENCE) return polySetToResult(subj);
    auto* res = polySetToResult(subj);
    auto* res2 = polySetToResult(clip);
    res->xy.insert(res->xy.end(), res2->xy.begin(), res2->xy.end());
    res->ring_sizes.insert(res->ring_sizes.end(), res2->ring_sizes.begin(),
                           res2->ring_sizes.end());
    res->poly_rings.insert(res->poly_rings.end(), res2->poly_rings.begin(),
                           res2->poly_rings.end());
    delete res2;
    return res;
  }
  PolySet s = subj, c = clip;
  removeSpikes(s, c);
  removeSpikes(c, s);
  unifyVertices(s, c);
  splitAtVertices(s, c);
  splitAtVertices(c, s);
  Martinez m(s, c, op);
  auto contours = m.run();
  return contoursToResult(contours);
}

// union of many polygons: divide & conquer over per-polygon PolySets
static PolySet resultToPolySet(GeomResult* r) {
  PolySet ps;
  const double* p = r->xy.data();
  for (int32_t sz : r->ring_sizes) {
    std::vector<Pt> ring;
    ring.reserve(sz);
    for (int j = 0; j < sz; j++) {
      ring.push_back(Pt{p[0], p[1]});
      p += 2;
    }
    ps.rings.push_back(std::move(ring));
  }
  for (int32_t pr : r->poly_rings) ps.poly_ring_counts.push_back(pr);
  ps.updateBBox();
  return ps;
}

static GeomResult* unionTree(std::vector<PolySet>& sets, size_t lo, size_t hi) {
  if (lo + 1 == hi) return polySetToResult(sets[lo]);
  size_t mid = (lo + hi) / 2;
  GeomResult* a = unionTree(sets, lo, mid);
  GeomResult* b = unionTree(sets, mid, hi);
  PolySet pa = resultToPolySet(a);
  PolySet pb = resultToPolySet(b);
  delete a;
  delete b;
  return booleanOp(pa, pb, OP_UNION);
}

// buffer(0) as the reference computes it: the sweep with an empty clipping
// operand and XOR (keeps every boundary edge), which subdivides
// self-intersections and reconstructs even-odd contours. Bypasses
// booleanOp's trivial empty-operand shortcut on purpose.
static GeomResult* evenOdd(const PolySet& ps) {
  PolySet empty;
  Martinez m(ps, empty, OP_XOR);
  auto contours = m.run();
  return contoursToResult(contours);
}

static bool onRing(const Pt& p, const std::vector<Pt>& r) {
  const size_t n = r.size();
  for (size_t i = 0; i < n; i++) {
    const Pt& a = r[i];
    const Pt& b = r[(i + 1) % n];
    const double vx = b.x - a.x, vy = b.y - a.y;
    const double len2 = vx * vx + vy * vy;
    const double tol = nearTol(p);
    double t = len2 > 0.0 ? ((p.x - a.x) * vx + (p.y - a.y) * vy) / len2 : 0.0;
    t = std::min(1.0, std::max(0.0, t));
    if (std::hypot(p.x - a.x - t * vx, p.y - a.y - t * vy) <= tol) return true;
  }
  return false;
}

// Whether two rings cross: an edge of one meets an edge of the other at a
// point that is an end of neither.
static bool ringsCross(const std::vector<Pt>& r1, const std::vector<Pt>& r2) {
  Pt tmp[2];
  const size_t n1 = r1.size(), n2 = r2.size();
  for (size_t i = 0; i < n1; i++) {
    const Pt& a1 = r1[i];
    const Pt& a2 = r1[(i + 1) % n1];
    for (size_t j = 0; j < n2; j++) {
      const Pt& b1 = r2[j];
      const Pt& b2 = r2[(j + 1) % n2];
      if (std::max(a1.x, a2.x) < std::min(b1.x, b2.x) ||
          std::min(a1.x, a2.x) > std::max(b1.x, b2.x) ||
          std::max(a1.y, a2.y) < std::min(b1.y, b2.y) ||
          std::min(a1.y, a2.y) > std::max(b1.y, b2.y))
        continue;
      if (segmentIntersection(a1, a2, b1, b2, tmp) != 1) continue;
      const Pt& p = tmp[0];
      if (p != a1 && p != a2 && p != b1 && p != b2) return true;
    }
  }
  return false;
}

// Whether every hole lies inside its polygon's shell and outside the other
// holes, crossing neither (touching at a point is allowed): the polygons
// on which even-odd and shell-minus-holes are one region.
static bool holesInsideShells(const PolySet& ps) {
  size_t ri = 0;
  for (int pc : ps.poly_ring_counts) {
    const auto& shell = ps.rings[ri];
    for (int k = 1; k < pc; k++) {
      const auto& hole = ps.rings[ri + k];
      if (hole.size() < 3 || shell.size() < 3) continue;
      for (const Pt& p : hole)
        if (!pointInRing(p.x, p.y, shell.data(), (int)shell.size()) &&
            !onRing(p, shell))
          return false;
      if (ringsCross(hole, shell)) return false;
      for (int m = 1; m < k; m++) {
        const auto& other = ps.rings[ri + m];
        if (other.size() < 3) continue;
        for (const Pt& p : hole)
          if (pointInRing(p.x, p.y, other.data(), (int)other.size()) &&
              !onRing(p, other))
            return false;
        for (const Pt& p : other)
          if (pointInRing(p.x, p.y, hole.data(), (int)hole.size()) &&
              !onRing(p, hole))
            return false;
        if (ringsCross(hole, other)) return false;
      }
    }
    ri += pc;
  }
  return true;
}

// The port's buffer(0) of a polygon whose holes leave its shell: each
// shell (its own even-odd repair) minus the union of its holes, the union
// of those over the polygons. Even-odd counts a hole's part outside the
// shell as area, where the polygon's points are those inside the shell and
// in no hole (3 of the 60 random polygons of the geometry tests have such a
// hole; the reference's buffer(0) kept its outer part, and its 1.5 m
// buffer grew by it).
static GeomResult* shellsMinusHoles(const PolySet& ps) {
  std::vector<PolySet> parts;
  size_t ri = 0;
  for (int pc : ps.poly_ring_counts) {
    PolySet shell;
    shell.rings.push_back(ps.rings[ri]);
    shell.poly_ring_counts.push_back(1);
    shell.updateBBox();
    std::vector<PolySet> holes;
    for (int k = 1; k < pc; k++) {
      PolySet h;
      h.rings.push_back(ps.rings[ri + k]);
      h.poly_ring_counts.push_back(1);
      h.updateBBox();
      if (!h.empty()) holes.push_back(std::move(h));
    }
    ri += pc;
    if (shell.empty()) continue;
    GeomResult* r = evenOdd(shell);
    if (!holes.empty()) {
      GeomResult* hu = unionTree(holes, 0, holes.size());
      PolySet sp = resultToPolySet(r), hp = resultToPolySet(hu);
      delete r;
      delete hu;
      r = booleanOp(sp, hp, OP_DIFFERENCE);
    }
    PolySet part = resultToPolySet(r);
    delete r;
    if (!part.empty()) parts.push_back(std::move(part));
  }
  if (parts.empty()) return new GeomResult();
  return unionTree(parts, 0, parts.size());
}

// The polygon a buffer grows from: the input itself, or, where a hole
// leaves its shell, the shells minus their holes.
static PolySet bufferBase(const PolySet& ps) {
  if (holesInsideShells(ps)) return ps;
  GeomResult* r = shellsMinusHoles(ps);
  PolySet out = resultToPolySet(r);
  delete r;
  return out;
}

}  // namespace

// ---------------------------------------------------------------------------
// C API

extern "C" {

GeomResult* geom_boolean_op(int op, const double* s_xy,
                            const int32_t* s_ring_sizes, int s_nrings,
                            const int32_t* s_poly_rings, int s_npolys,
                            const double* c_xy, const int32_t* c_ring_sizes,
                            int c_nrings, const int32_t* c_poly_rings,
                            int c_npolys) {
  PolySet subj = readPolySet(s_xy, s_ring_sizes, s_nrings, s_poly_rings, s_npolys);
  PolySet clip = readPolySet(c_xy, c_ring_sizes, c_nrings, c_poly_rings, c_npolys);
  return booleanOp(subj, clip, (Op)op);
}

// Union of N polygon sets packed end to end: poly_rings has n_polys entries,
// each polygon is unioned as an independent operand (divide & conquer).
GeomResult* geom_union_many(const double* xy, const int32_t* ring_sizes,
                            int nrings, const int32_t* poly_rings, int npolys) {
  if (npolys == 0) return new GeomResult();
  PolySet all = readPolySet(xy, ring_sizes, nrings, poly_rings, npolys);
  std::vector<PolySet> sets;
  size_t ri = 0;
  for (int pc : all.poly_ring_counts) {
    PolySet ps;
    for (int k = 0; k < pc; k++, ri++) ps.rings.push_back(all.rings[ri]);
    ps.poly_ring_counts.push_back(pc);
    ps.updateBBox();
    sets.push_back(std::move(ps));
  }
  return unionTree(sets, 0, sets.size());
}

int64_t geom_result_num_coords(GeomResult* r) { return (int64_t)r->xy.size() / 2; }
int32_t geom_result_num_rings(GeomResult* r) { return (int32_t)r->ring_sizes.size(); }
int32_t geom_result_num_polys(GeomResult* r) { return (int32_t)r->poly_rings.size(); }

void geom_result_copy(GeomResult* r, double* xy, int32_t* ring_sizes,
                      int32_t* poly_rings) {
  std::memcpy(xy, r->xy.data(), r->xy.size() * sizeof(double));
  std::memcpy(ring_sizes, r->ring_sizes.data(),
              r->ring_sizes.size() * sizeof(int32_t));
  std::memcpy(poly_rings, r->poly_rings.data(),
              r->poly_rings.size() * sizeof(int32_t));
}

void geom_result_free(GeomResult* r) { delete r; }

// --- line buffering: rectangles per segment + disks at joints, then union ---
// cap_style: 1 = round (disks at both ends too), 2 = flat.
GeomResult* geom_buffer_line(const double* xy, int npts, double dist,
                             int cap_style, int quad_segs) {
  if (npts < 2 || dist <= 0) return new GeomResult();
  int circ = std::max(4, 4 * quad_segs);
  std::vector<PolySet> pieces;
  auto addDisk = [&](double cx, double cy) {
    PolySet ps;
    std::vector<Pt> ring;
    for (int k = 0; k < circ; k++) {
      double a = 2.0 * M_PI * k / circ;
      ring.push_back(snapPt(Pt{cx + dist * std::cos(a), cy + dist * std::sin(a)}));
    }
    ps.rings.push_back(std::move(ring));
    ps.poly_ring_counts.push_back(1);
    ps.updateBBox();
    pieces.push_back(std::move(ps));
  };
  for (int i = 0; i + 1 < npts; i++) {
    double x1 = xy[2 * i], y1 = xy[2 * i + 1];
    double x2 = xy[2 * i + 2], y2 = xy[2 * i + 3];
    double dx = x2 - x1, dy = y2 - y1;
    double len = std::hypot(dx, dy);
    if (len == 0) continue;
    double nx = -dy / len * dist, ny = dx / len * dist;
    PolySet ps;
    ps.rings.push_back({snapPt(Pt{x1 + nx, y1 + ny}), snapPt(Pt{x2 + nx, y2 + ny}),
                        snapPt(Pt{x2 - nx, y2 - ny}), snapPt(Pt{x1 - nx, y1 - ny})});
    ps.poly_ring_counts.push_back(1);
    ps.updateBBox();
    pieces.push_back(std::move(ps));
    if (i + 2 < npts) addDisk(x2, y2);  // joint disk (round join)
  }
  if (cap_style == 1) {
    addDisk(xy[0], xy[1]);
    addDisk(xy[2 * (npts - 1)], xy[2 * npts - 1]);
  }
  if (pieces.empty()) return new GeomResult();
  return unionTree(pieces, 0, pieces.size());
}

// --- polygon outward buffer: polygon ∪ edge rectangles ∪ vertex disks -------
GeomResult* geom_buffer_polygon(const double* xy, const int32_t* ring_sizes,
                                int nrings, const int32_t* poly_rings,
                                int npolys, double dist, int quad_segs) {
  PolySet base = readPolySet(xy, ring_sizes, nrings, poly_rings, npolys);
  if (dist == 0.0)  // validity repair (shapely buffer(0) equivalent)
    return holesInsideShells(base) ? evenOdd(base) : shellsMinusHoles(base);
  int circ = std::max(4, 4 * quad_segs);
  std::vector<PolySet> pieces;
  pieces.push_back(bufferBase(base));
  for (auto& ring : base.rings) {
    size_t n = ring.size();
    for (size_t i = 0; i < n; i++) {
      const Pt& a = ring[i];
      const Pt& b = ring[(i + 1) % n];
      double dx = b.x - a.x, dy = b.y - a.y;
      double len = std::hypot(dx, dy);
      if (len > 0) {
        double nx = -dy / len * dist, ny = dx / len * dist;
        PolySet ps;
        ps.rings.push_back({snapPt(Pt{a.x + nx, a.y + ny}), snapPt(Pt{b.x + nx, b.y + ny}),
                            snapPt(Pt{b.x - nx, b.y - ny}), snapPt(Pt{a.x - nx, a.y - ny})});
        ps.poly_ring_counts.push_back(1);
        ps.updateBBox();
        pieces.push_back(std::move(ps));
      }
      PolySet disk;
      std::vector<Pt> dr;
      for (int k = 0; k < circ; k++) {
        double ang = 2.0 * M_PI * k / circ;
        dr.push_back(snapPt(Pt{a.x + dist * std::cos(ang), a.y + dist * std::sin(ang)}));
      }
      disk.rings.push_back(std::move(dr));
      disk.poly_ring_counts.push_back(1);
      disk.updateBBox();
      pieces.push_back(std::move(disk));
    }
  }
  return unionTree(pieces, 0, pieces.size());
}

// --- predicates -------------------------------------------------------------

// point-in-polygon-set batch (evenodd over shells minus holes via winding of
// oriented rings: shells CCW positive, holes CW negative).
static void pointsInParsedSet(const double* pts, int npts, const PolySet& ps,
                              uint8_t* out) {
  for (int i = 0; i < npts; i++) {
    double px = pts[2 * i], py = pts[2 * i + 1];
    bool inside = false;
    if (px >= ps.minx && px <= ps.maxx && py >= ps.miny && py <= ps.maxy) {
      size_t ri = 0;
      for (int pc : ps.poly_ring_counts) {
        bool inShell = false;
        for (int k = 0; k < pc && !inside; k++) {
          const auto& r = ps.rings[ri + k];
          if (r.size() < 3) continue;
          bool inR = pointInRing(px, py, r.data(), (int)r.size());
          if (k == 0) {
            inShell = inR;
            if (!inShell) break;
          } else if (inR) {
            inShell = false;
            break;
          }
        }
        ri += pc;
        if (inShell) { inside = true; break; }
      }
    }
    out[i] = inside ? 1 : 0;
  }
}

void geom_points_in_polyset(const double* pts, int npts, const double* xy,
                            const int32_t* ring_sizes, int nrings,
                            const int32_t* poly_rings, int npolys,
                            uint8_t* out) {
  PolySet ps = readPolySet(xy, ring_sizes, nrings, poly_rings, npolys);
  pointsInParsedSet(pts, npts, ps, out);
}

// segment-level intersects test between two polygon sets (boundaries cross or
// one contains a vertex of the other). Brute force with bbox prefilter.
int geom_polyset_intersects(const double* a_xy, const int32_t* a_rs, int a_nr,
                            const int32_t* a_pr, int a_np, const double* b_xy,
                            const int32_t* b_rs, int b_nr, const int32_t* b_pr,
                            int b_np) {
  PolySet A = readPolySet(a_xy, a_rs, a_nr, a_pr, a_np);
  PolySet B = readPolySet(b_xy, b_rs, b_nr, b_pr, b_np);
  if (A.minx > B.maxx || A.maxx < B.minx || A.miny > B.maxy || A.maxy < B.miny)
    return 0;
  // vertex containment either way (sets parsed once, not per vertex)
  for (auto& r : A.rings)
    for (auto& p : r) {
      uint8_t o;
      double pt[2] = {p.x, p.y};
      pointsInParsedSet(pt, 1, B, &o);
      if (o) return 1;
    }
  for (auto& r : B.rings)
    for (auto& p : r) {
      uint8_t o;
      double pt[2] = {p.x, p.y};
      pointsInParsedSet(pt, 1, A, &o);
      if (o) return 1;
    }
  // edge crossings
  Pt tmp[2];
  for (auto& ra : A.rings) {
    size_t na = ra.size();
    for (size_t i = 0; i < na; i++) {
      const Pt& a1 = ra[i];
      const Pt& a2 = ra[(i + 1) % na];
      double lo_x = std::min(a1.x, a2.x), hi_x = std::max(a1.x, a2.x);
      double lo_y = std::min(a1.y, a2.y), hi_y = std::max(a1.y, a2.y);
      for (auto& rb : B.rings) {
        size_t nb = rb.size();
        for (size_t j = 0; j < nb; j++) {
          const Pt& b1 = rb[j];
          const Pt& b2 = rb[(j + 1) % nb];
          if (std::max(b1.x, b2.x) < lo_x || std::min(b1.x, b2.x) > hi_x ||
              std::max(b1.y, b2.y) < lo_y || std::min(b1.y, b2.y) > hi_y)
            continue;
          if (segmentIntersection(a1, a2, b1, b2, tmp) > 0) return 1;
        }
      }
    }
  }
  return 0;
}

// --- rasterization: even-odd scanline fill, pixel-center sampling ----------
// transform: x = x0 + (col + 0.5) * dx ; y = y0 + (row + 0.5) * dy
// (dy typically negative for north-up rasters)
void geom_rasterize(const double* xy, const int32_t* ring_sizes, int nrings,
                    const int32_t* poly_rings, int npolys, double x0,
                    double dx, double y0, double dy, int height, int width,
                    uint8_t* out, uint8_t value) {
  PolySet ps = readPolySet(xy, ring_sizes, nrings, poly_rings, npolys);
  std::vector<double> xs;
  for (int row = 0; row < height; row++) {
    double py = y0 + (row + 0.5) * dy;
    xs.clear();
    for (auto& r : ps.rings) {
      size_t n = r.size();
      if (n < 3) continue;
      for (size_t i = 0; i < n; i++) {
        const Pt& a = r[i];
        const Pt& b = r[(i + 1) % n];
        if ((a.y <= py && b.y > py) || (b.y <= py && a.y > py)) {
          double t = (py - a.y) / (b.y - a.y);
          xs.push_back(a.x + t * (b.x - a.x));
        }
      }
    }
    if (xs.empty()) continue;
    std::sort(xs.begin(), xs.end());
    for (size_t k = 0; k + 1 < xs.size(); k += 2) {
      // pixel centers in [xs[k], xs[k+1])
      int c0 = (int)std::ceil((xs[k] - x0) / dx - 0.5);
      int c1 = (int)std::floor((xs[k + 1] - x0) / dx - 0.5);
      c0 = std::max(c0, 0);
      c1 = std::min(c1, width - 1);
      for (int c = c0; c <= c1; c++) out[row * width + c] = value;
    }
  }
}

// --- mask boundary tracing: pixel-exact rectilinear rings ------------------
// Directed boundary edges between filled and empty pixels (interior kept on
// a consistent side), linked into closed rings; exteriors get positive
// shoelace area in the y-down pixel frame, holes negative. Mirrors the
// Python tracer in geom/vectorize.py (the hot host
// stage of mask->polygon vectorization in the detection pipeline).
GeomResult* geom_trace_mask(const uint8_t* mask, int height, int width) {
  const int W1 = width + 1;
  const int nverts = (height + 1) * W1;
  std::vector<int32_t> e1(nverts, -1), e2(nverts, -1);
  int64_t nedges = 0;
  auto add = [&](int a, int b) {
    if (e1[a] < 0) e1[a] = b; else e2[a] = b;
    nedges++;
  };
  for (int r = 0; r < height; r++) {
    const uint8_t* row = mask + (size_t)r * width;
    for (int c = 0; c < width; c++) {
      if (!row[c]) continue;
      bool top = (r == 0) || !mask[(size_t)(r - 1) * width + c];
      bool bot = (r == height - 1) || !mask[(size_t)(r + 1) * width + c];
      bool lef = (c == 0) || !row[c - 1];
      bool rig = (c == width - 1) || !row[c + 1];
      int tl = r * W1 + c, tr = tl + 1;
      int bl = (r + 1) * W1 + c, br = bl + 1;
      if (top) add(tl, tr);
      if (bot) add(br, bl);
      if (lef) add(bl, tl);
      if (rig) add(tr, br);
    }
  }
  auto* res = new GeomResult();
  std::vector<int> ring;
  for (int start = 0; start < nverts && nedges > 0; start++) {
    if (e1[start] < 0) continue;
    ring.clear();
    ring.push_back(start);
    int cur = start, pdx = 0, pdy = 0;
    int64_t guard = nedges + 1;
    while (guard-- > 0) {
      int nxt;
      if (e2[cur] < 0) {
        nxt = e1[cur];
        e1[cur] = -1;
      } else {
        // checkerboard corner: prefer the smaller turn (cross product of
        // incoming x outgoing) so each ring stays simple — same rule as
        // the Python tracer
        int c1 = e1[cur], c2 = e2[cur];
        auto turn = [&](int to) {
          int dx = (to % W1) - (cur % W1);
          int dy = (to / W1) - (cur / W1);
          return pdx * dy - pdy * dx;
        };
        if (turn(c1) <= turn(c2)) {
          nxt = c1;
          e1[cur] = e2[cur];
          e2[cur] = -1;
        } else {
          nxt = c2;
          e2[cur] = -1;
        }
      }
      nedges--;
      pdx = (nxt % W1) - (cur % W1);
      pdy = (nxt / W1) - (cur / W1);
      cur = nxt;
      ring.push_back(cur);
      if (cur == start) break;
    }
    if (ring.size() >= 5 && ring.front() == ring.back()) {
      res->ring_sizes.push_back((int32_t)ring.size());
      res->poly_rings.push_back(1);
      for (int v : ring) {
        res->xy.push_back((double)(v % W1));
        res->xy.push_back((double)(v / W1));
      }
    }
  }
  return res;
}

}  // extern "C"
