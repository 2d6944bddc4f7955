"""A small Prometheus registry: counters, gauges and histograms with
labels, rendered in the text exposition format 0.0.4.

The port's metrics bundle (``metrics.py``) is built on this instead of
``prometheus_client``, which the card's machine does not have. What a
scrape reads is what ``prometheus_client`` 0.25 renders for the same
calls, sample by sample:

- a family's samples in registration order, each child of a labelled
  family in the order its label values were first used, label pairs
  sorted by name, values as Go prints floats (``1.0``, ``+Inf``,
  ``1.7e+09``);
- a counter named ``x_total`` is the family ``x`` with a sample
  ``x_total``; counters and histograms carry a ``_created`` sample (the
  wall clock when the child was made), rendered as a gauge family of its
  own after the family's other samples;
- a histogram's buckets are cumulative, with ``+Inf`` added, then
  ``_count`` and ``_sum``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Iterator, Optional

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
INF = float("inf")


def go_float(value: float) -> str:
    """A float as Go's strconv prints it in an exposition: ``repr`` with
    an exponent from 10^7 up."""
    d = float(value)
    if d == INF:
        return "+Inf"
    if d == -INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(value: str) -> str:
    return value.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _escape_help(doc: str) -> str:
    return doc.replace("\\", r"\\").replace("\n", r"\n")


class CollectorRegistry:
    """The families of one bundle, in registration order."""

    def __init__(self):
        self._families: list["_Family"] = []
        self._lock = threading.Lock()

    def register(self, family: "_Family") -> None:
        with self._lock:
            self._families.append(family)

    def collect(self) -> list["_Family"]:
        with self._lock:
            return list(self._families)

    def get_sample_value(self, name: str,
                         labels: Optional[dict] = None) -> Optional[float]:
        """The value of the sample ``name`` with exactly ``labels``, or
        None when there is no such sample."""
        want = labels or {}
        for family in self.collect():
            for sname, slabels, value in family.samples():
                if sname == name and slabels == want:
                    return value
        return None


class _Child:
    """One labelled series: its value(s) and the wall clock it was made."""

    def __init__(self, buckets: Optional[tuple] = None):
        self._lock = threading.Lock()
        self.value = 0.0
        self.created = time.time()
        if buckets is not None:
            self.bounds = buckets
            self.counts = [0.0] * len(buckets)
            self.sum = 0.0


class _Family:
    kind = ""

    def __init__(self, name: str, documentation: str,
                 labelnames=(), registry: Optional[CollectorRegistry] = None):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._labelvalues: Optional[tuple] = None  # set on a labels() view
        self._lock = threading.Lock()
        self._children: dict[tuple, _Child] = {}
        if not self.labelnames:
            self._children[()] = self._new_child()
        if registry is not None:
            registry.register(self)

    # -- children ----------------------------------------------------------

    def _new_child(self) -> _Child:
        return _Child()

    def labels(self, *values, **kw):
        """The child of these label values, made on first use."""
        if not self.labelnames:
            raise ValueError(
                f"No label names were set when constructing {self}")
        if self._labelvalues is not None:
            raise ValueError(f"{self} already has labels set; can not chain "
                             "calls to .labels()")
        if values and kw:
            raise ValueError("Can't pass both *args and **kwargs")
        if kw:
            if sorted(kw) != sorted(self.labelnames):
                raise ValueError("Incorrect label names")
            values = tuple(kw[n] for n in self.labelnames)
        elif len(values) != len(self.labelnames):
            raise ValueError("Incorrect label count")
        key = tuple(str(v) for v in values)
        with self._lock:
            if key not in self._children:
                self._children[key] = self._new_child()
            child = self._children[key]
        view = type(self).__new__(type(self))
        view.__dict__.update(self.__dict__)
        view._labelvalues = key
        view._child = child
        return view

    def remove(self, *values) -> None:
        if not self.labelnames:
            raise ValueError(
                f"No label names were set when constructing {self}")
        if len(values) != len(self.labelnames):
            raise ValueError(f"Incorrect label count (expected "
                             f"{len(self.labelnames)}, got {values})")
        key = tuple(str(v) for v in values)
        with self._lock:
            self._children.pop(key, None)

    def _one(self) -> _Child:
        child = self.__dict__.get("_child")
        if child is not None:
            return child
        if self.labelnames:
            raise ValueError(f"{self.kind} metric is missing label values")
        return self._children[()]

    def __repr__(self) -> str:
        return f"{type(self).__module__}.{type(self).__name__}({self.name})"

    # -- exposition --------------------------------------------------------

    def _series(self) -> Iterator[tuple[dict, _Child]]:
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            yield dict(zip(self.labelnames, key)), child

    def samples(self) -> list[tuple[str, dict, float]]:
        raise NotImplementedError


class Counter(_Family):
    """A monotonic count. ``Counter("x_total", ...)`` is the family ``x``."""

    kind = "counter"

    def __init__(self, name: str, documentation: str, labelnames=(),
                 registry: Optional[CollectorRegistry] = None):
        if name.endswith("_total"):
            name = name[:-len("_total")]
        super().__init__(name, documentation, labelnames, registry)

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError(
                "Counters can only be incremented by non-negative amounts.")
        child = self._one()
        with child._lock:
            child.value += amount

    def samples(self) -> list[tuple[str, dict, float]]:
        out = []
        for labels, child in self._series():
            out.append((self.name + "_total", labels, child.value))
            out.append((self.name + "_created", labels, child.created))
        return out


class Gauge(_Family):
    """A value that goes up and down."""

    kind = "gauge"

    def set(self, value: float) -> None:
        child = self._one()
        with child._lock:
            child.value = float(value)

    def samples(self) -> list[tuple[str, dict, float]]:
        return [(self.name, labels, child.value)
                for labels, child in self._series()]


class Histogram(_Family):
    """Observations counted into cumulative buckets."""

    kind = "histogram"

    def __init__(self, name: str, documentation: str, buckets,
                 labelnames=(), registry: Optional[CollectorRegistry] = None):
        bounds = [float(b) for b in buckets]
        if bounds != sorted(bounds):
            raise ValueError("Buckets not in sorted order")
        if not bounds or bounds[-1] != INF:
            bounds.append(INF)
        if len(bounds) < 2:
            raise ValueError("Must have at least two buckets")
        if "le" in labelnames:
            raise ValueError("Invalid label metric name: le")
        self._bounds = tuple(bounds)
        super().__init__(name, documentation, labelnames, registry)

    def _new_child(self) -> _Child:
        return _Child(self._bounds)

    def observe(self, amount: float) -> None:
        child = self._one()
        with child._lock:
            child.sum += amount
            for i, bound in enumerate(child.bounds):
                if amount <= bound:
                    child.counts[i] += 1
                    break

    def samples(self) -> list[tuple[str, dict, float]]:
        out = []
        for labels, child in self._series():
            with child._lock:
                counts, total = list(child.counts), child.sum
            acc = 0.0
            for bound, n in zip(child.bounds, counts):
                acc += n
                out.append((self.name + "_bucket",
                            {**labels, "le": go_float(bound)}, acc))
            out.append((self.name + "_count", labels, acc))
            out.append((self.name + "_sum", labels, total))
            out.append((self.name + "_created", labels, child.created))
        return out


def _sample_line(name: str, labels: dict, value: float) -> str:
    if labels:
        pairs = ",".join(f'{k}="{_escape_label(v)}"'
                         for k, v in sorted(labels.items()))
        return f"{name}{{{pairs}}} {go_float(value)}\n"
    return f"{name} {go_float(value)}\n"


def generate_latest(registry: CollectorRegistry) -> bytes:
    """The registry in the Prometheus text format 0.0.4."""
    out: list[str] = []
    for family in registry.collect():
        mname = family.name + ("_total" if family.kind == "counter" else "")
        doc = _escape_help(family.documentation)
        out.append(f"# HELP {mname} {doc}\n")
        out.append(f"# TYPE {mname} {family.kind}\n")
        created: list[str] = []
        for name, labels, value in family.samples():
            line = _sample_line(name, labels, value)
            if name == family.name + "_created":
                created.append(line)
            else:
                out.append(line)
        if created:
            out.append(f"# HELP {family.name}_created {doc}\n")
            out.append(f"# TYPE {family.name}_created gauge\n")
            out.extend(created)
    return "".join(out).encode("utf-8")
