"""First-class Prometheus text exposition: builder + strict parser (the
port of ``deepspeed_tpu/observability/prometheus.py``).

The serving ``/metrics`` endpoint used to print bare ``name value`` lines.
This module upgrades it to the real text format (version 0.0.4):

* ``# HELP`` / ``# TYPE`` metadata for every family;
* native **histograms** (cumulative ``_bucket{le=...}`` series ending at
  ``+Inf``, plus ``_sum``/``_count``) for latency distributions;
* **labels** (``{replica="0"}``) for per-replica series;
* a **strict parser** (:func:`parse_exposition`) that validates everything
  a real scraper relies on — used by the test suite as the format oracle
  and available to CI for any exposition surface.

Nothing here imports torch or the serving stack; the module is shared by serving and tests.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.locks import named_lock

# ---------------------------------------------------------------------------
# histogram primitive
# ---------------------------------------------------------------------------

#: default latency buckets (milliseconds) — TTFT/TPOT/queue-wait all live
#: comfortably inside this range on both CPU test rigs and the H100
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0)


class Histogram:
    """Fixed-bucket cumulative histogram (thread-safe)."""

    def __init__(self, buckets: Sequence[float] = DEFAULT_MS_BUCKETS):
        bs = [float(b) for b in buckets]
        if bs != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError("histogram buckets must be strictly increasing")
        self.buckets: Tuple[float, ...] = tuple(bs)
        self._lock = named_lock("prom.histogram")
        # per-bucket (non-cumulative) counts; +Inf overflow is _counts[-1]
        self._counts = [0] * (len(bs) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self.sum += value
            self.count += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """``[(le, cumulative_count), ...]`` ending with ``(inf, count)``."""
        with self._lock:
            out: List[Tuple[float, int]] = []
            running = 0
            for b, c in zip(self.buckets, self._counts):
                running += c
                out.append((b, running))
            out.append((math.inf, running + self._counts[-1]))
            return out


# ---------------------------------------------------------------------------
# exposition builder
# ---------------------------------------------------------------------------


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _fmt_labels(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", r"\\").replace('"', r'\"'))
        for k, v in labels.items())
    return "{" + inner + "}"


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


class ExpositionBuilder:
    """Accumulates families in declaration order and renders the text
    format.  One ``# HELP``/``# TYPE`` pair per family, samples after."""

    def __init__(self):
        self._lines: List[str] = []
        self._seen: Dict[str, str] = {}  # family -> type

    def _head(self, name: str, help_text: str, mtype: str) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        if name in self._seen:
            raise ValueError(f"duplicate metric family {name!r}")
        self._seen[name] = mtype
        self._lines.append(f"# HELP {name} {help_text}")
        self._lines.append(f"# TYPE {name} {mtype}")

    def counter(self, name: str, help_text: str, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        self._head(name, help_text, "counter")
        self._lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")

    def gauge(self, name: str, help_text: str, value: float,
              labels: Optional[Dict[str, str]] = None) -> None:
        self._head(name, help_text, "gauge")
        self._lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")

    def gauge_series(self, name: str, help_text: str,
                     series: Sequence[Tuple[Dict[str, str], float]]) -> None:
        """One gauge family with several labeled samples (per-replica)."""
        self._head(name, help_text, "gauge")
        for labels, value in series:
            self._lines.append(
                f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")

    def histogram(self, name: str, help_text: str, hist: Histogram,
                  labels: Optional[Dict[str, str]] = None) -> None:
        self._head(name, help_text, "histogram")
        base = dict(labels or {})
        for le, cum in hist.cumulative():
            lb = dict(base)
            lb["le"] = _fmt_value(le)
            self._lines.append(
                f"{name}_bucket{_fmt_labels(lb)} {cum}")
        self._lines.append(
            f"{name}_sum{_fmt_labels(base)} {_fmt_value(hist.sum)}")
        self._lines.append(
            f"{name}_count{_fmt_labels(base)} {hist.count}")

    def render(self) -> str:
        return "\n".join(self._lines) + "\n"


# ---------------------------------------------------------------------------
# strict parser (format oracle for tests / CI)
# ---------------------------------------------------------------------------


class ExpositionError(ValueError):
    """The text violates the Prometheus exposition format."""


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+(?P<ts>-?\d+))?$")
_LABEL_RE = re.compile(
    r'^(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"$')

_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _parse_labels(raw: Optional[str]) -> Dict[str, str]:
    if not raw:
        return {}
    out: Dict[str, str] = {}
    # split on commas not inside quotes
    parts, depth, cur = [], False, ""
    for ch in raw:
        if ch == '"':
            depth = not depth
        if ch == "," and not depth:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        parts.append(cur)
    for part in parts:
        m = _LABEL_RE.match(part.strip())
        if not m:
            raise ExpositionError(f"malformed label pair {part!r}")
        k = m.group("k")
        if k in out:
            raise ExpositionError(f"duplicate label {k!r}")
        out[k] = m.group("v").replace(r"\"", '"').replace(r"\\", "\\")
    return out


def _parse_value(raw: str) -> float:
    if raw == "+Inf":
        return math.inf
    if raw == "-Inf":
        return -math.inf
    if raw == "NaN":
        return math.nan
    try:
        return float(raw)
    except ValueError:
        raise ExpositionError(f"malformed sample value {raw!r}")


def _family_of(sample_name: str, families: Dict[str, dict]) -> Optional[str]:
    """Histogram samples attach to their family by suffix; everything else
    matches the family name exactly."""
    if sample_name in families:
        return sample_name
    for suf in _HIST_SUFFIXES:
        if sample_name.endswith(suf):
            base = sample_name[: -len(suf)]
            if base in families and families[base]["type"] == "histogram":
                return base
    return None


def parse_exposition(text: str, require_help: bool = True) -> Dict[str, dict]:
    """Strictly parse Prometheus text exposition.

    Returns ``{family: {"type", "help", "samples": [(name, labels, value)]}}``.
    Raises :class:`ExpositionError` on anything a conforming scraper could
    choke on: samples with no ``# TYPE``, unknown types, duplicate families
    or series, malformed labels/values, histograms whose cumulative buckets
    decrease, lack ``+Inf``, or whose ``+Inf`` bucket ≠ ``_count``.
    """
    families: Dict[str, dict] = {}
    seen_series = set()
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            try:
                _, _, name, help_text = line.split(" ", 3)
            except ValueError:
                raise ExpositionError(f"line {lineno}: malformed HELP")
            if name in families:
                raise ExpositionError(
                    f"line {lineno}: duplicate HELP for {name}")
            families[name] = {"type": None, "help": help_text, "samples": []}
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4:
                raise ExpositionError(f"line {lineno}: malformed TYPE")
            _, _, name, mtype = parts
            if mtype not in ("counter", "gauge", "histogram", "summary",
                             "untyped"):
                raise ExpositionError(
                    f"line {lineno}: unknown metric type {mtype!r}")
            fam = families.setdefault(
                name, {"type": None, "help": None, "samples": []})
            if fam["type"] is not None:
                raise ExpositionError(
                    f"line {lineno}: duplicate TYPE for {name}")
            fam["type"] = mtype
            continue
        if line.startswith("#"):
            continue  # comment
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ExpositionError(f"line {lineno}: malformed sample {line!r}")
        sname = m.group("name")
        labels = _parse_labels(m.group("labels"))
        value = _parse_value(m.group("value"))
        fam_name = _family_of(sname, families)
        if fam_name is None or families[fam_name]["type"] is None:
            raise ExpositionError(
                f"line {lineno}: sample {sname!r} has no # TYPE")
        key = (sname, tuple(sorted(labels.items())))
        if key in seen_series:
            raise ExpositionError(
                f"line {lineno}: duplicate series {sname}{labels}")
        seen_series.add(key)
        families[fam_name]["samples"].append((sname, labels, value))

    for name, fam in families.items():
        if fam["type"] is None:
            raise ExpositionError(f"family {name} has HELP but no TYPE")
        if require_help and fam["help"] is None:
            raise ExpositionError(f"family {name} has no HELP")
        if fam["type"] == "histogram":
            _validate_histogram(name, fam["samples"])
    return families


def _validate_histogram(name: str,
                        samples: List[Tuple[str, Dict[str, str], float]]
                        ) -> None:
    # group by the label set minus `le`
    groups: Dict[tuple, dict] = {}
    for sname, labels, value in samples:
        base = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
        g = groups.setdefault(base, {"buckets": [], "sum": None, "count": None})
        if sname == name + "_bucket":
            if "le" not in labels:
                raise ExpositionError(f"{name}: bucket without le label")
            g["buckets"].append((_parse_value(labels["le"]), value))
        elif sname == name + "_sum":
            g["sum"] = value
        elif sname == name + "_count":
            g["count"] = value
        else:
            raise ExpositionError(
                f"{name}: unexpected histogram sample {sname}")
    for base, g in groups.items():
        if not g["buckets"]:
            raise ExpositionError(f"{name}{dict(base)}: histogram "
                                  "with no buckets")
        if g["sum"] is None or g["count"] is None:
            raise ExpositionError(
                f"{name}{dict(base)}: histogram missing _sum or _count")
        les = [le for le, _ in g["buckets"]]
        if les != sorted(les):
            raise ExpositionError(f"{name}{dict(base)}: bucket le values "
                                  "not sorted")
        counts = [c for _, c in g["buckets"]]
        if any(b > a for a, b in zip(counts[1:], counts)):
            raise ExpositionError(
                f"{name}{dict(base)}: cumulative bucket counts decrease")
        if les[-1] != math.inf:
            raise ExpositionError(f"{name}{dict(base)}: missing +Inf bucket")
        if counts[-1] != g["count"]:
            raise ExpositionError(
                f"{name}{dict(base)}: +Inf bucket ({counts[-1]}) != _count "
                f"({g['count']})")
