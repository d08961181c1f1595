"""Metric exposition: Prometheus-style text format and JSON snapshots.

``to_prometheus`` flattens a nested snapshot dict (the output of
``Observability.snapshot``) into the text exposition format: numeric
leaves become ``<prefix>_<path> value`` samples, lists of numbers become
one sample per element with an ``idx`` label (per-tier gauges), and
non-numeric leaves are dropped. Names are sanitized to the metric
charset. Leaves whose terminal path component names a monotone
transaction count are typed ``counter`` (scrapers can rate() them);
everything else stays a ``gauge``, and known metrics carry ``# HELP``
text. The output is deterministic (sorted) so snapshots diff cleanly in
CI artifacts.
"""
from __future__ import annotations

import json
import re
from typing import Iterable, List, Optional, Tuple

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

# terminal path components that only ever accumulate (device/meter
# transaction counts, event totals): exposed as Prometheus counters
_COUNTER_LEAVES = frozenset({
    "docs", "admits", "evictions", "bar_candidates", "bar_passes",
    "chunks", "drift_fired", "observed", "writes", "reads", "deletes",
    "migrations", "relocations", "resident_steps", "recorded", "dropped",
    "checks", "steps", "hits", "misses", "compiles",
    "scores_quarantined", "chunks_ingested", "checkpoints_written",
    "redeliveries_dropped", "delivery_retries", "tier_outages",
})

# HELP text per terminal path component (kept to the metrics whose
# meaning is not obvious from the name alone)
_HELP = {
    "docs": "documents ingested (padding excluded)",
    "admits": "reservoir admissions (the SHP write law's realization)",
    "evictions": "reservoir evictions",
    "bar_candidates": "candidates tested against the entry bar",
    "bar_passes": "candidates that cleared the entry bar",
    "chunks": "jitted fleet steps executed",
    "drift_fired": "drift-detector firings folded into the device state",
    "observed": "documents observed by the host meter",
    "writes": "tier write transactions",
    "reads": "tier read transactions (final top-K)",
    "deletes": "tier delete transactions",
    "migrations": "documents cascaded across a boundary",
    "relocations": "residents re-tiered by online re-plans",
    "resident_steps": "doc-step storage rental integral (obs.costs)",
    "planned_total": "closed-form expected spend at the current position",
    "regret": "realized minus planned spend",
    "max_burn_ratio": "worst realized/planned spend over the long burn "
                      "window",
    "recorded": "events captured on the obs timeline",
    "dropped": "events dropped past max_events",
    "scores_quarantined": "non-finite scores swapped for pad slots "
                          "before the reservoir compare",
    "chunks_ingested": "chunk boundaries consumed (the ingest cursor)",
    "checkpoints_written": "fleet checkpoints committed (atomic renames)",
    "redeliveries_dropped": "duplicate chunk deliveries skipped by the "
                            "idempotent redelivery guard",
    "delivery_retries": "transient chunk-delivery failures retried",
    "tier_outages": "tier outage declarations (cumulative)",
}


def _clean(name: str) -> str:
    n = _NAME_RE.sub("_", name)
    return n if not n[:1].isdigit() else "_" + n


def _flatten(snap, path: Tuple[str, ...] = ()) -> Iterable[Tuple]:
    if isinstance(snap, dict):
        for k in sorted(snap):
            yield from _flatten(snap[k], path + (str(k),))
    elif isinstance(snap, bool):
        yield path, None, float(snap)
    elif isinstance(snap, (int, float)):
        yield path, None, float(snap)
    elif isinstance(snap, (list, tuple)):
        for i, v in enumerate(snap):
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                yield path, i, float(v)


def _leaf_kind(path: Tuple[str, ...]) -> Tuple[str, Optional[str]]:
    """(type, help) for a flattened path, keyed by its terminal
    component (the leaf name is the semantic unit; the prefix is just
    the engine/section nesting)."""
    leaf = path[-1] if path else ""
    kind = "counter" if leaf in _COUNTER_LEAVES else "gauge"
    return kind, _HELP.get(leaf)


def to_prometheus(snap: dict, prefix: str = "repro_obs") -> str:
    """Render a snapshot dict as Prometheus text exposition."""
    lines: List[str] = []
    seen_names = set()
    for path, idx, val in _flatten(snap):
        name = _clean("_".join((prefix,) + path))
        if name not in seen_names:
            seen_names.add(name)
            kind, help_text = _leaf_kind(path)
            if help_text is not None:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
        label = f'{{idx="{idx}"}}' if idx is not None else ""
        sval = f"{val:.10g}" if val == val else "NaN"
        lines.append(f"{name}{label} {sval}")
    return "\n".join(lines) + "\n"


def write_snapshot(path: str, snap: dict) -> str:
    """Write a snapshot as deterministic JSON (sorted keys)."""
    with open(path, "w") as f:
        json.dump(snap, f, indent=1, sort_keys=True, default=_json_default)
        f.write("\n")
    return path


def _json_default(v):
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "ndim", 1) == 0:
        return item()
    tolist = getattr(v, "tolist", None)
    if tolist is not None:
        return tolist()
    return repr(v)
