"""Fleet causal trace merge: stitch N nodes' span traces into block journeys.

The port's copy of the JAX repository's ``tools/fleet_trace.py``.

Per-node traces (``MYSTICETI_TRACE``) explain where a block's latency went
INSIDE one validator; the latency the paper actually claims spans the fleet:

    propose @ author -> wire transit -> receive/verify/dag_add @ every peer
    -> proposal_wait -> commit -> finalize

This tool joins any number of trace files on block reference into one causal
timeline per committed leader, with cross-node timestamps made comparable by
a **clock-skew estimator**:

* every trace carries a ``(runtime, wall)`` clock anchor (``otherData``),
  mapping its span timestamps to that node's wall clock;
* the ``transit`` spans recorded from the tag-12 frame timestamps carry the
  RAW signed one-way transit per link (``raw_us``) plus the link's smoothed
  RTT (``rtt_us``) from the existing ping/pong exchange in ``network.py``;
* per-link offsets come from **min-transit alignment** — for a link
  observed in both directions, ``(min raw(a->b) - min raw(b->a)) / 2`` is
  the clock offset under a symmetric minimum path delay — refined by the
  RTT/2 rule (``min raw - rtt/2``) when only one direction was observed;
* offsets are propagated from the lowest observed authority over the link
  graph, and the resulting **skew table is embedded in the merged
  artifact** so cross-node deltas in it are meaningful.

Outputs: per-stage fleet percentiles, per-link wire latency, a "slowest
journeys" table, and the merged JSON artifact (``--out``).  ``--block REF``
prints a per-node waterfall for one journey.  Truncated/mid-flush traces
are salvaged through the SAME loader + stage extraction the critical-path
report uses (``mysticeti_tpu_torch.spans``), so the two tools can never disagree
about a torn file's stage boundaries.  The merged output is a pure function
of the inputs (no wall-clock-of-now anywhere), so merging a seeded sim's
trace is byte-identical across same-seed runs.

Usage:
    python -m mysticeti_tpu_torch.tools.fleet_trace trace-*.json --out TRACE.json
    python -m mysticeti_tpu_torch.tools.fleet_trace trace-*.json --block A2R141
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from mysticeti_tpu_torch.spans import (
    PIPELINE_STAGES,
    STAGES,
    complete_spans,
    load_trace_events,
    stage_chains,
    track_names,
)

_REF_RE = re.compile(r"^A(\d+)R(\d+)#")
_TRACK_RE = re.compile(r"^A(\d+)$")

# Stages that participate in a journey timeline (everything per-block).
JOURNEY_STAGES = ("propose", "transit") + PIPELINE_STAGES


def _pct(ordered: List[float], pct: float) -> float:
    if not ordered:
        return 0.0
    idx = min(len(ordered) - 1, int(len(ordered) * pct / 100))
    return ordered[idx]


# ---------------------------------------------------------------------------
# Loading


def load_fleet(paths: List[str]):
    """Load every trace; returns (per-(authority,label) stage chains with
    wall-converted start timestamps, transit observations, notes).

    ``chains[(authority, label)] = {stage: (wall_ts_us, dur_us)}`` merged
    across files (earliest start, longest duration — the shared extraction
    rule).  ``transits`` is a list of ``{src, dst, label, raw_us, rtt_us,
    arrival_us}``.
    """
    chains: Dict[Tuple[int, str], Dict[str, Tuple[float, int]]] = {}
    transits: List[dict] = []
    notes: List[str] = []
    anchored = 0
    for path in paths:
        events, note, other = load_trace_events(path)
        if note:
            notes.append(f"{os.path.basename(path)}: {note}")
        spans = complete_spans(events)
        names = track_names(events)
        offset_us = 0.0
        if other.get("clock_wall_us") is not None:
            offset_us = other["clock_wall_us"] - other.get(
                "clock_runtime_us", 0
            )
            anchored += 1
        else:
            notes.append(
                f"{os.path.basename(path)}: no clock anchor (pre-r9 trace?);"
                " timestamps used as-is"
            )

        def authority_of(track: Tuple[int, int]) -> Optional[int]:
            match = _TRACK_RE.match(names.get(track, ""))
            if match:
                return int(match.group(1))
            return track[1] if track[1] < (1 << 20) else None

        for (track, label), chain in stage_chains(spans).items():
            authority = authority_of(track)
            if authority is None:
                continue
            merged = chains.setdefault((authority, label), {})
            for stage, (ts, dur) in chain.items():
                wall = ts + offset_us
                prev = merged.get(stage)
                if prev is None:
                    merged[stage] = (wall, dur)
                else:
                    merged[stage] = (min(prev[0], wall), max(prev[1], dur))
        for e in spans:
            if e.get("name") != "transit":
                continue
            args = e.get("args") or {}
            dst = authority_of((e.get("pid", 0), e.get("tid", 0)))
            src = args.get("src")
            raw_us = args.get("raw_us")
            if dst is None or src is None or raw_us is None:
                continue
            transits.append(
                {
                    "src": int(src),
                    "dst": int(dst),
                    "label": args.get("block"),
                    "raw_us": int(raw_us),
                    "rtt_us": args.get("rtt_us"),
                    "arrival_us": e.get("ts", 0) + e.get("dur", 0) + offset_us,
                }
            )
    return chains, transits, notes, anchored


# ---------------------------------------------------------------------------
# Clock-skew estimation


def estimate_skew(transits: List[dict], authorities: List[int]) -> dict:
    """Per-authority wall-clock offsets from the transit observations.

    ``offset[a]`` is authority a's clock error relative to the reference
    (lowest observed authority); subtract it from a's timestamps to land on
    the fleet-common clock.  Links observed both ways use min-transit
    alignment; one-way links fall back to ``min raw - rtt/2``.
    """
    links: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    rtts: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for obs in transits:
        key = (obs["src"], obs["dst"])
        links[key].append(obs["raw_us"])
        if obs.get("rtt_us") is not None:
            rtts[key].append(obs["rtt_us"])

    # Pairwise estimates: delta[(a, b)] = offset[b] - offset[a].
    delta: Dict[Tuple[int, int], Tuple[float, str]] = {}
    for (a, b) in sorted(links):
        if (b, a) in delta or (a, b) in delta:
            continue
        fwd = min(links[(a, b)])
        if (b, a) in links:
            rev = min(links[(b, a)])
            delta[(a, b)] = ((fwd - rev) / 2.0, "min-transit")
        else:
            rtt = min(rtts[(a, b)]) if rtts.get((a, b)) else None
            if rtt is not None:
                delta[(a, b)] = (fwd - rtt / 2.0, "rtt-half")
            else:
                # Last resort: assume the observed minimum IS the offset
                # plus zero delay — still better than nothing for ordering.
                delta[(a, b)] = (float(fwd), "min-raw")

    # Propagate from the reference over the link graph (deterministic BFS).
    adjacency: Dict[int, List[Tuple[int, float]]] = defaultdict(list)
    for (a, b), (d, _method) in delta.items():
        adjacency[a].append((b, d))
        adjacency[b].append((a, -d))
    offsets: Dict[int, float] = {}
    methods: Dict[int, str] = {}
    for start in sorted(authorities):
        if start in offsets:
            continue
        offsets[start] = 0.0
        methods[start] = "reference"
        queue = [start]
        while queue:
            node = queue.pop(0)
            for peer, d in sorted(adjacency.get(node, [])):
                if peer in offsets:
                    continue
                offsets[peer] = offsets[node] + d
                methods[peer] = "derived"
                queue.append(peer)
    for a in authorities:
        if a not in offsets:
            offsets[a] = 0.0
            methods[a] = "unobserved"

    link_stats = {}
    for (a, b), raws in sorted(links.items()):
        ordered = sorted(raws)
        corrected = sorted(
            r - (offsets.get(b, 0.0) - offsets.get(a, 0.0)) for r in raws
        )
        link_stats[f"{a}->{b}"] = {
            "samples": len(ordered),
            "raw_min_ms": round(ordered[0] / 1e3, 3),
            "raw_p50_ms": round(_pct(ordered, 50) / 1e3, 3),
            "latency_min_ms": round(corrected[0] / 1e3, 3),
            "latency_p50_ms": round(_pct(corrected, 50) / 1e3, 3),
            "latency_p99_ms": round(_pct(corrected, 99) / 1e3, 3),
            "rtt_min_ms": (
                round(min(rtts[(a, b)]) / 1e3, 3) if rtts.get((a, b)) else None
            ),
        }
    return {
        "reference": min(authorities) if authorities else None,
        "offsets_us": {
            str(a): round(offsets[a], 1) for a in sorted(offsets)
        },
        "method": {str(a): methods[a] for a in sorted(methods)},
        "pairwise": {
            f"{a}->{b}": {"delta_us": round(d, 1), "method": m}
            for (a, b), (d, m) in sorted(delta.items())
        },
        "links": link_stats,
    }


# ---------------------------------------------------------------------------
# Journey stitching


def build_journeys(chains, transits, offsets_us: Dict[str, float]):
    """One causal record per block that committed anywhere.

    Timestamps are skew-corrected (observer's offset subtracted) and made
    relative to the journey's ``propose`` edge (or its earliest observed
    event when the author's trace is missing)."""
    by_label: Dict[str, Dict[int, Dict[str, Tuple[float, int]]]] = defaultdict(dict)
    for (authority, label), chain in chains.items():
        by_label[label][authority] = chain
    transit_by_label: Dict[str, List[dict]] = defaultdict(list)
    for obs in transits:
        if obs.get("label"):
            transit_by_label[obs["label"]].append(obs)

    have_transit_data = bool(transits)
    journeys: List[dict] = []
    for label in sorted(
        by_label,
        key=lambda lbl: (
            (int(m.group(2)), int(m.group(1)), lbl)
            if (m := _REF_RE.match(lbl))
            else (1 << 62, 0, lbl)
        ),
    ):
        nodes = by_label[label]
        if not any("commit" in chain for chain in nodes.values()):
            continue  # never committed: not a journey (yet)
        match = _REF_RE.match(label)
        author = int(match.group(1)) if match else None
        round_ = int(match.group(2)) if match else None

        def corrected(authority: int, ts: float) -> float:
            return ts - offsets_us.get(str(authority), 0.0)

        propose_t: Optional[float] = None
        if author is not None and author in nodes:
            entry = nodes[author].get("propose")
            if entry is not None:
                propose_t = corrected(author, entry[0])
        earliest = min(
            corrected(a, ts)
            for a, chain in nodes.items()
            for ts, _dur in chain.values()
        )
        t0 = propose_t if propose_t is not None else earliest
        end = max(
            corrected(a, ts) + dur
            for a, chain in nodes.items()
            for ts, dur in chain.values()
        )
        per_node = {}
        stages_present = set()
        for a in sorted(nodes):
            chain = nodes[a]
            stages_present.update(chain)
            per_node[str(a)] = {
                stage: [
                    round((corrected(a, ts) - t0) / 1e3, 3),
                    round(dur / 1e3, 3),
                ]
                for stage, (ts, dur) in sorted(chain.items())
            }
        transit_ms = {}
        for obs in transit_by_label.get(label, []):
            latency = obs["raw_us"] - (
                offsets_us.get(str(obs["dst"]), 0.0)
                - offsets_us.get(str(obs["src"]), 0.0)
            )
            key = f"{obs['src']}->{obs['dst']}"
            prev = transit_ms.get(key)
            value = round(latency / 1e3, 3)
            transit_ms[key] = value if prev is None else min(prev, value)
        fully_stitched = (
            propose_t is not None
            and set(PIPELINE_STAGES) <= stages_present
            and (bool(transit_ms) or not have_transit_data)
        )
        journeys.append(
            {
                "block": label,
                "author": author,
                "round": round_,
                "observers": sorted(int(a) for a in nodes),
                "e2e_ms": round((end - t0) / 1e3, 3),
                "propose_anchored": propose_t is not None,
                "fully_stitched": bool(fully_stitched),
                "transit_ms": transit_ms,
                "nodes": per_node,
            }
        )
    return journeys


def stage_percentiles(chains) -> Dict[str, dict]:
    per_stage: Dict[str, List[float]] = defaultdict(list)
    for (_authority, _label), chain in chains.items():
        for stage, (_ts, dur) in chain.items():
            per_stage[stage].append(dur / 1e3)
    out = {}
    for stage in sorted(per_stage, key=lambda s: (
        STAGES.index(s) if s in STAGES else len(STAGES), s
    )):
        durs = sorted(per_stage[stage])
        out[stage] = {
            "count": len(durs),
            "p50_ms": round(_pct(durs, 50), 3),
            "p90_ms": round(_pct(durs, 90), 3),
            "p99_ms": round(_pct(durs, 99), 3),
            "max_ms": round(durs[-1], 3),
        }
    return out


# ---------------------------------------------------------------------------
# Rendering


def render_summary(doc: dict) -> str:
    lines = [
        f"fleet trace: {doc['journeys_total']} committed journey(s) from "
        f"{len(doc['inputs'])} trace(s), {doc['fully_stitched']} fully "
        "stitched end-to-end",
    ]
    skew = doc["skew"]
    if skew["offsets_us"]:
        lines.append(
            "skew table (us vs A%s): " % skew["reference"]
            + "  ".join(
                f"A{a}={v:+.0f}" for a, v in skew["offsets_us"].items()
            )
        )
    lines.append("")
    lines.append(f"{'stage':<16}{'count':>8}{'p50_ms':>10}{'p90_ms':>10}"
                 f"{'p99_ms':>10}{'max_ms':>10}")
    for stage, row in doc["stage_percentiles"].items():
        lines.append(
            f"{stage:<16}{row['count']:>8}{row['p50_ms']:>10.3f}"
            f"{row['p90_ms']:>10.3f}{row['p99_ms']:>10.3f}"
            f"{row['max_ms']:>10.3f}"
        )
    if skew["links"]:
        lines.append("")
        lines.append(f"{'link':<10}{'frames':>8}{'min_ms':>10}{'p50_ms':>10}"
                     f"{'p99_ms':>10}{'rtt_min':>10}")
        for link, row in skew["links"].items():
            rtt = row["rtt_min_ms"]
            lines.append(
                f"{link:<10}{row['samples']:>8}{row['latency_min_ms']:>10.3f}"
                f"{row['latency_p50_ms']:>10.3f}{row['latency_p99_ms']:>10.3f}"
                f"{(f'{rtt:.3f}' if rtt is not None else '-'):>10}"
            )
    if doc["slowest"]:
        lines.append("")
        lines.append("slowest journeys:")
        lines.append(f"{'block':<22}{'author':>7}{'e2e_ms':>10}  stages")
        for j in doc["slowest"]:
            worst = ""
            durs = [
                (node[stage][1], stage)
                for node in j["nodes"].values()
                for stage in node
            ]
            if durs:
                top = max(durs)
                worst = f"{top[1]}={top[0]:.1f}ms"
            lines.append(
                f"{j['block']:<22}{j['author'] if j['author'] is not None else '?':>7}"
                f"{j['e2e_ms']:>10.3f}  {worst}"
            )
    return "\n".join(lines)


def render_waterfall(journey: dict) -> str:
    lines = [
        f"journey {journey['block']} (author A{journey['author']}, "
        f"e2e {journey['e2e_ms']:.3f} ms, "
        f"{'fully stitched' if journey['fully_stitched'] else 'partial'})",
        f"{'authority':<10}{'stage':<16}{'start_ms':>10}{'dur_ms':>10}",
    ]
    rows = []
    for a, stages in journey["nodes"].items():
        for stage, (start, dur) in stages.items():
            rows.append((start, int(a), stage, dur))
    for start, a, stage, dur in sorted(rows):
        lines.append(f"A{a:<9}{stage:<16}{start:>10.3f}{dur:>10.3f}")
    if journey["transit_ms"]:
        lines.append("wire transit (skew-corrected): " + "  ".join(
            f"{k}={v:.3f}ms" for k, v in sorted(journey["transit_ms"].items())
        ))
    return "\n".join(lines)


# ---------------------------------------------------------------------------


def merge(paths: List[str], max_journeys: int = 2000, slowest: int = 10) -> dict:
    chains, transits, notes, anchored = load_fleet(paths)
    authorities = sorted({a for (a, _label) in chains})
    skew = estimate_skew(transits, authorities)
    journeys = build_journeys(chains, transits, skew["offsets_us"])
    fully = [j for j in journeys if j["fully_stitched"]]
    ranked = sorted(journeys, key=lambda j: (-j["e2e_ms"], j["block"]))
    if max_journeys and len(journeys) > max_journeys:
        notes = notes + [
            f"note: journeys list capped at {max_journeys} of "
            f"{len(journeys)} (slowest kept; totals cover everything)"
        ]
        kept = set(
            j["block"] for j in ranked[:max_journeys]
        )
        emitted = [j for j in journeys if j["block"] in kept]
    else:
        emitted = journeys
    return {
        "kind": "mysticeti-fleet-trace",
        "inputs": [os.path.basename(p) for p in paths],
        "anchored_inputs": anchored,
        "notes": notes,
        "authorities": authorities,
        "skew": skew,
        "stage_percentiles": stage_percentiles(chains),
        "journeys_total": len(journeys),
        "fully_stitched": len(fully),
        "transit_observations": len(transits),
        "slowest": ranked[:slowest],
        "journeys": emitted,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="fleet_trace", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("traces", nargs="+",
                        help="MYSTICETI_TRACE output files, one per node "
                        "(or one multi-track testbed/sim trace)")
    parser.add_argument("--out", default=None,
                        help="write the merged fleet-trace JSON artifact")
    parser.add_argument("--block", default=None,
                        help="print the waterfall view of one journey "
                        "(block label or its A<n>R<m> prefix)")
    parser.add_argument("--slowest", type=int, default=10)
    parser.add_argument("--max-journeys", type=int, default=2000,
                        help="cap the journeys list in the artifact "
                        "(slowest kept; summary totals always cover all)")
    args = parser.parse_args(argv)
    try:
        doc = merge(args.traces, max_journeys=args.max_journeys,
                    slowest=args.slowest)
    except OSError as exc:
        print(f"error: cannot read trace: {exc}", file=sys.stderr)
        return 2
    for note in doc["notes"]:
        print(note, file=sys.stderr)
    if args.block:
        matches = [
            j for j in doc["journeys"]
            if j["block"] == args.block or j["block"].startswith(args.block)
        ]
        if not matches:
            print(f"no committed journey matches {args.block!r}",
                  file=sys.stderr)
            return 1
        for journey in matches[:3]:
            print(render_waterfall(journey))
    else:
        print(render_summary(doc))
    if args.out:
        tmp = f"{args.out}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, sort_keys=True, separators=(",", ":"))
            f.write("\n")
        os.replace(tmp, args.out)
        print(f"merged fleet trace written to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
