"""Per-stage latency breakdown from a MYSTICETI_TRACE Chrome trace file.

The port's copy of the JAX repository's ``tools/trace_report.py``.

Usage:
    python -m mysticeti_tpu_torch.tools.trace_report trace.json [--by-track] [--critical-path]

Reads the trace-event JSON written by ``mysticeti_tpu_torch.spans`` (set
``MYSTICETI_TRACE=/path/out.json`` on a node or testbed run, or load the
same file in Perfetto for the visual timeline) and prints count / p50 / p90 /
p99 / max duration per pipeline stage — the "which stage ate the commit
latency" table.  ``--by-track`` splits the breakdown per authority track.

``--critical-path`` prints commit critical-path attribution instead: per
committed leader (a block with a ``commit`` span), which pipeline stage
dominated its receive -> verify -> dag_add -> proposal_wait -> commit ->
finalize chain, attributed to the leader's authoring authority — the top
blocking (stage, authority) pairs are the fleet's slow edges.

A truncated trace (node SIGKILLed mid-flush, or a live ``.tmp``) is
salvaged: complete events before the tear are recovered with a note
instead of a traceback, and empty stages / span-free traces report
themselves and exit 0.
"""
import argparse
import re
import sys
from collections import defaultdict
from typing import Dict, List, Tuple

from mysticeti_tpu_torch.spans import (
    PIPELINE_STAGES,
    STAGES,
    complete_spans,
    load_trace_events,
    stage_chains,
    track_names,
)


def load_events(path: str) -> Tuple[List[dict], str]:
    """All events from a Chrome trace-event JSON file; salvage + extraction
    live in ``mysticeti_tpu_torch.spans``, SHARED with tools/fleet_trace.py —
    the two offline consumers must never disagree about where a truncated
    trace's stage boundaries are."""
    events, note, _other = load_trace_events(path)
    return events, note


def load_spans(events: List[dict]) -> List[dict]:
    """Complete ("X") span events."""
    return complete_spans(events)


def _track_names(events: List[dict]) -> Dict[Tuple[int, int], str]:
    return track_names(events)


def _pct(ordered: List[float], pct: float) -> float:
    if not ordered:
        return 0.0
    idx = min(len(ordered) - 1, int(len(ordered) * pct / 100))
    return ordered[idx]


def _stage_order(name: str) -> Tuple[int, str]:
    try:
        return (STAGES.index(name), name)
    except ValueError:
        return (len(STAGES), name)


def build_report(spans: List[dict], by_track: bool = False,
                 track_names: Dict[Tuple[int, int], str] = {}) -> str:
    groups: Dict[Tuple, List[float]] = defaultdict(list)
    for e in spans:
        key = (e["name"],)
        if by_track:
            pid_tid = (e.get("pid", 0), e.get("tid", 0))
            key = (e["name"], track_names.get(pid_tid, str(pid_tid[1])))
        groups[key].append(e.get("dur", 0) / 1e3)  # µs -> ms
    if not groups:
        return "no spans in trace"
    header = f"{'stage':<16}" + (f"{'track':<10}" if by_track else "") + (
        f"{'count':>8}{'p50_ms':>10}{'p90_ms':>10}{'p99_ms':>10}{'max_ms':>10}"
    )
    lines = [header]
    for key in sorted(groups, key=lambda k: (_stage_order(k[0]),) + k[1:]):
        durs = sorted(groups[key])
        row = f"{key[0]:<16}"
        if by_track:
            row += f"{key[1]:<10}"
        row += (
            f"{len(durs):>8}"
            f"{_pct(durs, 50):>10.3f}"
            f"{_pct(durs, 90):>10.3f}"
            f"{_pct(durs, 99):>10.3f}"
            f"{(durs[-1] if durs else 0.0):>10.3f}"
        )
        lines.append(row)
    return "\n".join(lines)


# -- commit critical-path attribution ----------------------------------------

_REF_RE = re.compile(r"^A(\d+)R(\d+)#")


def attribute_critical_paths(spans: List[dict]) -> List[dict]:
    """Offline twin of ``health.CriticalPathAnalyzer``: per committed leader
    (block label with a ``commit`` span) and observing track, the pipeline
    stage with the largest duration is THE critical-path edge, attributed to
    the leader's authoring authority.  Returns one record per (leader,
    track).  Stage extraction is the SHARED ``spans.stage_chains`` helper
    (also under tools/fleet_trace.py), so a trace tail truncated mid-flush
    lands on the same stage boundaries in both tools."""
    chains = stage_chains(spans, stages=PIPELINE_STAGES)
    out: List[dict] = []
    for (track, label), chain in chains.items():
        stages = {name: dur / 1e6 for name, (_ts, dur) in chain.items()}
        if "commit" not in stages:
            continue  # never committed (or commit fell past the trace cap)
        match = _REF_RE.match(label)
        blocking = max(stages, key=lambda s: (stages[s], s))
        out.append(
            {
                "leader": label,
                "authority": int(match.group(1)) if match else None,
                "round": int(match.group(2)) if match else None,
                "track": track,
                "blocking_stage": blocking,
                "blocking_s": stages[blocking],
                "stages": stages,
            }
        )
    return out


def build_critical_path_report(spans: List[dict]) -> str:
    attributed = attribute_critical_paths(spans)
    if not attributed:
        return (
            "no committed leaders in trace (nothing reached a `commit` "
            "span); critical-path attribution needs a run that commits"
        )
    # Top blocking (stage, authority) pairs by total blocked seconds.
    pairs: Dict[Tuple[str, int], List[float]] = defaultdict(list)
    per_stage: Dict[str, List[float]] = defaultdict(list)
    for rec in attributed:
        if rec["authority"] is not None:
            pairs[(rec["blocking_stage"], rec["authority"])].append(
                rec["blocking_s"]
            )
        for stage, dur in rec["stages"].items():
            per_stage[stage].append(dur * 1e3)
    lines = [
        f"critical-path attribution over {len(attributed)} committed "
        "leader observation(s)",
        "",
        f"{'stage':<16}{'authority':>10}{'leaders':>9}{'blocked_s':>11}"
        f"{'mean_ms':>10}",
    ]
    ranked = sorted(
        pairs.items(), key=lambda kv: (-sum(kv[1]), kv[0])
    )
    for (stage, authority), durs in ranked[:10]:
        lines.append(
            f"{stage:<16}{authority:>10}{len(durs):>9}"
            f"{sum(durs):>11.3f}{sum(durs) / len(durs) * 1e3:>10.3f}"
        )
    lines.append("")
    lines.append(
        f"{'stage (on path)':<16}{'count':>8}{'p50_ms':>10}{'p90_ms':>10}"
        f"{'max_ms':>10}"
    )
    for stage in sorted(per_stage, key=lambda s: _stage_order(s)):
        durs = sorted(per_stage[stage])
        lines.append(
            f"{stage:<16}{len(durs):>8}{_pct(durs, 50):>10.3f}"
            f"{_pct(durs, 90):>10.3f}{durs[-1]:>10.3f}"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="trace_report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("trace", help="Chrome trace-event JSON (MYSTICETI_TRACE output)")
    parser.add_argument(
        "--by-track", action="store_true",
        help="split the breakdown per authority track",
    )
    parser.add_argument(
        "--critical-path", action="store_true",
        help="commit critical-path attribution: top blocking "
        "(stage, authority) pairs per committed leader",
    )
    args = parser.parse_args(argv)
    try:
        events, note = load_events(args.trace)
    except OSError as exc:
        print(f"error: cannot read trace {args.trace}: {exc}", file=sys.stderr)
        return 2
    if note:
        print(note, file=sys.stderr)
    spans = load_spans(events)
    if args.critical_path:
        print(build_critical_path_report(spans))
        return 0
    names = _track_names(events) if args.by_track else {}
    print(build_report(spans, by_track=args.by_track, track_names=names))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
