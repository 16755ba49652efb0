"""Explain why a leader slot committed or skipped, from a decision ledger.

The port's copy of the JAX package's ``tools/commit_explain.py``.  The
committer's decision ledger (``mysticeti_tpu_torch/decisions.py``) records
one structured record per decided leader slot: the commit rule that
decided it, the certificate/blame stake tallies with the contributing
authorities, the anchor used by indirect decisions, and how far behind
the DAG frontier the decision landed.  This tool renders those records
as the human-readable causal explanation
(:func:`mysticeti_tpu_torch.decisions.explain_record`), from either a live
node's ``/debug/consensus`` route or a dumped ledger JSON.

Usage:
    # explain one slot from a live node ("A3R42" = authority 3, round 42)
    python -m mysticeti_tpu_torch.tools.commit_explain --url http://127.0.0.1:1600 A3R42

    # explain the last N records (default 10) when no slot is named
    python -m mysticeti_tpu_torch.tools.commit_explain --url http://127.0.0.1:1600 --last 20

    # or from a saved /debug/consensus document / ledger dump
    python -m mysticeti_tpu_torch.tools.commit_explain --file consensus.json A3R42

    # skips only (the records an operator actually asks about)
    python -m mysticeti_tpu_torch.tools.commit_explain --file consensus.json --skips

Exit status: 0 when every requested slot had a record, 1 when a named
slot has no record in the (bounded) ledger window.
"""
from __future__ import annotations

import argparse
import json
import re
import urllib.request
from typing import List, Optional

from mysticeti_tpu_torch.decisions import explain_record

_SLOT_RE = re.compile(r"^[aA](\d+)[rR](\d+)$")
_LEDGER_SLOT_RE = re.compile(r"^([A-Za-z])(\d+)$")


def parse_slot(text: str) -> Optional[tuple]:
    """Slot name -> (authority, round).

    Accepts the explicit ``A3R42`` form (authority 3, round 42) and the
    ledger's own letter-coded ``repr(AuthorityRound)`` form ``D42``
    (authority D = index 3, round 42).  None when neither matches.
    """
    text = text.strip()
    match = _SLOT_RE.match(text)
    if match:
        return int(match.group(1)), int(match.group(2))
    match = _LEDGER_SLOT_RE.match(text)
    if match:
        return ord(match.group(1).upper()) - ord("A"), int(match.group(2))
    return None


def load_records(args) -> tuple:
    """(records, context) from --file or --url.  Accepts either the full
    ``/debug/consensus`` document or a bare list of records (a dumped
    ``DecisionLedger.records()``)."""
    if args.file:
        with open(args.file) as f:
            doc = json.load(f)
    else:
        url = args.url.rstrip("/") + "/debug/consensus"
        with urllib.request.urlopen(url, timeout=args.timeout) as resp:
            doc = json.loads(resp.read().decode())
    if isinstance(doc, list):
        return doc, {}
    if isinstance(doc, dict):
        records = doc.get("records")
        if isinstance(records, list):
            context = {k: v for k, v in doc.items() if k != "records"}
            return records, context
    raise SystemExit("unrecognized ledger document shape")


def render_context(context: dict) -> str:
    parts = []
    for key in ("authority", "threshold_clock_round", "highest_round",
                "last_decided", "recorded", "dropped"):
        if key in context:
            parts.append(f"{key}={context[key]}")
    undecided = context.get("undecided")
    if undecided:
        parts.append(f"undecided={','.join(undecided)}")
    return "  ".join(parts)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="commit_explain", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("slots", nargs="*",
                        help="leader slots to explain: A3R42 (authority 3, "
                        "round 42) or the ledger's letter form D42; "
                        "empty = the last --last")
    parser.add_argument("--url", default=None,
                        help="node metrics endpoint (reads /debug/consensus)")
    parser.add_argument("--file", default=None,
                        help="saved /debug/consensus document or a dumped "
                        "record list")
    parser.add_argument("--last", type=int, default=10,
                        help="with no slots named: explain the newest N "
                        "records (default 10)")
    parser.add_argument("--skips", action="store_true",
                        help="restrict the no-slots listing to skips")
    parser.add_argument("--timeout", type=float, default=5.0)
    args = parser.parse_args(argv)
    if bool(args.url) == bool(args.file):
        parser.error("need exactly one of --url or --file")

    slots: List[tuple] = []
    for text in args.slots:
        slot = parse_slot(text)
        if slot is None:
            parser.error(f"not a slot name: {text!r} (expected e.g. A3R42)")
        slots.append(slot)

    records, context = load_records(args)
    header = render_context(context)
    if header:
        print(f"# {header}")

    missing = 0
    if slots:
        for authority, round_ in slots:
            record = next(
                (
                    r
                    for r in reversed(records)
                    if r.get("authority") == authority
                    and r.get("round") == round_
                ),
                None,
            )
            if record is None:
                print(f"slot A{authority}R{round_}: no record in the ledger "
                      "window (undecided, pre-ring, or rolled off)")
                missing += 1
            else:
                print(explain_record(record))
    else:
        chosen = [
            r for r in records
            if not args.skips or r.get("outcome") == "skip"
        ][-args.last:]
        if not chosen:
            print("no matching records in the ledger window")
        for record in chosen:
            print(explain_record(record))
    return 1 if missing else 0


if __name__ == "__main__":
    raise SystemExit(main())
