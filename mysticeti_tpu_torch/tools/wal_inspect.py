"""Offline WAL/storage-lifecycle inspector.

The port's copy of the JAX package's ``tools/wal_inspect.py``, over the
port's ``wal.WalReader``, ``block_store`` tags and ``storage`` manifest and
checkpoints; the same report, rendering and exit codes.

Prints, for a node's WAL (segment directory or legacy single file):

* the segment manifest (name, base offset, on-disk size, recorded max round);
* the checkpoint chain (commit height, replay position, validity — a torn or
  corrupt checkpoint is reported, not hidden);
* a per-tag entry census from a full replay (block / payload / own-block /
  state / commit / snapshot), with byte totals;
* torn-tail / unreplayable-state diagnosis.

Exit status: 0 healthy (a torn ACTIVE tail is healthy — recovery truncates
it), non-zero on unreplayable state:

* 2 — a tear inside a SEALED segment (entries after it are unreachable);
* 3 — history below the first live segment was garbage-collected but no
  valid checkpoint covers it (the node cannot boot);
* 4 — manifest missing/corrupt or a listed segment file is gone.

Usage::

    python -m mysticeti_tpu_torch.tools.wal_inspect <wal-path> [--json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from mysticeti_tpu_torch.block_store import (
    WAL_ENTRY_BLOCK,
    WAL_ENTRY_COMMIT,
    WAL_ENTRY_OWN_BLOCK,
    WAL_ENTRY_PAYLOAD,
    WAL_ENTRY_SNAPSHOT,
    WAL_ENTRY_STATE,
)
from mysticeti_tpu_torch.storage import (
    Checkpoint,
    MANIFEST_NAME,
    checkpoint_files,
)
from mysticeti_tpu_torch.wal import HEADER_SIZE, WalReader

TAG_NAMES = {
    WAL_ENTRY_BLOCK: "block",
    WAL_ENTRY_PAYLOAD: "payload",
    WAL_ENTRY_OWN_BLOCK: "own-block",
    WAL_ENTRY_STATE: "state",
    WAL_ENTRY_COMMIT: "commit",
    WAL_ENTRY_SNAPSHOT: "snapshot",
}


def _scan_file(path: str, base: int, census: dict) -> int:
    """Replay one segment file; returns bytes consumed (== file size iff the
    segment replays cleanly to its end)."""
    reader = WalReader(path)
    consumed = 0
    try:
        for pos, tag, payload in reader.iter_until():
            entry = HEADER_SIZE + len(payload)
            consumed = pos + entry
            name = TAG_NAMES.get(tag, f"tag-{tag}")
            count, total = census.get(name, (0, 0))
            census[name] = (count + 1, total + entry)
    finally:
        reader.close()
    return consumed


def inspect(path: str) -> dict:
    report: dict = {
        "path": path,
        "segments": [],
        "checkpoints": [],
        "census": {},
        "problems": [],
        "exit_code": 0,
    }
    census: dict = {}

    if os.path.isfile(path):
        report["layout"] = "single-file"
        size = os.path.getsize(path)
        consumed = _scan_file(path, 0, census)
        report["segments"].append(
            {"name": os.path.basename(path), "base": 0, "size": size,
             "replayed": consumed}
        )
        if consumed < size:
            report["torn_tail_bytes"] = size - consumed
    elif os.path.isdir(path):
        report["layout"] = "segmented"
        manifest_path = os.path.join(path, MANIFEST_NAME)
        try:
            with open(manifest_path, "r", encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, ValueError) as exc:
            report["problems"].append(f"manifest unreadable: {exc}")
            report["exit_code"] = 4
            report["census"] = {}
            return report
        segments = manifest.get("segments", [])
        for i, entry in enumerate(segments):
            seg_path = os.path.join(path, entry["name"])
            row = {"name": entry["name"], "base": entry["base"],
                   "max_round": entry.get("max_round", 0)}
            if not os.path.exists(seg_path):
                row["missing"] = True
                report["problems"].append(
                    f"segment {entry['name']} listed in manifest but missing"
                )
                report["exit_code"] = 4
                report["segments"].append(row)
                continue
            size = os.path.getsize(seg_path)
            consumed = _scan_file(seg_path, entry["base"], census)
            row["size"] = size
            row["replayed"] = consumed
            report["segments"].append(row)
            if consumed < size:
                if i == len(segments) - 1:
                    report["torn_tail_bytes"] = size - consumed
                else:
                    report["problems"].append(
                        f"tear inside SEALED segment {entry['name']} at local "
                        f"offset {consumed}: {len(segments) - 1 - i} later "
                        "segment(s) unreachable on replay"
                    )
                    report["exit_code"] = max(report["exit_code"], 2)
        first_base = segments[0]["base"] if segments else 0
        valid_ckpt = False
        for ckpt_path in checkpoint_files(path):
            row = {"name": os.path.basename(ckpt_path)}
            try:
                with open(ckpt_path, "rb") as f:
                    ckpt = Checkpoint.from_bytes(f.read())
                row.update(
                    commit_height=ckpt.commit_height,
                    wal_position=ckpt.wal_position,
                    gc_round=ckpt.gc_round,
                    index_entries=len(ckpt.index),
                    committed_refs=len(ckpt.committed_refs),
                    chain_digest=ckpt.chain_digest.hex()[:16],
                    valid=True,
                )
                if ckpt.wal_position >= first_base:
                    valid_ckpt = True
                else:
                    row["stale"] = (
                        "replay position below first live segment"
                    )
            except Exception as exc:  # noqa: BLE001 - any parse failure = corrupt
                row["valid"] = False
                row["error"] = str(exc)
                report["problems"].append(
                    f"checkpoint {row['name']} unusable: {exc}"
                )
            report["checkpoints"].append(row)
        if first_base > 0 and not valid_ckpt:
            report["problems"].append(
                f"history below offset {first_base} was garbage-collected "
                "but no valid checkpoint covers it: UNREPLAYABLE"
            )
            report["exit_code"] = max(report["exit_code"], 3)
    else:
        report["problems"].append("path is neither a file nor a directory")
        report["exit_code"] = 4

    report["census"] = {
        name: {"entries": count, "bytes": total}
        for name, (count, total) in sorted(census.items())
    }
    return report


def render(report: dict) -> str:
    lines = [f"WAL at {report['path']} ({report.get('layout', '?')})"]
    lines.append("  segments:")
    for seg in report["segments"]:
        if seg.get("missing"):
            lines.append(f"    {seg['name']}  MISSING")
            continue
        torn = ""
        if seg.get("replayed", seg.get("size", 0)) < seg.get("size", 0):
            torn = f"  (replays {seg['replayed']}/{seg['size']})"
        lines.append(
            f"    {seg['name']}  base={seg['base']}  size={seg.get('size')}"
            f"  max_round={seg.get('max_round', '-')}{torn}"
        )
    if report["checkpoints"]:
        lines.append("  checkpoints (newest first):")
        for ckpt in report["checkpoints"]:
            if ckpt.get("valid"):
                stale = f"  STALE({ckpt['stale']})" if "stale" in ckpt else ""
                lines.append(
                    f"    {ckpt['name']}  height={ckpt['commit_height']}"
                    f"  replay_from={ckpt['wal_position']}"
                    f"  gc_round={ckpt['gc_round']}"
                    f"  index={ckpt['index_entries']}"
                    f"  chain={ckpt['chain_digest']}{stale}"
                )
            else:
                lines.append(f"    {ckpt['name']}  CORRUPT: {ckpt['error']}")
    elif report.get("layout") == "segmented":
        lines.append("  checkpoints: none")
    lines.append("  entry census:")
    for name, row in report["census"].items():
        lines.append(
            f"    {name:<10} {row['entries']:>8} entries  {row['bytes']:>12} bytes"
        )
    if "torn_tail_bytes" in report:
        lines.append(
            f"  torn active tail: {report['torn_tail_bytes']} bytes "
            "(healthy: recovery truncates it)"
        )
    if report["problems"]:
        lines.append("  PROBLEMS:")
        for problem in report["problems"]:
            lines.append(f"    ! {problem}")
    else:
        lines.append("  state: replayable")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path", help="WAL directory (segmented) or file")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable report")
    args = parser.parse_args(argv)
    report = inspect(args.path)
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(render(report))
    return report["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
