"""Console display helpers: status lines, progress, and tables.

The port's copy of ``mysticeti_tpu.orchestrator.display``.

Capability parity with ``orchestrator/src/display.rs`` (:1-104) — colored
action/status output and tabular summaries for the benchmark CLI.  ANSI color
is applied only when the stream is a TTY (or ``FORCE_COLOR`` is set), so logs
piped to files stay clean.
"""
from __future__ import annotations

import os
import shutil
import sys
from typing import IO, Iterable, List, Optional, Sequence


def _use_color(stream: IO[str]) -> bool:
    if os.environ.get("NO_COLOR"):
        return False
    if os.environ.get("FORCE_COLOR"):
        return True
    return hasattr(stream, "isatty") and stream.isatty()


def _paint(text: str, code: str, stream: IO[str]) -> str:
    return f"\x1b[{code}m{text}\x1b[0m" if _use_color(stream) else text


def action(message: str, stream: Optional[IO[str]] = None) -> None:
    """A step being started: bold cyan arrow prefix (display.rs `action`)."""
    stream = stream or sys.stdout
    print(f"{_paint('==>', '1;36', stream)} {message}", file=stream, flush=True)


def status(message: str, stream: Optional[IO[str]] = None) -> None:
    """A normal progress line, indented under the current action."""
    stream = stream or sys.stdout
    print(f"    {message}", file=stream, flush=True)


def done(message: str = "done", stream: Optional[IO[str]] = None) -> None:
    stream = stream or sys.stdout
    print(f"    {_paint(message, '1;32', stream)}", file=stream, flush=True)


def warn(message: str, stream: Optional[IO[str]] = None) -> None:
    stream = stream or sys.stderr
    print(f"{_paint('warning:', '1;33', stream)} {message}", file=stream, flush=True)


def error(message: str, stream: Optional[IO[str]] = None) -> None:
    stream = stream or sys.stderr
    print(f"{_paint('error:', '1;31', stream)} {message}", file=stream, flush=True)


def progress(current: int, total: int, label: str = "",
             stream: Optional[IO[str]] = None, width: int = 30) -> None:
    """Single-line progress bar, redrawn in place on TTYs."""
    stream = stream or sys.stdout
    total = max(total, 1)
    filled = int(width * min(current, total) / total)
    bar = "#" * filled + "-" * (width - filled)
    line = f"[{bar}] {current}/{total} {label}".rstrip()
    if _use_color(stream):
        print(f"\r{line}\x1b[K", end="" if current < total else "\n",
              file=stream, flush=True)
    else:
        print(line, file=stream, flush=True)


def format_table(headers: Sequence[str], rows: Iterable[Sequence[object]]) -> str:
    """Fixed-width table (display.rs' prettytable equivalent)."""
    str_rows: List[List[str]] = [[str(c) for c in row] for row in rows]
    widths = [len(h) for h in headers]
    for row in str_rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(cell))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep, "| " + " | ".join(h.ljust(w) for h, w in zip(headers, widths)) + " |", sep]
    for row in str_rows:
        out.append("| " + " | ".join(c.ljust(w) for c, w in zip(row, widths)) + " |")
    out.append(sep)
    return "\n".join(out)


def print_table(headers: Sequence[str], rows: Iterable[Sequence[object]],
                stream: Optional[IO[str]] = None) -> None:
    print(format_table(headers, rows), file=stream or sys.stdout, flush=True)


def terminal_width(default: int = 80) -> int:
    return shutil.get_terminal_size((default, 24)).columns
