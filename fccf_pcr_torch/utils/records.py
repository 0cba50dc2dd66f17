"""Experiment record appenders (a stdlib-only copy of
``fccf_pcr_tpu/utils/records.py``, pinned to it by
``tests/test_torch_utils.py``).

The reference carries an (uncalled) CSV column appender ``writefile``
(FCCF.cpp:1610-1644, C19) used by the authors' external experiment scripts
to build the per-scene result tables. This module provides the working
equivalents: a row-column CSV appender with the same append-to-line-`pos`
semantics, plus JSONL appending for the sweep driver's structured records.
"""

from __future__ import annotations

import json
import os


def append_csv_cell(path: str, row: int, value) -> None:
    """Append ``value`` as a new column on line ``row`` (creating the file
    or the row if needed) — the reference's writefile contract."""
    s = str(value)
    if any(c in s for c in ",\n\r"):
        # an embedded separator would silently split the cell into extra
        # columns / rows, shifting every later index
        raise ValueError(f"CSV cell value contains a separator: {s!r}")
    lines: list[str] = []
    if os.path.exists(path):
        with open(path) as f:
            lines = f.read().splitlines()
    while len(lines) <= row:
        lines.append("")
    lines[row] = f"{lines[row]},{value}" if lines[row] else str(value)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def append_jsonl(path: str, record: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
