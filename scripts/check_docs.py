"""Docs-truth gate: every **bolded** throughput number in README.md /
docs/ARCHITECTURE.md must match a recorded measurement.

The recorded measurements are the JSON lines of PERF_LEDGER.jsonl (the
per-PR benchmark ledger): every row carrying ``unit == "voxel-iters/s"``
and a numeric ``value`` whitelists that value at the docs' 0.1M
precision. Docs that make no bolded throughput claim pass; a bolded
claim that no recorded row backs fails.

Run standalone (exits non-zero on drift) or via
tests/test_examples.py::test_docs_numbers_match_artifacts.
"""

from __future__ import annotations

import json
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = ["README.md", "docs/ARCHITECTURE.md"]


def _collect_values(obj, out):
    """Numeric `value` fields from rows whose `unit` is voxel-iters/s.

    Only throughput rows whitelist claims, so a claim cannot match an
    unrelated number (a ms row, a scaling efficiency)."""
    if isinstance(obj, dict):
        v = obj.get("value")
        if obj.get("unit") == "voxel-iters/s" and isinstance(v, (int, float)):
            out.append(float(v))
        for v in obj.values():
            _collect_values(v, out)
    elif isinstance(obj, list):
        for v in obj:
            _collect_values(v, out)


def allowed_numbers():
    """Throughput values (in raw voxel-iters/s) from PERF_LEDGER.jsonl."""
    vals = []
    path = os.path.join(REPO, "PERF_LEDGER.jsonl")
    if not os.path.exists(path):
        return vals
    with open(path) as f:
        for line in f:
            try:
                _collect_values(json.loads(line), vals)
            except json.JSONDecodeError:
                continue
    return vals


def bolded_throughput_claims(text):
    """(number_string, span_excerpt) for every number inside a bold span
    that mentions voxel-iters/s. Bold spans may wrap lines."""
    claims = []
    for m in re.finditer(r"\*\*([^*]+?)\*\*", text, re.DOTALL):
        span = " ".join(m.group(1).split())
        if "voxel-iters/s" not in span:
            continue
        for num in re.findall(r"(\d+(?:\.\d+)?)M\b", span):
            claims.append((num, span))
    return claims


def main() -> int:
    allowed = allowed_numbers()
    bad = []
    for doc in DOCS:
        path = os.path.join(REPO, doc)
        text = open(path).read()
        for num, span in bolded_throughput_claims(text):
            # numeric comparison: a claim matches if it is within 0.05M
            # of a recorded throughput value — i.e. the record rounds to
            # it at the docs' 0.1M precision.
            claim = float(num) * 1e6
            if not any(abs(claim - v) <= 0.05e6 for v in allowed):
                bad.append((doc, num, span))
    if bad:
        for doc, num, span in bad:
            print(f"DRIFT {doc}: bolded claim {num}M not within 0.05M of "
                  f"any recorded throughput row (span: {span[:90]!r})")
        print("allowed values: "
              f"{sorted(f'{v / 1e6:.1f}' for v in set(allowed))}")
        return 1
    n = sum(
        len(bolded_throughput_claims(open(os.path.join(REPO, d)).read()))
        for d in DOCS
    )
    print(f"check_docs: {n} bolded throughput claims, all recorded")
    return 0


if __name__ == "__main__":
    sys.exit(main())
