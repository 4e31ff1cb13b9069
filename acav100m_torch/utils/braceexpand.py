"""Minimal bash-style brace expansion.

The reference relies on the ``braceexpand`` PyPI package to expand shard
specs like ``shard-{000000..000019}.tar``
(``feature_extraction/code/data/shards.py:16-20``). That package is not in
this image, so the subset used by shard specs is implemented here:

* numeric ranges ``{000..019}`` with zero-padding (and optional ``..step``)
* alpha ranges ``{a..f}``
* comma lists ``{a,b,c}``
* nesting and multiple groups per string
"""

from __future__ import annotations

import re
import string
from typing import Iterator, List

_INT_RANGE = re.compile(r"^(-?\d+)\.\.(-?\d+)(?:\.\.(-?\d+))?$")
_CHAR_RANGE = re.compile(r"^([A-Za-z])\.\.([A-Za-z])(?:\.\.(-?\d+))?$")


def _find_group(text: str):
    """Locate the first balanced, top-level ``{...}`` group."""
    depth = 0
    start = -1
    for i, ch in enumerate(text):
        if ch == "{":
            if depth == 0:
                start = i
            depth += 1
        elif ch == "}":
            if depth > 0:
                depth -= 1
                if depth == 0:
                    return start, i
    return None


def _split_commas(body: str) -> List[str]:
    parts, depth, cur = [], 0, []
    for ch in body:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _expand_body(body: str) -> List[str]:
    m = _INT_RANGE.match(body)
    if m:
        lo_s, hi_s, step_s = m.group(1), m.group(2), m.group(3)
        lo, hi = int(lo_s), int(hi_s)
        step = abs(int(step_s)) if step_s else 1
        step = max(step, 1)
        pad = 0
        if (lo_s.lstrip("-").startswith("0") and len(lo_s.lstrip("-")) > 1) or (
            hi_s.lstrip("-").startswith("0") and len(hi_s.lstrip("-")) > 1
        ):
            pad = max(len(lo_s), len(hi_s))
        rng = range(lo, hi + 1, step) if lo <= hi else range(lo, hi - 1, -step)
        out = []
        for v in rng:
            s = str(abs(v)).zfill(pad - (1 if v < 0 else 0)) if pad else str(abs(v))
            out.append(("-" if v < 0 else "") + s)
        return out
    m = _CHAR_RANGE.match(body)
    if m:
        lo, hi = m.group(1), m.group(2)
        step = abs(int(m.group(3))) if m.group(3) else 1
        letters = string.ascii_uppercase + string.ascii_lowercase
        i, j = letters.index(lo), letters.index(hi)
        rng = range(i, j + 1, step) if i <= j else range(i, j - 1, -step)
        return [letters[k] for k in rng]
    if "," in body:
        parts = _split_commas(body)
        out: List[str] = []
        for part in parts:
            out.extend(braceexpand(part))
        return out
    # not an expandable group: keep braces literally
    return ["{" + body + "}"]


def braceexpand(pattern: str) -> Iterator[str]:
    """Expand ``pattern``; yields the pattern itself if nothing expands."""
    span = _find_group(pattern)
    if span is None:
        yield pattern
        return
    start, end = span
    prefix, body, suffix = pattern[:start], pattern[start + 1 : end], pattern[end + 1 :]
    for mid in _expand_body(body):
        for rest in braceexpand(suffix):
            yield prefix + mid + rest
