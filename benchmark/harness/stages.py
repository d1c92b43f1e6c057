"""The stage table `cli.main` prints under --debug: one line a stage,
`[stage] <name>: <seconds>s (summed over windows)`."""

from __future__ import annotations

import re

_LINE = re.compile(r"^\[stage\] (\S+): ([0-9.]+)s \(summed over windows\)$")


def parse(text: str) -> dict:
    """{stage: seconds} from a run's standard error."""
    out = {}
    for line in text.splitlines():
        m = _LINE.match(line.strip())
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + float(m.group(2))
    return out


def add(total: dict, part: dict) -> dict:
    for k, v in part.items():
        total[k] = total.get(k, 0.0) + v
    return total
