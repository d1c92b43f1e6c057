"""JSON QC report, byte-layout matching the reference's hand-rolled emitter.

Behavioral spec: reference src/jsonreporter.cpp:11-42 + src/stats.cpp:153-193
+ src/bed.cpp:81-98. The schema is the machine-readable observability surface
(summary{mapping_rate,duplication_rate,single_stranded_consensus_sequence,
duplex_consensus_sequence}, before_processing/after_processing{...}, command).
"""

from __future__ import annotations

from reference.options import Options
from reference.stats import Stats, _cxx_num


def report_lines(pre: Stats, post: Stats, has_bed: bool) -> list:
    """The report's lines up to, not including, the command's line."""
    lines = []
    lines.append("{")
    lines.append('\t"summary": {')
    lines.append(f'\t\t"mapping_rate":{_cxx_num(pre.mapping_rate())},')
    lines.append(f'\t\t"duplication_rate":{_cxx_num(pre.dup_rate())},')
    lines.append(f'\t\t"single_stranded_consensus_sequence":{post.sscs_num},')
    lines.append(f'\t\t"duplex_consensus_sequence":{post.dcs_num}')
    lines.append("\t},")
    lines.append('\t"before_processing": {')
    lines.extend(pre.report_json_lines(has_bed))
    # reportJSON ends its block with endl, then the reporter adds another
    # (jsonreporter.cpp:28-35): a blank line before the closing brace
    lines.append("")
    lines.append("\t},")
    lines.append('\t"after_processing": {')
    lines.extend(post.report_json_lines(has_bed))
    lines.append("")
    lines.append("\t},")
    return lines


def write_json_report(path: str, opt: Options, pre: Stats, post: Stats,
                      command: str = "") -> None:
    lines = report_lines(pre, post, opt.has_bed_file)
    lines.append(f'\t"command": "{command}"')
    with open(path, "w") as f:
        f.write("\n".join(lines))
        f.write("\n}")
