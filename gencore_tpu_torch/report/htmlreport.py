"""Self-contained HTML QC report with plotly.js charts.

Byte-parity mirror of reference src/htmlreporter.cpp (the deliverable is
the same report markup, validated by tools/golden_compare.py modulo
version/timestamp/command): summary tables (htmlreporter.cpp:56-140, incl.
the reference's reads-with-mismatched-bases cell quirk at line 86 which
prints mBaseMismatches), duplication-level bar chart (355-403), per-contig
genome-coverage red/blue mirror plots with the getYCeiling top-1/500
outlier ceiling (142-237), BED coverage plots (239-303). Numeric fields
use C++ formatting: to_string(double) = fixed 6 decimals, ostream <<
double = %g with 6 significant digits (1e+06, -0)."""

from __future__ import annotations

import datetime

import numpy as np

from gencore_tpu_torch import __version__
from gencore_tpu_torch.options import Options
from gencore_tpu_torch.stats import MAX_SUPPORTING_READS, Stats, _cxx_num

_UNITS = ["", "K", "M", "G", "T", "P"]


def _format_number(number: int) -> str:
    num = float(number)
    order = 0
    while num > 1000.0:
        order += 1
        num /= 1000.0
    if order == 0:
        return str(number)
    return f"{num:.6f} {_UNITS[order]}"


def _to_string(v: float) -> str:
    # C++ to_string(double) -> fixed 6 decimals; 0/0 NaN prints '-nan'
    # on x86 glibc (default QNaN sign bit), x/0 prints 'inf'
    v = float(v)
    if v != v:
        return "-nan"
    if v == float("inf"):
        return "inf"
    if v == float("-inf"):
        return "-inf"
    return f"{v:.6f}"


def _g(v: float) -> str:
    # C++ ostream << double -> %g, 6 significant digits
    return _cxx_num(float(v))


def _y_ceiling(depth_lists: list, denominator: int) -> int:
    """getYCeiling (htmlreporter.cpp:142-166): the size-th largest value
    where size = 1 + total/denominator, zero-filled (returns 0 when fewer
    than `size` positive values exist)."""
    all_vals = (np.concatenate([np.asarray(d, dtype=np.int64)
                                for d in depth_lists])
                if depth_lists else np.zeros(0, dtype=np.int64))
    size = 1 + len(all_vals) // denominator
    top = np.zeros(size, dtype=np.int64)
    nz = np.sort(all_vals)[::-1][:size]
    top[:len(nz)] = nz
    return int(top[-1])


def _list2string(vals) -> str:
    return ",".join(_g(v) for v in vals)


def write_html_report(path: str, opt: Options, pre: Stats, post: Stats,
                      command: str = "") -> None:
    now = datetime.datetime.now()
    ts = (f"{now.year}-{now.month:02d}-{now.day:02d}      "
          f"{now.hour:02d}:{now.minute:02d}:{now.second:02d}")
    h = []
    w = h.append

    # printHeader (htmlreporter.cpp:420-427)
    w("<html><head><meta http-equiv=\"content-type\" content=\"text/html;charset=utf-8\" />")
    w(f"<title>gencore report at {ts} </title>")
    # printJS (462-473)
    w("<script src='https://cdn.plot.ly/plotly-latest.min.js'></script>\n")
    w("\n<script type=\"text/javascript\">\n")
    w("    function showOrHide(divname) {\n")
    w("        div = document.getElementById(divname);\n")
    w("        if(div.style.display == 'none')\n")
    w("            div.style.display = 'block';\n")
    w("        else\n")
    w("            div.style.display = 'none';\n")
    w("    }\n")
    w("</script>\n")
    # printCSS (429-458)
    w("<style type=\"text/css\">\n")
    w("td {border:1px solid #dddddd;padding:5px;font-size:12px;}\n")
    w("table {border:1px solid #999999;padding:2x;border-collapse:collapse; width:800px}\n")
    w(".col1 {width:280px; font-weight:bold;}\n")
    w(".adapter_col {width:500px; font-size:10px;}\n")
    w("img {padding:30px;}\n")
    w("#menu {font-family:Consolas, 'Liberation Mono', Menlo, Courier, monospace;}\n")
    w("#menu a {color:#0366d6; font-size:18px;font-weight:600;line-height:28px;text-decoration:none;font-family:-apple-system, BlinkMacSystemFont, 'Segoe UI', Helvetica, Arial, sans-serif, 'Apple Color Emoji', 'Segoe UI Emoji', 'Segoe UI Symbol'}\n")
    w("a:visited {color: #999999}\n")
    w(".alignleft {text-align:left;}\n")
    w(".alignright {text-align:right;}\n")
    w(".figure {width:800px;height:600px;}\n")
    w(".header {color:#ffffff;padding:1px;height:20px;background:#000000;}\n")
    w(".section_title {color:#ffffff;font-size:20px;padding:5px;text-align:left;background:#663355; margin-top:10px;}\n")
    w(".subsection_title {font-size:16px;padding:5px;margin-top:10px;text-align:left;color:#663355}\n")
    w("#container {text-align:center;padding:3px 3px 3px 10px;font-family:Arail,'Liberation Mono', Menlo, Courier, monospace;}\n")
    w(".menu_item {text-align:left;padding-top:5px;font-size:18px;}\n")
    w(".highlight {text-align:left;padding-top:30px;padding-bottom:30px;font-size:20px;line-height:35px;}\n")
    w("#helper {text-align:left;border:1px dotted #fafafa;color:#777777;font-size:12px;}\n")
    w("#footer {text-align:left;padding:15px;color:#ffffff;font-size:10px;background:#663355;font-family:Arail,'Liberation Mono', Menlo, Courier, monospace;}\n")
    w(".kmer_table {text-align:center;font-size:8px;padding:2px;}\n")
    w(".kmer_table td{text-align:center;font-size:8px;padding:0px;color:#ffffff}\n")
    w(".sub_section_tips {color:#999999;font-size:10px;padding-left:5px;padding-bottom:3px;}\n")
    w(".coverage_div {}\n")
    w(".bed_coverage_div {}\n")
    w("</style>\n")
    w("</head>")
    w("<body><div id='container'>")

    # printSummary (56-140)
    w("\n")
    w(f"<h1 style='text-align:left;'><a href='https://github.com/OpenGene/gencore' target='_blank' style='color:#663355;text-decoration:none;'>{opt.report_title}</a>\n")
    w("<div class='section_div'>\n")
    w("<div class='section_title' onclick=showOrHide('summary')><a name='summary'>Summary</a></div>\n")
    w("<div id='summary'>\n")

    def row(key, v):
        w(f"<tr><td class='col1'>{key}</td><td class='col2'>{v}</td></tr>\n")

    def trow(key, v1, v2):
        w(f"<tr><td class='col1'>{key}</td><td class='col2'>{v1}</td><td class='col3'>{v2}</td></tr>\n")

    w("<div class='subsection_title' onclick=showOrHide('general')>General</div>\n")
    w("<div id='general'>\n")
    w("<table class='summary_table'>\n")
    row("gencore-tpu version:",
        f"{__version__} (<a href='https://github.com/OpenGene/gencore'>https://github.com/OpenGene/gencore</a>)")
    row("mapping rate:", _to_string(pre.mapping_rate()))
    row("duplication rate:", _to_string(pre.dup_rate()))
    row("Single Stranded Consensus Sequence:", str(post.sscs_num))
    row("Duplex Consensus Sequence:", str(post.dcs_num))
    w("</table>\n")
    w("</div>\n")

    w("<div class='subsection_title' onclick=showOrHide('filtering_metrics')>Details</div>\n")
    w("<div id='filtering_metrics'>\n")
    w("<table class='summary_table'>\n")
    trow("", "before processing", "after processing")
    trow("total bases:", _format_number(pre.base), _format_number(post.base))
    trow("mapped bases:", _format_number(pre.mapped_bases()), _format_number(post.mapped_bases()))
    trow("total reads:", _format_number(pre.read), _format_number(post.read))
    trow("mapped reads:", _format_number(pre.mapped_reads()), _format_number(post.mapped_reads()))
    trow("mismatched bases:", _format_number(pre.base_mismatches), _format_number(post.base_mismatches))
    # reference quirk: this row also prints mBaseMismatches (htmlreporter.cpp:86)
    trow("reads with mismatched bases:", _format_number(pre.base_mismatches),
         _format_number(post.base_mismatches))
    trow("mismatch rate:", _to_string(pre.mismatch_rate()), _to_string(post.mismatch_rate()))
    trow("total mapping clusters:", _format_number(pre.cluster), _format_number(post.cluster))
    trow("multiple fragments clusters:", _format_number(pre.multi_molecule_cluster),
         _format_number(post.multi_molecule_cluster))
    trow("total fragments:", _format_number(pre.molecule), _format_number(post.molecule))
    trow("single-end fragments:", _format_number(pre.molecule_se), _format_number(post.molecule_se))
    trow("paired-end fragments:", _format_number(pre.molecule_pe), _format_number(post.molecule_pe))
    w("</table>\n")
    w("</div>\n")
    w("</div>\n")
    w("</div>\n")

    # duplication histogram (355-403)
    w("<div class='section_div'>\n")
    w("<div class='section_title' onclick=showOrHide('duplication')><a name='duplication'>Duplication histogram of mapped reads</a></div>\n")
    w("<div id='duplication'>\n")
    hist = pre.supporting_histogram
    total = MAX_SUPPORTING_READS - 1
    while total > 0 and hist[total] == 0:
        total -= 1
    if total == 0:
        total = 1
    x = list(range(1, total + 1))
    all_count = float(pre.uncounted_supporting_reads) + float(hist[1:total + 1].sum())
    percents = [float(hist[i]) * 100.0 / all_count if all_count > 0 else 0.0
                for i in x]
    uncounted_pct = (100.0 * pre.uncounted_supporting_reads / all_count
                     if all_count > 0 else 0.0)
    w("<div id='duplication_figure'>\n")
    w("<div class='figure' id='plot_duplication' style='height:400px;'></div>\n")
    w("</div>\n")
    w("\n<script type=\"text/javascript\">\n")
    w("var data=[{type:'bar',x:[%s],y:[%s],name: 'Read percent (%%)  ',line:{color:'rgba(128,0,128,1.0)'}\n},];\n"
      % (",".join(map(str, x)), _list2string(percents)))
    w("var layout={title:'%s %% fragments have %d+ duplicated reads', xaxis:{title:'duplication level'}, yaxis:{title:'Fragment percent (%%)'}};\n"
      % (_to_string(uncounted_pct), MAX_SUPPORTING_READS))
    w("Plotly.newPlot('plot_duplication', data, layout);\n")
    w("</script>\n")
    w("</div>\n")
    w("</div>\n")

    # genome coverage mirror plots (168-237)
    w("<div class='section_div'>\n")
    w("<div class='section_title' onclick=showOrHide('coverage')><a name='coverage'>Coverage statistics in genome scale</a></div>\n")
    w("<div id='coverage'>\n")
    depths = pre.genome_depth
    maxpos = max((len(d) for d in depths), default=0)
    ceiling = float(_y_ceiling(depths, 500)) / opt.coverage_step if depths else 0.0
    w("<div style='padding:5px;'><center><table style='border:0px;'><tr><td style='width:20px;background:red'></td><td style='border:0px;'>Before processing</td><td style='width:20px;background:blue'></td><td style='border:0px;'>After processing</td></tr></table></center></div>\n")
    for c, name in enumerate(pre.target_names):
        d = depths[c]
        if len(d) * 100 < maxpos:
            continue
        width = 5.0 + 95.0 * len(d) / maxpos
        xs = _list2string([float(i * opt.coverage_step) for i in range(len(d))])
        yb = _list2string([float(v) / opt.coverage_step for v in d])
        ya = _list2string([-(float(v) / opt.coverage_step)
                           for v in post.genome_depth[c]])
        w(f"<div class='coverage_div' id='coverage_{name}'>\n")
        w(f"<div class='coverage_figure' id='plot_coverage_{name}' style='width:{_to_string(width)}%;height:80px;'></div>\n")
        w("</div>\n")
        w("\n<script type=\"text/javascript\">\n")
        w("var data=[{x:[%s],y:[%s],name: 'before processing',fill: 'tozeroy',line:{color:'rgb(255,0, 0)', width:1}\n},"
          "{x:[%s],y:[%s],name: 'after processing',fill: 'tozeroy',line:{color:'rgb(0, 0, 255)', width:1}\n}];\n"
          % (xs, yb, xs, ya))
        w("var layout={margin: {l: 50,r: 50,b:30,t: 5,pad: 2}, showlegend: false, yaxis:{title:'%s', range:[%s, %s]}};\n"
          % (name, _to_string(-ceiling), _to_string(ceiling)))
        w(f"Plotly.newPlot('plot_coverage_{name}', data, layout);\n")
        w("</script>\n")
    w("</div>\n")
    w("</div>\n")

    # BED coverage (239-303)
    if opt.has_bed_file and pre.bed_stats is not None:
        w("<div class='section_div'>\n")
        w(f"<div class='section_title' onclick=showOrHide('coverage_bed')><a name='coverage_bed'>Coverage statistics in BED:<font size=-2>{opt.bed_file}</font> </a></div>\n")
        w("<div id='coverage_bed'>\n")
        pre_bed = pre.bed_stats.contig_regions
        post_bed = post.bed_stats.contig_regions
        maxpos = max((len(r) for r in pre_bed), default=0)
        c1 = _y_ceiling([[r.avg_depth() for r in regs] for regs in pre_bed], 500)
        c2 = _y_ceiling([[r.avg_depth() for r in regs] for regs in post_bed], 500)
        w("<div style='padding:5px;'><center><table style='border:0px;'><tr><td style='width:20px;background:red'></td><td style='border:0px;'>Before processing</td><td style='width:20px;background:blue'></td><td style='border:0px;'>After processing</td></tr></table></center></div>\n")
        for c, name in enumerate(pre.target_names):
            regs = pre_bed[c]
            if not regs:
                continue
            width = 5.0 + 95.0 * max(maxpos / 100.0, float(len(regs))) / maxpos
            px = ",".join(f'"{r.name} {r.start}-{r.end}"' for r in regs)
            # getAvgDepth returns int (bed.h:29-34): plain integer format
            pyb = ",".join(f'"{int(r.avg_depth())}"' for r in regs)
            pya = ",".join(f'"{-int(r.avg_depth())}"' for r in post_bed[c])
            w(f"<div class='bed_coverage_div' id='bed_coverage_{name}'>\n")
            w(f"<div class='coverage_figure' id='bed_plot_coverage_{name}' style='width:{_to_string(width)}%;height:250px;'></div>\n")
            w("</div>\n")
            w("\n<script type=\"text/javascript\">\n")
            w("var data=[{x:[%s],y:[%s],name: 'before processing',fill: 'tozeroy',line:{color:'rgb(255,0, 0)', width:1}\n},"
              "{x:[%s],y:[%s],name: 'after processing',fill: 'tozeroy',line:{color:'rgb(0, 0, 255)', width:1}\n}];\n"
              % (px, pyb, px, pya))
            w("var layout={margin: {l: 50,r: 50,b: 150,t:5,pad: 2}, xaxis:{tickangle:60, tickfont:{size: 8,color: '#bc6f98'}}, showlegend: false, yaxis:{title:'%s', range:[%s, %s]}};\n"
              % (name, str(-c2), str(c1)))
            w(f"Plotly.newPlot('bed_plot_coverage_{name}', data, layout);\n")
            w("</script>\n")
        w("</div>\n")
        w("</div>\n")

    # printFooter (479-485)
    w("\n</div>\n")
    w("<div id='footer'> ")
    w(f"<p>{command}</p>")
    w(f"gencore-tpu {__version__}, at {ts} </div>")
    w("</body></html>")
    with open(path, "w") as f:
        f.write("".join(h))
