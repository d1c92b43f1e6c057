from gencore_tpu_torch.report.jsonreport import write_json_report
from gencore_tpu_torch.report.htmlreport import write_html_report

__all__ = ["write_json_report", "write_html_report"]
