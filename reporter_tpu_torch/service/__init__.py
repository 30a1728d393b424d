from .report import report, report_json

__all__ = ["report", "report_json"]
