from .report import report, report_json, report_wire

__all__ = ["report", "report_json", "report_wire"]
