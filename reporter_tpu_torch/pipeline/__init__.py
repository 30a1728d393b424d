from .simple_reporter import gather_traces, match_traces, report_tiles

__all__ = ["gather_traces", "match_traces", "report_tiles"]
