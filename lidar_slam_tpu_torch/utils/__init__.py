from .median import StreamingMedian
from .timing import StageTimer, TicToc, profiler_trace, trace_annotation
from .watchdog import RunHealth, StageHealth

__all__ = [
    "TicToc",
    "StageTimer",
    "trace_annotation",
    "profiler_trace",
    "StreamingMedian",
    "RunHealth",
    "StageHealth",
]
