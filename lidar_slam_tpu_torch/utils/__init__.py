from .median import StreamingMedian
from .watchdog import RunHealth, StageHealth

__all__ = [
    "StreamingMedian",
    "RunHealth",
    "StageHealth",
]
