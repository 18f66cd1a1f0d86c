from .back_end import BackEnd, BackEndConfig, KeyFrame
from .front_end import (
    FrontEnd,
    FrontEndConfig,
    FrontEndDriveState,
    front_end_drive,
    init_front_end_drive,
)
from .loop_closing import LoopClosing, LoopClosingConfig, LoopPose
from .matching import Matching, MatchingConfig, matching_drive

__all__ = [
    "BackEnd",
    "BackEndConfig",
    "KeyFrame",
    "FrontEnd",
    "FrontEndConfig",
    "FrontEndDriveState",
    "front_end_drive",
    "init_front_end_drive",
    "LoopClosing",
    "LoopClosingConfig",
    "LoopPose",
    "Matching",
    "MatchingConfig",
    "matching_drive",
]
