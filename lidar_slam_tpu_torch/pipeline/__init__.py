from .front_end import (
    FrontEnd,
    FrontEndConfig,
    FrontEndDriveState,
    front_end_drive,
    init_front_end_drive,
)

__all__ = [
    "FrontEnd",
    "FrontEndConfig",
    "FrontEndDriveState",
    "front_end_drive",
    "init_front_end_drive",
]
