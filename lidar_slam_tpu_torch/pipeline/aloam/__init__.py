from .feature_extraction import FeatureExtractionConfig, ScanFeatures, extract_features
from .mapping import AloamMapping, AloamMappingConfig, downsample_stacks, map_update, mapping_step
from .odometry import AloamOdometry, AloamOdometryConfig, odometry_step
from .pipeline import AloamPipeline, AloamState, aloam_drive, aloam_step, init_aloam_state

__all__ = [
    "FeatureExtractionConfig",
    "extract_features",
    "ScanFeatures",
    "AloamOdometry",
    "AloamOdometryConfig",
    "odometry_step",
    "AloamMapping",
    "AloamMappingConfig",
    "downsample_stacks",
    "mapping_step",
    "map_update",
    "AloamPipeline",
    "AloamState",
    "aloam_drive",
    "aloam_step",
    "init_aloam_state",
]
