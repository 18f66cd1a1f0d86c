from .feature_extraction import FeatureExtractionConfig, ScanFeatures, extract_features
from .mapping import AloamMapping, AloamMappingConfig, downsample_stacks, keep_near, map_update, mapping_step
from .odometry import AloamOdometry, AloamOdometryConfig, odometry_step
from .pipeline import AloamConfig, AloamPipeline, AloamState, aloam_drive, aloam_step, init_aloam_state

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
    "keep_near",
    "AloamConfig",
    "AloamPipeline",
    "AloamState",
    "aloam_drive",
    "aloam_step",
    "init_aloam_state",
]
