from .pipeline import DetectionDataConfig, detection_batch  # noqa: F401
