from .pipeline import (DetectionDataConfig, LMDataConfig,  # noqa: F401
                       detection_batch, lm_batch)
