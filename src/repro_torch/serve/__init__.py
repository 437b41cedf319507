from .admission import (OUTCOMES, AdmissionConfig, AdmissionQueue,  # noqa: F401
                        DetRequest, resolve_bucket)
from .dcl_engine import (LADDER, DCLServeConfig, DCLServingEngine,  # noqa: F401
                         bucket_layer_dims, ladder)
from .engine import Request, ServeConfig, ServingEngine  # noqa: F401
