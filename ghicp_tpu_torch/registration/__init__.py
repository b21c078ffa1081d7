"""Rigid estimators, the GH-ICP engine, the end-to-end pipeline and
station graphs."""
from ghicp_tpu_torch._lazy import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "estimator": ("estimate", "kabsch_6dof", "similarity_2d_4p",
                  "similarity_3d_7p", "yaw_4dof"),
    "ghicp": ("GHICPResult", "IterationMetrics", "ghicp_register",
              "ghicp_register_chunked"),
    "pipeline": ("RegistrationOutput", "register_pair", "transform_error"),
})
