from .dense_conv import fused_dense_conv, fused_dense_conv_reference  # noqa: F401
