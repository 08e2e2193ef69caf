from .prefetch import device_prefetch, to_device  # noqa: F401
