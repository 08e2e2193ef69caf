from .mesh import pad_batch_to  # noqa: F401
from .prefetch import device_prefetch, to_device  # noqa: F401
