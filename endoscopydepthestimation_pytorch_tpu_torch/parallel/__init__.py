from .distributed import (average_gradients, barrier, broadcast_state,  # noqa: F401
                          check_batch_divides, init_distributed, is_main, rank,
                          shutdown, world)
from .mesh import pad_batch_to  # noqa: F401
from .prefetch import device_prefetch, to_device  # noqa: F401
