from .fcdensenet import FCDenseNet, FCDenseNet57, FCDenseNet67, FCDenseNet103  # noqa: F401
from .init import init_weights  # noqa: F401
from .torch_import import (from_jax_variables, load_reference_checkpoint,  # noqa: F401
                           save_reference_checkpoint)
from .unet import UNet, UNetConvBlock  # noqa: F401
