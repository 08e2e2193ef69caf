import torch

from .depth_anything import DepthAnythingV2, DepthAnythingV2Large  # noqa: F401
from .depth_pro import DepthPro, DepthProLarge  # noqa: F401
from .fcdensenet import FCDenseNet, FCDenseNet57, FCDenseNet67, FCDenseNet103  # noqa: F401
from .init import init_weights  # noqa: F401
from .torch_import import (from_jax_variables, load_reference_checkpoint,  # noqa: F401
                           save_reference_checkpoint)
from .unet import UNet, UNetConvBlock  # noqa: F401
from .vggt import VGGT, VGGT1B  # noqa: F401


def _unet(n_classes: int = 1, dtype=torch.float32, **flags) -> UNet:
    """The default UNet (depth 6, wf 6), as the JAX trainer's ``_unet``
    (root train.py:44-50) builds it; it ignores the FCDenseNet flags
    (``act8``, ``remat``, ``block_engine``), as JAX's does."""
    del flags
    return UNet(out_channels=n_classes, dtype=dtype)


# ``--architecture`` of the trainer and the evaluate CLI, and
# ``DepthPredictor(architecture=)``: builder(n_classes=, dtype=, **flags)
ARCHITECTURES = {"fcdensenet57": FCDenseNet57, "fcdensenet67": FCDenseNet67,
                 "fcdensenet103": FCDenseNet103, "unet": _unet,
                 "depth_anything_v2_vitl": DepthAnythingV2Large, "depth_pro": DepthProLarge,
                 "vggt_1b": VGGT1B}


def fixed_input_size(architecture: str):
    """The one (height, width) the architecture takes, or None where it
    takes any crop its ``crop_multiple`` allows (the builder's
    ``input_size``)."""
    size = getattr(ARCHITECTURES[architecture], "input_size", None)
    return None if size is None else tuple(size)


def check_crop(architecture: str, network_downsampling: int, input_size) -> None:
    """Raise unless ``input_size`` is the architecture's fixed input size,
    where it has one, and unless the data path's crops (multiples of
    ``network_downsampling``) and ``input_size`` have sides that are
    multiples of the architecture's ``crop_multiple`` (1 where its builder
    names none)."""
    fixed = fixed_input_size(architecture)
    if fixed is not None and tuple(input_size) != fixed:
        raise ValueError(f"{architecture} takes {fixed[0]}x{fixed[1]} inputs only: "
                         f"--input_size {fixed[0]} {fixed[1]} (got {list(input_size)})")
    multiple = getattr(ARCHITECTURES[architecture], "crop_multiple", 1)
    if network_downsampling % multiple or any(s % multiple for s in input_size):
        raise ValueError(f"{architecture} needs crops whose sides are multiples of "
                         f"{multiple}: --network_downsampling {multiple} or a multiple "
                         f"(got {network_downsampling}) and --input_size multiples of "
                         f"{multiple} (got {list(input_size)})")
