"""PyTorch + CUDA port of the endoscopy depth-estimation framework.

The JAX package ``endoscopydepthestimation_pytorch_tpu`` beside it is the
reference this port is held against. Ported so far: depth serving with
FCDenseNet-57, each dense layer (BN + ReLU + conv3x3) running through a
hand-written CUDA kernel on the GPU.

  models/    FCDenseNet 57/67/103 (eval forward), init, weight import
  ops/       the fused dense-layer op and its kernel build (csrc/*.cu)
  data/      SequenceData, frame loading, color normalization
  utils/     reference-format .pt checkpoint loading
  training.py  predict_step
  serving.py   DepthPredictor
"""

__version__ = "0.1.0"

from .models import FCDenseNet, FCDenseNet57, FCDenseNet67, FCDenseNet103  # noqa: F401
from .serving import DepthPredictor  # noqa: F401
from .training import predict_step  # noqa: F401
