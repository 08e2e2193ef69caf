"""PyTorch + CUDA port of the endoscopy depth-estimation framework.

The JAX package ``endoscopydepthestimation_pytorch_tpu`` beside it is the
reference this port is held against. Ported so far: depth serving with
FCDenseNet-57 and the self-supervised train step (SFL + DCL). Each dense
layer (BN + ReLU + conv3x3) runs through a hand-written CUDA kernel on
the GPU, and so does the depth warp's bilinear sampler, forward and
backward.

  models/      FCDenseNet 57/67/103 (train and eval), init, weight import
  ops/         the fused dense-layer op, the warp sampler, gridsample,
               geometry, and their kernels' build (csrc/*.cu)
  data/        SequenceData, frame loading, color normalization
  utils/       reference-format .pt checkpoint loading
  losses.py    SFL, DCL, the legacy and distillation losses, metrics
  schedule.py  cyclic learning rate
  training.py  train_step, eval_step, predict_step
  serving.py   DepthPredictor
"""

__version__ = "0.1.0"

from .models import FCDenseNet, FCDenseNet57, FCDenseNet67, FCDenseNet103  # noqa: F401
from .serving import DepthPredictor  # noqa: F401
from .training import predict_step  # noqa: F401
