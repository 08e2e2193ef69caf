"""PyTorch + CUDA port of the endoscopy depth-estimation framework.

The JAX package ``endoscopydepthestimation_pytorch_tpu`` beside it is the
reference this port is held against. Ported so far: depth serving with
FCDenseNet-57, the self-supervised train step (SFL + DCL), and training
from SfM sequences on disk: the data path and the trainer
(``python -m endoscopydepthestimation_pytorch_tpu_torch.train``). Each
dense layer (BN + ReLU + conv3x3) runs through a hand-written CUDA kernel
on the GPU, and so does the depth warp's bilinear sampler, forward and
backward; the loader's sparse-label rasterizer is C++ on the host.

  models/      FCDenseNet 57/67/103 (train and eval), init, weight import
  ops/         the fused dense-layer op, the warp sampler, gridsample,
               geometry, and their kernels' build (csrc/*.cu)
  data/        SfM readers, the precompute, the rasterizer (numpy and
               csrc/rasterizer.cpp), augmentation, SfMDataset, BatchLoader
  parallel/    device_prefetch: host batches to the card ahead of the step
  utils/       .pt checkpoints, PLY, training boards and metric logs,
               step timing and torch.profiler traces
  losses.py    SFL, DCL, the legacy and distillation losses, metrics
  schedule.py  cyclic learning rate
  training.py  train_step, eval_step, predict_step
  serving.py   DepthPredictor
  train.py     the trainer (the JAX package's train.py CLI)
"""

__version__ = "0.1.0"

from .models import FCDenseNet, FCDenseNet57, FCDenseNet67, FCDenseNet103  # noqa: F401
from .serving import DepthPredictor  # noqa: F401
from .training import predict_step  # noqa: F401
