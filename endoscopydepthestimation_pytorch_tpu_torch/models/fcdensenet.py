"""FC-DenseNet depth networks in PyTorch.

Port of the JAX package's ``models/fcdensenet.py`` (``DenseLayer`` :230,
``DenseBlock`` :292, ``TransitionDown`` :481, ``TransitionUp`` :546,
``FCDenseNet`` :587), itself a port of the reference's models.py:19-208:
pre-activation BN -> ReLU -> 3x3 conv dense layers, 1x1 conv + 2x2
maxpool transitions down, nearest x2 upsample + 3x3 conv transitions up,
and an ``|1x1 conv|`` head giving nonnegative depth.

The module takes NCHW like the reference's torch model and keeps its
activations in ``torch.channels_last`` memory. The convolutions outside
the dense blocks, the maxpool, the upsample, the crop and the head are
plain PyTorch. Parameters and BN statistics stay float32; activations run
in ``dtype``.

A dense block runs one route in each mode, with the same parameters:

- train mode: the whole block as one call through the engine
  ``ops.block_engine`` (JAX ``FCDenseNet(block_engine=True)``, :622-666):
  one buffer per block, no concatenation, the BN statistics from the
  forward kernel, and a hand-written backward. The down blocks hand
  their output's statistics to ``TransitionDown`` (JAX :690-698).
- eval mode: layer by layer, concatenating, as JAX's eval mode (:337).
  Each dense layer folds its BatchNorm into a per-channel (scale, shift)
  and runs BN + ReLU + conv3x3 as one forward-only
  ``ops.dense_conv.fused_dense_conv`` call (K1). This is the serving
  path, the one ``torch.export`` traces.

Both kernels take a growth of at most 16; the model refuses a larger one
when it is built.

BatchNorm follows the JAX package's ``BNFold`` (fcdensenet.py:195-211),
not torch's defaults, and folds with the engine's ``block_engine.fold``.
In eval mode it folds the running statistics. In train mode it folds the
batch statistics mu = mean(x) and var = mean(x^2) - mu^2 (the biased
variance), which the engine takes in f32 with the gradient flowing
through mu and mean(x^2), and moves the running statistics to
0.9*r + 0.1*stat with that biased variance. In a process group
(``parallel.distributed``) those statistics are the global batch's, as
JAX's ``axis_name`` pmean makes them (:200-202).

``act8=True`` and ``remat=True`` (JAX :600-602, :635-643, :672-675)
change only what a train-mode step keeps between its forward and its
backward; the forward is the same ops. With ``remat`` each dense block's
backward replays the engine's forward from the block's exact input
(``ops.act8.ReplayBlock``). With ``act8`` (which takes precedence) each
block saves an e4m3 copy instead (``ops.act8``), and the transitions and
the final conv run through ``ops.act8.compressed_call``.
``block_engine=True`` with ``act8`` keeps the dense blocks exact, as
JAX's engine takes precedence over act8 (:367-372); alone it changes
nothing.

Attribute names follow the reference's state_dict (``firstconv``,
``denseBlocksDown.i.layers.j.{norm,conv}``, ``transDownBlocks.i.{norm,conv}``,
``bottleneck.bottleneck.layers.j``, ``transUpBlocks.i.convTrans.1``,
``denseBlocksUp.i``, ``finalConv``), so a reference ``.pt`` and the JAX
package's converted weights load with ``strict=True``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import act8
from ..ops import block_engine as engine
from ..ops.dense_conv import MAX_FEATURES, fused_dense_conv

MOMENTUM = 0.9  # running statistics keep 0.9 of their value (torch's 0.1)


def _conv(x: torch.Tensor, conv: nn.Conv2d, padding: int) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    padding=padding)


def update_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor,
                         mean2: torch.Tensor) -> torch.Tensor:
    """Move ``bn``'s running statistics to 0.9*r + 0.1*stat with the biased
    variance mean2 - mean^2 (JAX ``BNFold``, fcdensenet.py:195-207);
    returns that variance."""
    var = mean2 - mean.square()
    with torch.no_grad():
        bn.running_mean.copy_(MOMENTUM * bn.running_mean + (1.0 - MOMENTUM) * mean)
        bn.running_var.copy_(MOMENTUM * bn.running_var + (1.0 - MOMENTUM) * var)
    return var


def batch_fold(bn: nn.BatchNorm2d, stats=None) -> tuple:
    """``bn`` folded into float32 (scale, shift) with relu(bn(x)) ==
    relu(x*scale + shift) (JAX ``BNFold``, fcdensenet.py:195-211): in eval
    mode from the running statistics; in train mode from ``stats``, the
    producer's batch (mean, mean of squares), advancing the running ones.
    The engine's statistics are the global batch's in a process group, so
    the running ones advance identically on every rank."""
    if not bn.training:
        mean, var = bn.running_mean.float(), bn.running_var.float()
    elif stats is None:
        raise ValueError("a train-mode BatchNorm folds its producer's batch "
                         "statistics, and none were given")
    else:
        mean, var = stats[0], update_running_stats(bn, *stats)
    scale, shift, _ = engine.fold(bn.weight, bn.bias, mean, var)
    return scale, shift


def center_crop(x: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Center-crop the spatial dims of an NCHW tensor (reference
    models.py:93-97)."""
    h, w = x.shape[2], x.shape[3]
    y0, x0 = (h - target_h) // 2, (w - target_w) // 2
    return x[:, :, y0:y0 + target_h, x0:x0 + target_w]


class DenseLayer(nn.Module):
    """BN -> ReLU -> 3x3 conv(growth_rate), one fused kernel call. Called in
    eval mode only: a train-mode block runs its layers through the engine
    (``DenseBlock``)."""

    def __init__(self, in_channels: int, growth_rate: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(in_channels)
        self.conv = nn.Conv2d(in_channels, growth_rate, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, shift = batch_fold(self.norm)
        w = self.conv.weight.permute(2, 3, 1, 0).to(x.dtype).contiguous()
        y = fused_dense_conv(x.permute(0, 2, 3, 1), scale, shift, w,
                             self.conv.bias.float())  # the kernel adds an f32 bias
        return y.permute(0, 3, 1, 2)


class DenseBlock(nn.Module):
    """Iterative concat of dense layers. With ``upsample=True`` only the
    new features are returned (reference models.py:31-53).

    In train mode the whole block runs as one call through the engine (JAX
    ``DenseBlock._block_vjp_path`` :332-379 and ``__call__`` :381-394); in
    eval mode layer by layer, concatenating.

    ``store`` ("act8", "remat" or None) is what a train-mode block keeps
    for its backward (see ``FCDenseNet``)."""

    def __init__(self, in_channels: int, growth_rate: int, n_layers: int,
                 upsample: bool = False, store: Optional[str] = None):
        super().__init__()
        self.upsample = upsample
        self.growth_rate = growth_rate
        self.store = store
        self.layers = nn.ModuleList(
            DenseLayer(in_channels + j * growth_rate, growth_rate)
            for j in range(n_layers))

    def _whole(self, x: torch.Tensor) -> tuple:
        """The block through the engine: ``block_engine_apply``, or with a
        ``store`` ``act8.replay_block_apply``. Returns (output NCHW in
        channels_last memory, its (mean, mean of squares)); advances every
        layer's running statistics once, here, from the block's prefix
        statistics (``block_engine.running_stats``: one launch a block on
        the card, ``update_running_stats``' expressions on the CPU)."""
        c0, g = x.shape[1], self.growth_rate
        layers = list(self.layers)
        params = ([l.norm.weight for l in layers], [l.norm.bias for l in layers],
                  [l.conv.weight.permute(2, 3, 1, 0) for l in layers],
                  [l.conv.bias for l in layers])
        xh = x.permute(0, 2, 3, 1)
        buf, mu, m2 = (engine.block_engine_apply(xh, *params) if self.store is None
                       else act8.replay_block_apply(xh, *params, store=self.store))
        out = buf.permute(0, 3, 1, 2)
        engine.running_stats([(l.norm.running_mean, l.norm.running_var) for l in layers],
                             mu, m2, c0, g, MOMENTUM)
        return (out[:, c0:] if self.upsample else out), (mu, m2)

    def forward(self, x: torch.Tensor, with_stats: bool = False):
        """The block's output; with ``with_stats`` also its per-channel
        (mean, mean of squares) in train mode, None in eval mode."""
        if self.training:
            out, stats = self._whole(x)
            return (out, stats) if with_stats else out
        # each layer's NHWC view must be contiguous: a no-op in eager, where
        # cuDNN, the pools and torch.cat keep channels_last, but a
        # torch.export trace on CUDA records convolutions' outputs as NCHW
        x = x.contiguous(memory_format=torch.channels_last)
        new_features = []
        for layer in self.layers:
            out = layer(x)
            x = torch.cat([x, out], 1)
            new_features.append(out)
        out = torch.cat(new_features, 1) if self.upsample else x
        return (out, None) if with_stats else out


class TransitionDown(nn.Module):
    """BN -> ReLU -> 1x1 conv (same channels) -> 2x2 maxpool
    (reference models.py:56-67). ``act8``: in train mode through
    ``ops.act8.compressed_call`` (JAX :496-504)."""

    def __init__(self, in_channels: int, act8: bool = False):
        super().__init__()
        self.act8 = act8
        self.norm = nn.BatchNorm2d(in_channels)
        self.conv = nn.Conv2d(in_channels, in_channels, 1)

    def forward(self, x: torch.Tensor, stats=None) -> torch.Tensor:
        """``stats``: the producing block's (mean, mean of squares) of x,
        which train mode normalizes with."""
        scale, shift = batch_fold(self.norm, stats)
        args = (x, scale, shift, self.conv.weight, self.conv.bias)
        if self.act8 and self.training:
            return act8.compressed_call(act8.td_apply, *args)
        return act8.td_apply(*args)


class TransitionUp(nn.Module):
    """Nearest x2 upsample -> 3x3 conv, center-crop to the skip's size,
    concat [up, skip] (reference models.py:70-80). ``act8``: in train
    mode the upsample and conv run through ``ops.act8.compressed_call``
    (JAX :567-573)."""

    def __init__(self, channels: int, act8: bool = False):
        super().__init__()
        self.act8 = act8
        # [0] has no parameters and is not called: it keeps the conv at the
        # reference's key convTrans.1
        self.convTrans = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="nearest"),
            nn.Conv2d(channels, channels, 3, padding=1))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        conv = self.convTrans[1]
        if self.act8 and self.training:
            up = act8.compressed_call(act8.tu_apply, x, conv.weight, conv.bias)
        else:
            up = act8.tu_apply(x, conv.weight, conv.bias)
        up = center_crop(up, skip.shape[2], skip.shape[3])
        return torch.cat([up, skip], 1)


class Bottleneck(nn.Module):
    """The bottleneck dense block, nested as in the reference so its keys
    read ``bottleneck.bottleneck.layers.j``."""

    def __init__(self, in_channels: int, growth_rate: int, n_layers: int,
                 store: Optional[str] = None):
        super().__init__()
        self.bottleneck = DenseBlock(in_channels, growth_rate, n_layers,
                                     upsample=True, store=store)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bottleneck(x)


class FCDenseNet(nn.Module):
    """Fully-convolutional DenseNet encoder-decoder (reference
    models.py:100-187). (B, 3, H, W) -> (B, n_classes, H, W) float32
    depth, nonnegative. ``act8``, ``remat`` and ``block_engine``: see the
    module docstring."""

    def __init__(self, down_blocks: Sequence[int] = (5, 5, 5, 5, 5),
                 up_blocks: Sequence[int] = (5, 5, 5, 5, 5),
                 bottleneck_layers: int = 5, growth_rate: int = 16,
                 out_chans_first_conv: int = 48, n_classes: int = 1,
                 dtype: torch.dtype = torch.float32, act8: bool = False,
                 remat: bool = False, block_engine: bool = False):
        super().__init__()
        max_growth = min(engine.MAX_GROWTH, MAX_FEATURES)
        if growth_rate > max_growth:
            raise ValueError(f"growth_rate {growth_rate} exceeds the dense "
                             f"kernels' maximum {max_growth}")
        self.dtype = dtype
        self.act8 = act8
        # what the dense blocks keep for their backward: under act8,
        # block_engine keeps them exact
        store = (None if act8 and block_engine else "act8" if act8
                 else "remat" if remat else None)
        cur = out_chans_first_conv
        self.firstconv = nn.Conv2d(3, cur, 3, padding=1)

        skip_channels = []
        self.denseBlocksDown = nn.ModuleList()
        self.transDownBlocks = nn.ModuleList()
        for n in down_blocks:
            self.denseBlocksDown.append(DenseBlock(cur, growth_rate, n, store=store))
            cur += growth_rate * n
            skip_channels.insert(0, cur)
            self.transDownBlocks.append(TransitionDown(cur, act8))

        self.bottleneck = Bottleneck(cur, growth_rate, bottleneck_layers, store)
        prev = growth_rate * bottleneck_layers

        self.transUpBlocks = nn.ModuleList()
        self.denseBlocksUp = nn.ModuleList()
        for i, n in enumerate(up_blocks):
            last = i == len(up_blocks) - 1
            self.transUpBlocks.append(TransitionUp(prev, act8))
            cur = prev + skip_channels[i]
            self.denseBlocksUp.append(
                DenseBlock(cur, growth_rate, n, upsample=not last, store=store))
            prev = growth_rate * n
            cur += prev

        self.finalConv = nn.Conv2d(cur, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        out = _conv(out, self.firstconv, 1)
        skips = []
        for block, down in zip(self.denseBlocksDown, self.transDownBlocks):
            out, stats = block(out, with_stats=True)
            skips.append(out)
            out = down(out, stats)
        out = self.bottleneck(out)
        for up, block in zip(self.transUpBlocks, self.denseBlocksUp):
            out = block(up(out, skips.pop()))
        head = (out, self.finalConv.weight, self.finalConv.bias)
        if self.act8 and self.training:  # JAX :737-745
            out = act8.compressed_call(act8.conv1x1_apply, *head)
        else:
            out = act8.conv1x1_apply(*head)
        return out.abs().float()


def FCDenseNet57(n_classes: int = 1, dtype=torch.float32, act8: bool = False,
                 remat: bool = False, **flags) -> FCDenseNet:
    """The configuration used by the reference drivers (models.py:190-194)."""
    return FCDenseNet(down_blocks=(4, 4, 4, 4, 4), up_blocks=(4, 4, 4, 4, 4),
                      bottleneck_layers=4, growth_rate=12,
                      out_chans_first_conv=48, n_classes=n_classes, dtype=dtype,
                      act8=act8, remat=remat, **flags)


def FCDenseNet67(n_classes: int = 1, dtype=torch.float32, act8: bool = False,
                 remat: bool = False, **flags) -> FCDenseNet:
    """Reference models.py:197-201."""
    return FCDenseNet(down_blocks=(5, 5, 5, 5, 5), up_blocks=(5, 5, 5, 5, 5),
                      bottleneck_layers=5, growth_rate=16,
                      out_chans_first_conv=48, n_classes=n_classes, dtype=dtype,
                      act8=act8, remat=remat, **flags)


def FCDenseNet103(n_classes: int = 1, dtype=torch.float32, act8: bool = False,
                  remat: bool = False, **flags) -> FCDenseNet:
    """Reference models.py:204-208."""
    return FCDenseNet(down_blocks=(4, 5, 7, 10, 12),
                      up_blocks=(12, 10, 7, 5, 4), bottleneck_layers=15,
                      growth_rate=16, out_chans_first_conv=48,
                      n_classes=n_classes, dtype=dtype, act8=act8, remat=remat,
                      **flags)
