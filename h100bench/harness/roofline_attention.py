"""Operations and bytes of a vision transformer's attention and of Depth
Anything V2's whole forward, counted from the configuration's shapes.

Attention of one call over B images, H heads, N tokens of head size d:

- forward: S = Q K^T and O = P V, 2 N^2 d operations each (2 per
  multiply-add): 4 B H N^2 d; Q, K, V read once and O written once, and
  the softmax's log-sum-exp written (float32, one a row);
- backward (the fused kernels' flash form): S again, dV = P^T dO,
  dP = dO V^T, dQ = dS K, dK = dS^T Q: 10 B H N^2 d; Q, K, V, O, dO and the
  log-sum-exp read once, dQ, dK, dV written once.

A bound is the larger of the operations over the bfloat16 tensor peak and
the bytes over HBM's rate (``roofline.bound_s``).
"""
from __future__ import annotations

from typing import Dict, Tuple

from . import roofline


def attention_counts(images: int, heads: int, tokens: int, head_dim: int,
                     itemsize: int) -> Dict[str, Tuple[float, float]]:
    """{"fwd": (bytes, operations), "bwd": (bytes, operations)} of one
    attention call and of its backward."""
    rows = images * heads * tokens          # rows of Q (and of K, V, O)
    flops = float(images * heads) * tokens * tokens * head_dim
    qkvo = float(rows * head_dim * itemsize)
    return {"fwd": (4 * qkvo + 4.0 * rows, 4 * flops),
            "bwd": (8 * qkvo + 4.0 * rows, 10 * flops)}


def tokens(config: dict, height: int, width: int) -> int:
    """Patches of a height x width input and the class token."""
    p = config["patch_size"]
    return (height // p) * (width // p) + 1


def step_attention_bound_s(config: dict, images: int, height: int, width: int,
                           itemsize: int) -> float:
    """The least device time of one train step's attention: a forward and
    a backward call a block."""
    counts = attention_counts(images, config["num_heads"], tokens(config, height, width),
                              config["head_dim"], itemsize)
    return config["depth"] * roofline.sum_bounds_s(counts.values(), "bfloat16")


def encoder_flops(config: dict, images: int, height: int, width: int) -> float:
    """Operations of one encoder forward: the patch embedding, each block's
    qkv, proj, fc1 and fc2 matmuls (24 N d^2 with the MLP 4 d wide) and its
    attention (4 N^2 d); elementwise work and the norms left out."""
    p, d = config["patch_size"], config["embed_dim"]
    n = tokens(config, height, width)
    hidden = int(d * config["mlp_ratio"])
    patches = (height // p) * (width // p)
    embed = 2.0 * patches * 3 * p * p * d
    matmuls = 2.0 * n * d * (3 * d + d + 2 * hidden)
    attention = 4.0 * n * n * d
    return images * (embed + config["depth"] * (matmuls + attention))


def head_flops(config: dict, images: int, height: int, width: int) -> float:
    """Operations of one DPT head forward: every convolution and transposed
    convolution at the size it runs at (2 per multiply-add)."""
    p, d, f = config["patch_size"], config["embed_dim"], config["features"]
    c = config["out_channels"]
    r, q = height // p, width // p
    sizes = [(4 * r, 4 * q), (2 * r, 2 * q), (r, q), ((r + 1) // 2, (q + 1) // 2)]

    def conv(pixels, cin, cout, k):
        return 2.0 * pixels * cin * cout * k * k

    ops = sum(conv(r * q, d, ci, 1) for ci in c)                 # projects
    ops += 2.0 * r * q * c[0] * c[0] * 16 + 2.0 * r * q * c[1] * c[1] * 4  # transposed
    ops += conv(sizes[3][0] * sizes[3][1], c[3], c[3], 3)         # 3x3 stride 2
    ops += sum(conv(h * w, ci, f, 3) for (h, w), ci in zip(sizes, c))  # layer_rn
    units = {3: 1, 2: 2, 1: 2, 0: 2}  # residual units a level (the deepest: 1)
    outs = [(2 * sizes[0][0], 2 * sizes[0][1]), sizes[0], sizes[1], sizes[2]]
    for level, n_units in units.items():
        h, w = sizes[level]
        ops += n_units * 2 * conv(h * w, f, f, 3)                 # two convs a unit
        oh, ow = outs[level]
        ops += conv(oh * ow, f, f, 1)                             # out_conv
    oh, ow = outs[0]
    ops += conv(oh * ow, f, f // 2, 3)                            # output_conv1
    ops += conv(r * p * q * p, f // 2, 32, 3) + conv(r * p * q * p, 32, 1, 1)
    return images * ops
