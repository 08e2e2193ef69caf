"""The table of peaks and the operations and bytes of the port's kernels,
counted from the layers' shapes.

The counts are frozen copies of ``chip_smoke.py`` (``dense_layer_shapes``
:200, ``bound`` :227, ``_engine_bytes`` :795, the K1 count :447-449 and
the sampler's :774-777, at commit 6f9cbf0), generalized to any growth and
block layout. A kernel's bytes count each input read once and each output
written once; its operations are the multiply-adds of its convolution
(2 per MAC) or, for the sampler, its arithmetic per query.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

# One H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # tensor cores / FFMA
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def bound_s(n_bytes: float, n_ops: float, dtype: str) -> float:
    """The least time the card could take: the larger of the bytes over
    HBM's rate and the operations over the type's peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_FLOPS[dtype])


def architecture(config: dict) -> dict:
    """The FC-DenseNet sizes of a configuration file."""
    return {k: config[k] for k in ("down_blocks", "up_blocks", "bottleneck_layers",
                                   "growth_rate", "out_chans_first_conv", "n_classes")}


def dense_layer_shapes(config: dict, height: int, width: int) -> List[Tuple[int, int, int]]:
    """(H, W, C_in) of every dense layer, in forward order."""
    a = architecture(config)
    growth = a["growth_rate"]
    shapes, skips, c, h, w = [], [], a["out_chans_first_conv"], height, width
    for n in a["down_blocks"]:
        shapes += [(h, w, c + j * growth) for j in range(n)]
        c += n * growth
        skips.append((h, w, c))
        h, w = h // 2, w // 2
    shapes += [(h, w, c + j * growth) for j in range(a["bottleneck_layers"])]
    prev = a["bottleneck_layers"] * growth
    for n in a["up_blocks"]:
        h, w, skip_c = skips.pop()
        shapes += [(h, w, prev + skip_c + j * growth) for j in range(n)]
        prev = n * growth
    return shapes


def forward_conv_flops(config: dict, batch: int, height: int, width: int) -> float:
    """Operations (2 per multiply-add) of every convolution of one forward:
    the first 3x3 conv, the dense layers, the transitions down (1x1 at the
    block's resolution), the transitions up (3x3 at the upsampled
    resolution) and the 1x1 head. Everything else is elementwise."""
    a = architecture(config)
    g = a["growth_rate"]
    c, h, w = a["out_chans_first_conv"], height, width
    flops = 2 * 9 * 3 * c * batch * h * w
    skips = []
    for n in a["down_blocks"]:
        flops += sum(2 * 9 * (c + j * g) * g * batch * h * w for j in range(n))
        c += n * g
        flops += 2 * c * c * batch * h * w
        skips.append((h, w, c))
        h, w = h // 2, w // 2
    flops += sum(2 * 9 * (c + j * g) * g * batch * h * w
                 for j in range(a["bottleneck_layers"]))
    prev = a["bottleneck_layers"] * g
    for n in a["up_blocks"]:
        flops += 2 * 9 * prev * prev * batch * (2 * h) * (2 * w)
        h, w, skip_c = skips.pop()
        c = prev + skip_c
        flops += sum(2 * 9 * (c + j * g) * g * batch * h * w for j in range(n))
        prev = n * g
        c += prev
    flops += 2 * c * a["n_classes"] * batch * h * w
    return float(flops)


def k1_counts(pixels: int, c: int, f: int, itemsize: int) -> Tuple[float, float]:
    """(bytes, operations) of one K1 launch (BN fold + ReLU + 3x3 conv, its
    finish pass included): x and the weights in, y out at ``itemsize``;
    scale, shift and bias f32."""
    n_bytes = itemsize * (pixels * (c + f) + 9 * c * f) + 4 * (2 * c + f)
    return float(n_bytes), float(2 * 9 * c * f * pixels)


def engine_bytes(kernel: str, pixels: int, c: int, f: int, itemsize: int) -> int:
    """Bytes one engine kernel must move for one layer: each input read
    once, each output written once (prefix c channels, growth f)."""
    s, weights = itemsize, 9 * c * f
    if kernel == "fwd":  # K4: prefix in; y and its two sums out
        return s * (pixels * (c + f) + weights) + 4 * (2 * c + f + 2 * f)
    if kernel == "dinput":  # K5: g and y of the layer, prefix and its
        # gradient in; the gradient prefix and three sums out
        return s * (pixels * (2 * f + 3 * c) + weights) + 4 * (4 * c + 3 * f)
    if kernel == "dweight":  # K6: prefix and gy_eff in; dW (f32) out
        return s * pixels * (c + 2 * f) + 4 * (2 * c + 2 * f + weights)
    raise ValueError(f"unknown engine kernel {kernel!r}")


ENGINE_KERNELS = ("fwd", "dinput", "dweight")


def engine_layer_counts(pixels: int, c: int, f: int, itemsize: int) -> dict:
    """{kernel: (bytes, operations)} of K4, K5 and K6 for one layer: each
    is one 3x3 convolution's multiply-adds (forward, data gradient,
    weight gradient)."""
    ops = float(2 * 9 * c * f * pixels)
    return {k: (float(engine_bytes(k, pixels, c, f, itemsize)), ops)
            for k in ENGINE_KERNELS}


def warp_counts(queries: int) -> dict:
    """{kernel: (bytes, operations)} of K2 and K3 for one call of the train
    step's depth warp (a 2-channel f32 image, grad-first backward)."""
    q = queries
    return {"fwd": (4.0 * q * (2 + 2 + 2), float(q * (8 * 2 + 10))),
            # image and g channel 0, px, py in; dimg (both channels),
            # dpx, dpy out
            "bwd": (4.0 * q * (1 + 2 + 1 + 2 + 2), float(q * 30))}


def sum_bounds_s(counts: Sequence[Tuple[float, float]], dtype: str) -> float:
    return sum(bound_s(b, o, dtype) for b, o in counts)
