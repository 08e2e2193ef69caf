"""Operations and bytes of Depth Pro (``configs/depth_pro.json``), counted
from the configuration's shapes: the two ViT-L/16 encoders' matmuls and
attention, and every convolution and transposed convolution of the
project-upsample branches, the decoder and the head.

A frame of ``img_size`` pixels a side makes 25 + 9 + 1 tiles
(``tile_grids``) of ``tile_size`` pixels for the patch encoder, one
sequence of (tile_size / patch_size)^2 + 1 tokens each, and one more
sequence for the image encoder. A 2x2 stride-2 transposed convolution
does 2 cin cout operations an output pixel (each output pixel is one
input pixel times one of the four taps); a k x k convolution 2 k^2 cin
cout.
"""
from __future__ import annotations

from . import roofline, roofline_attention


def sequences(config: dict, frames: int):
    """(the patch encoder's sequences, the image encoder's) for ``frames``
    frames."""
    return sum(g * g for g in config["tile_grids"]) * frames, frames


def encoder_flops(config: dict, frames: int) -> float:
    """Both ViTs' forward: ``roofline_attention.encoder_flops`` at the
    tile size over every sequence."""
    tile = config["tile_size"]
    return roofline_attention.encoder_flops(config, sum(sequences(config, frames)), tile, tile)


def conv_flops(config: dict, frames: int) -> float:
    """The project-upsample branches', the decoder's and the head's
    convolutions of one forward."""
    d, f = config["embed_dim"], config["decoder_features"]
    c = config["dims_encoder"]
    g0, g1, g2 = config["merged_grids"]  # x0's and the latents' grid, x1's, x2's

    def conv(side, cin, cout, k=1):
        return 2.0 * side * side * cin * cout * k * k

    def branch(side, cout, ups, cint=None):
        cint = cout if cint is None else cint
        ops = conv(side, d, cint)
        for i in range(ups):
            side *= 2
            ops += conv(side, cint if i == 0 else cout, cout)
        return ops

    ops = (branch(g0, f, 3, c[0]) + branch(g0, c[0], 2) + branch(g0, c[1], 1)
           + branch(g1, c[2], 1) + branch(g2, c[3], 1))
    ops += conv(2 * g2, d, c[3]) + conv(2 * g2, 2 * c[3], c[3])   # upsample_lowres, fuse_lowres
    # the decoder's inputs: latent0 (8 g0, identity), latent1 (4 g0), x0
    # (2 g0), x1 (2 g1), fused (2 g2)
    sides = [8 * g0, 4 * g0, 2 * g0, 2 * g1, 2 * g2]
    dims = [f] + list(c)
    ops += sum(conv(s, cin, f, 3) for s, cin in zip(sides[1:], dims[1:]))
    for level, side in enumerate(sides):
        units = 1 if level == len(sides) - 1 else 2       # the deepest block has no skip
        ops += units * 2 * conv(side, f, f, 3)
        out = side if level == 0 else 2 * side             # the deconv doubles the side
        if level:
            ops += conv(out, f, f)
        ops += conv(out, f, f)                              # out_conv
    top = sides[0]
    ops += conv(top, f, f // 2, 3) + conv(2 * top, f // 2, f // 2)
    ops += conv(2 * top, f // 2, 32, 3) + conv(2 * top, 32, 1)
    return frames * ops


def forward_flops(config: dict, frames: int) -> float:
    return encoder_flops(config, frames) + conv_flops(config, frames)


def step_attention_bound_s(config: dict, frames: int, itemsize: int) -> float:
    """The least device time of one train step's attention: a forward and
    a backward call a block of each encoder, the patch encoder's over every
    tile at once."""
    tile, patch = config["tile_size"], config["patch_size"]
    tokens = (tile // patch) ** 2 + 1
    total = 0.0
    for n in sequences(config, frames):
        counts = roofline_attention.attention_counts(n, config["num_heads"], tokens,
                                                     config["head_dim"], itemsize)
        total += roofline.sum_bounds_s(counts.values(), "bfloat16")
    return config["depth"] * total
