"""The plain reference the benchmark holds the port against: FC-DenseNet,
the self-supervised objective, momentum SGD and the serving path's frame
prep, in plain PyTorch and NumPy at float32 (TF32 off on the card).

It imports neither JAX, nor the JAX package, nor anything of the port,
and takes nothing the port has made: the benchmark hands both sides the
same weights, batches and raw frames, and the reference derives the rest
(the boundary mask, the crop, the normalized colors) itself.

``quant``, where a function takes it, rounds every stored activation
through another type: the control runs the reference with activations
in float8 e4m3 (``fp8_round``), the precision below the configuration's
bfloat16.
"""
