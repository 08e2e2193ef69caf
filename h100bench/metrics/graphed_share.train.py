"""graphed_share.train: the share of the process's train steps that ran
as a replay of the step's CUDA graph, in %: 100 * replays / (steps run
eagerly + replays), over set-up, the window and the traced steps, from
the port's counter ``step_graph.GRAPHED`` (a capture's step counts as a
replay). None from a port without the counter, or before any step."""
import importlib


def read(ctx):
    try:
        module = importlib.import_module(
            "endoscopydepthestimation_pytorch_tpu_torch.step_graph")
    except ImportError:
        return None
    counts = getattr(module, "GRAPHED", None)
    if counts is None:
        return None
    steps = counts["eager"] + counts["replays"]
    return 100.0 * counts["replays"] / steps if steps else None
