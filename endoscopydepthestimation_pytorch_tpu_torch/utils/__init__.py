"""Checkpoints, PLY, boards and metric logs, step timing, traces and spans.

The checkpoint functions are re-exported lazily: the kernel wrappers
(``ops/``) import ``utils.profiling`` for their spans, and an eager import
of ``checkpoint`` here would import ``models`` and so ``ops`` again."""

_CHECKPOINT = ("load_any_checkpoint", "load_checkpoint", "save_checkpoint")


def __getattr__(name):
    if name in _CHECKPOINT:
        from . import checkpoint
        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
