from .checkpoint import load_any_checkpoint, load_checkpoint, save_checkpoint  # noqa: F401
