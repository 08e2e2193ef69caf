from .checkpoint import load_any_checkpoint  # noqa: F401
