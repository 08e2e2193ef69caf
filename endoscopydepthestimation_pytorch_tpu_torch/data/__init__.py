from .augment import normalize_color  # noqa: F401
from .preprocess import SequenceData, load_color_image  # noqa: F401
