"""img2sgf_tpu: a JAX/XLA rebuild of hanysz/img2sgf.

Converts images of printed Go diagrams into SGF files. The detection
pipeline (preprocess, blur pyramid, Canny, Hough circles/lines, grid
recovery, stone classification) runs as one jitted, batched program on
the accelerator;
the GUI and SGF writer are thin host-side shims over the same public
detection functions.
"""

from .config import DetectionConfig, choose_line_threshold
from .core import BLACK, WHITE, Alignment, BoardStates, guess_side_to_move, to_sgf

__version__ = "0.1.0"

__all__ = [
    "DetectionConfig",
    "choose_line_threshold",
    "BLACK",
    "WHITE",
    "Alignment",
    "BoardStates",
    "guess_side_to_move",
    "to_sgf",
]
