"""Logging, progress, and timing utilities (reference C22 equivalents)."""

from hypergen_tpu_torch.utils.logging import setup_logging  # noqa: F401
from hypergen_tpu_torch.utils.progress import ProgressBar  # noqa: F401
from hypergen_tpu_torch.utils.timing import StageTimer  # noqa: F401
