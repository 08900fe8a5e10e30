"""Logging and progress utilities (reference C22 equivalents)."""

from hypergen_tpu_torch.utils.logging import setup_logging  # noqa: F401
from hypergen_tpu_torch.utils.progress import ProgressBar  # noqa: F401
