"""References to the program's integer counters for a metric's reader.

The port adds to ``hypergen_tpu_torch.utils.timing.COUNTERS``
(``COUNTERS.<name>``, 0 for a name never counted). ``refs`` names them as a
reader's ``COUNTERS``, read before and after the window like the span
totals (``program_spans``). A program that keeps no counters gives no
references, so that its reader finds nothing to read and the metric is left
out of the result line.
"""

from __future__ import annotations

import importlib
from typing import Dict, Sequence

MODULE = "hypergen_tpu_torch.utils.timing"


def refs(names: Sequence[str]) -> Dict[str, str]:
    """{"<name>": "<module>:COUNTERS.<name>"}, or {} where the program has
    no counters."""
    try:
        timing = importlib.import_module(MODULE)
    except ImportError:
        return {}
    if not hasattr(timing, "COUNTERS"):
        return {}
    return {n: f"{MODULE}:COUNTERS.{n}" for n in names}
