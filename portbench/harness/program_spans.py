"""References to the program's span totals for a metric's reader.

The port adds each span's wall and calling-thread CPU nanoseconds and its
count to ``hypergen_tpu_torch.utils.timing.SPANS`` (``SPANS.<span>.ns``,
``.cpu_ns``, ``.n``). ``refs`` names them as a reader's ``COUNTERS``, read
before and after the window like the launch counters. A program that keeps
no span totals gives no references, so that its reader finds nothing to
read and the metric is left out of the result line.
"""

from __future__ import annotations

import importlib
from typing import Dict, Sequence

MODULE = "hypergen_tpu_torch.utils.timing"


def refs(spans: Sequence[str], fields: Sequence[str] = ("ns", "n")
         ) -> Dict[str, str]:
    """{"<span>.<field>": "<module>:SPANS.<span>.<field>"}, or {} where the
    program has no span totals."""
    try:
        timing = importlib.import_module(MODULE)
    except ImportError:
        return {}
    if not hasattr(timing, "SPANS"):
        return {}
    return {f"{s}.{f}": f"{MODULE}:SPANS.{s}.{f}"
            for s in spans for f in fields}
