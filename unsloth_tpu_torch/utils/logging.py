"""Training metrics logging.

Counterpart of unsloth_tpu/utils/logging.py for ``report_to="none"``: every
entry is appended to ``<output_dir>/metrics.jsonl`` and handed to each
callback. The wandb and tensorboard fan-outs are not ported yet; asking
for them raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Sequence


class MetricsLogger:
    def __init__(self, output_dir: str = "outputs",
                 report_to: Any = "none",
                 callbacks: Sequence[Callable[[Dict[str, Any]], None]] = ()):
        targets = report_to if isinstance(report_to, (list, tuple)) \
            else [report_to]
        targets = [t for t in targets if t and t != "none"]
        if targets:
            raise NotImplementedError(
                f"MetricsLogger: report_to={targets!r} is not ported yet; "
                "use report_to='none' (metrics.jsonl and callbacks)")
        self.output_dir = output_dir
        self.callbacks = list(callbacks)
        os.makedirs(output_dir, exist_ok=True)
        self._jsonl_path = os.path.join(output_dir, "metrics.jsonl")

    def log(self, entry: Dict[str, Any]):
        entry = dict(entry, _ts=time.time())
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(entry) + "\n")
        for cb in self.callbacks:
            cb(entry)
