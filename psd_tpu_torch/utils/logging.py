"""Metric logging: a JSONL file always; Weights & Biases where the `wandb`
package imports and the config names a `wandb.project`.

Counterpart of `psd_tpu/utils/logging.py`: each record is one JSON line
`{"ts": <unix seconds>, **metrics}`, flushed as it is written; a wandb run
that fails to start or to log is dropped without changing the call sites.
Across ranks only rank 0 logs; on the others the logger opens nothing and
`log` does nothing.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

from ..parallel.mesh import rank


class MetricLogger:
    def __init__(self, jsonl_path: str | Path, wandb_cfg: Optional[Dict] = None):
        self.path = Path(jsonl_path)
        self._fh = None
        self._wandb = None
        if rank() != 0:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")
        if wandb_cfg and wandb_cfg.get("project"):
            try:
                import wandb

                self._wandb = wandb.init(
                    project=wandb_cfg.get("project"),
                    group=wandb_cfg.get("group"),
                    name=wandb_cfg.get("run_name"),
                    id=wandb_cfg.get("run_id"),
                    resume="allow" if wandb_cfg.get("run_id") else None,
                    mode="offline" if wandb_cfg.get("offline", True) else "online",
                )
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict[str, Any]) -> None:
        if self._fh is None:
            return
        self._fh.write(json.dumps({"ts": time.time(), **metrics}) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            try:
                self._wandb.log(metrics)
            except Exception:
                pass

    def __enter__(self) -> "MetricLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
        if self._wandb is not None:
            try:
                self._wandb.finish()
            except Exception:
                pass
