"""Cross-run comparison table of the evaluation sweep: one row per
(checkpoint, scale) run. The port's copy of `psd_tpu/metrics/comparison.py`.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence


def comparison_table(results: Sequence[Dict]) -> str:
    """results: list of EvalResult.to_json() dicts → aligned text table."""
    cols = ["checkpoint", "scale", "fid", "cmmd", "precision", "recall",
            "img/s", "n_gen"]
    rows: List[List[str]] = []
    for r in results:
        o = r.get("overall", {}) or {}

        def fmt(key):
            v = o.get(key)
            s = o.get(key + "_std")
            if v is None:
                return "-"
            return f"{v:.3f}±{s:.3f}" if s is not None else f"{v:.3f}"

        rows.append([
            Path(str(r.get("checkpoint", "-"))).stem[:24],
            f"{r.get('scale', 0):g}",
            fmt("fid"),
            fmt("cmmd"),
            fmt("precision"),
            fmt("recall"),
            f"{r.get('throughput_img_s', 0):.2f}",
            str(r.get("num_generated", 0)),
        ])
    widths = [max(len(c), *(len(row[i]) for row in rows)) if rows else len(c)
              for i, c in enumerate(cols)]
    sep = "-+-".join("-" * w for w in widths)
    lines = [" | ".join(c.ljust(w) for c, w in zip(cols, widths)), sep]
    for row in rows:
        lines.append(" | ".join(c.ljust(w) for c, w in zip(row, widths)))
    return "\n".join(lines)


def load_and_render(comparison_json: str | Path) -> str:
    with open(comparison_json) as f:
        return comparison_table(json.load(f))
