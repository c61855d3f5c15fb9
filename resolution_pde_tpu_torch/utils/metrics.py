"""Metrics logging: stdout and CSV always, wandb when it is installed and
asked for.

Counterpart of resolution_pde_tpu/utils/metrics.py (reference
train/training.py:80-83, main_1d.py:295-301): the same files under
``runs/<project>/<run name>/`` (config.json, one CSV per table,
metrics.csv).
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, project: str, run_name: Optional[str] = None,
                 out_dir: str = "runs", config: Optional[dict] = None,
                 use_wandb: bool = True):
        self.project = project
        self.run_name = run_name or time.strftime("%Y%m%d-%H%M%S")
        self.out_dir = os.path.join(out_dir, project, self.run_name)
        os.makedirs(self.out_dir, exist_ok=True)
        self._rows = []
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=project, name=self.run_name,
                           config=config or {})
                self._wandb = wandb
            except Exception as e:  # logging must not stop a run
                print(f"[{project}] wandb disabled: {e!r}", flush=True)
        if config is not None:
            with open(os.path.join(self.out_dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, metrics: Dict, step: Optional[int] = None):
        row = dict(metrics)
        if step is not None:
            row["step"] = step
        self._rows.append(row)
        msg = " ".join(f"{k}={_fmt(v)}" for k, v in row.items())
        print(f"[{self.project}] {msg}", flush=True)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_table(self, name: str, columns, rows):
        """A summary table (reference wandb.Table, main_1d.py:295-297) as a
        CSV file."""
        path = os.path.join(self.out_dir, f"{name}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(columns)
            w.writerows(rows)
        if self._wandb is not None:
            table = self._wandb.Table(columns=list(columns),
                                      data=[list(r) for r in rows])
            self._wandb.log({name: table})
        return path

    def finish(self):
        path = os.path.join(self.out_dir, "metrics.csv")
        if self._rows:
            keys = sorted({k for r in self._rows for k in r})
            with open(path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=keys)
                w.writeheader()
                w.writerows(self._rows)
        if self._wandb is not None:
            self._wandb.finish()
        return path


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return v
