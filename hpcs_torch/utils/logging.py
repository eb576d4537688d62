"""Metric logging to `<log_dir>/<run_name>/`: every record appended to
`metrics.jsonl`, and to one CSV per set of keys (`metrics.csv`, then
`metrics_1.csv`, ...), the same files as the JAX package's MetricLogger
writes.  Weights & Biases only when asked for, and then it must import.
"""
import csv
import json
import os
import time


class MetricLogger:
    def __init__(self, log_dir, run_name="run", use_wandb=False, wandb_mode="offline",
                 config=None):
        self.log_dir = os.path.join(log_dir, run_name)
        self.wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError as e:
                raise RuntimeError("use_wandb needs the wandb package, which is not "
                                   "installed") from e
            wandb.init(project="HPCS", mode=wandb_mode, config=config or {})
            self.wandb = wandb
        os.makedirs(self.log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")
        self._csv = {}  # sorted keys -> (file, DictWriter)

    def log(self, metrics, step=None):
        """Append one record: the metrics as floats where they convert,
        `_time` (Unix seconds) and, when given, `step`."""
        rec = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        rec["_time"] = time.time()
        if step is not None:
            rec["step"] = int(step)
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        fields = tuple(sorted(rec))
        if fields not in self._csv:
            # one file per set of keys, so each CSV keeps one header
            name = "metrics.csv" if not self._csv else f"metrics_{len(self._csv)}.csv"
            f = open(os.path.join(self.log_dir, name), "a", newline="")
            w = csv.DictWriter(f, fieldnames=list(fields))
            w.writeheader()
            self._csv[fields] = (f, w)
        f, w = self._csv[fields]
        w.writerow(rec)
        f.flush()
        if self.wandb is not None:
            self.wandb.log(rec, step=step)

    def close(self):
        self.jsonl.close()
        for f, _ in self._csv.values():
            f.close()
        self._csv = {}
        if self.wandb is not None:
            self.wandb.finish()
