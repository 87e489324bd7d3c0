"""Metrics logging: every scalar to an append-only JSONL stream
(`<name>_metrics.jsonl`) and, when tensorboardX imports, to TensorBoard."""
import json
import os
import time

try:
    from tensorboardX import SummaryWriter
except ImportError:  # pragma: no cover
    SummaryWriter = None


class MetricsWriter:
    def __init__(self, log_dir: str, name: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, name + "_metrics.jsonl"), "a")
        self._tb = (SummaryWriter(os.path.join(log_dir, name))
                    if SummaryWriter is not None else None)

    def scalar(self, tag: str, value: float, step: int) -> None:
        record = {"tag": tag, "value": float(value), "step": int(step),
                  "time": time.time()}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
