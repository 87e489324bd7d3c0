"""Metrics logging: every scalar to an append-only JSONL stream
(`<name>_metrics.jsonl`) and, when tensorboardX imports, to TensorBoard;
and the training loop's per-meta-step time line."""
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


def log_estimated_time_remaining(start_time: float, cur_step: int,
                                 total_steps: int,
                                 unit_name: str = "meta-step",
                                 log_fn=print) -> float:
    """Log the minutes since `start_time` and the hours the remaining
    steps would take at that rate; returns the minutes."""
    elapsed = (time.time() - start_time) / 60.0
    log_fn("This {} took: {} minutes.".format(unit_name, elapsed))
    log_fn("Estimated training hours remaining:%.4f"
           % ((total_steps - cur_step) * elapsed / 60.0))
    return elapsed
