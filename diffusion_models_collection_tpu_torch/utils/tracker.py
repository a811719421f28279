"""Experiment tracking.

Counterpart of `diffusion_models_collection_tpu/utils/tracker.py`: a JSONL
file sink that always runs, and SwanLab when `use_swanlab` is set and the
package is importable. The trainer logs the reference's names: train/loss,
train/lr, train/epoch_time, the step-time summary, and sample-grid paths.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class Tracker:
    def log(self, data: Dict[str, Any], step: Optional[int] = None) -> None:
        raise NotImplementedError

    def log_image(self, name: str, path: str,
                  step: Optional[int] = None) -> None:
        pass

    def finish(self) -> None:
        pass


class NullTracker(Tracker):
    def log(self, data, step=None):
        pass


class JsonlTracker(Tracker):
    """Append-only JSONL metrics sink, `<log_dir>/<run>.metrics.jsonl`."""

    def __init__(self, log_dir: str, run_name: str = "run"):
        self.path = Path(log_dir) / f"{run_name}.metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, data, step=None):
        record = {"time": time.time(), "step": step, **data}
        with self.path.open("a", encoding="utf-8") as f:
            f.write(json.dumps(record, default=float) + "\n")

    def log_image(self, name, path, step=None):
        self.log({f"image/{name}": str(path)}, step)


class SwanLabTracker(Tracker):
    """SwanLab sink (optional dependency)."""

    def __init__(self, project: str, experiment_name: str, config: dict):
        import swanlab

        self._swanlab = swanlab
        swanlab.init(project=project, experiment_name=experiment_name,
                     config=config)

    def log(self, data, step=None):
        self._swanlab.log(data, step=step)

    def finish(self):
        self._swanlab.finish()


class MultiTracker(Tracker):
    def __init__(self, *trackers: Tracker):
        self.trackers = list(trackers)

    def log(self, data, step=None):
        for t in self.trackers:
            t.log(data, step)

    def log_image(self, name, path, step=None):
        for t in self.trackers:
            t.log_image(name, path, step)

    def finish(self):
        for t in self.trackers:
            t.finish()


def build_tracker(config: dict, log_dir: str) -> Tracker:
    trackers = [JsonlTracker(log_dir, config.get("experiment_name", "run"))]
    if config.get("use_swanlab", False):
        try:
            trackers.append(SwanLabTracker(
                config.get("project_name", "diffusion-models"),
                config.get("experiment_name", "experiment"), config))
        except ImportError:
            print("swanlab not installed; falling back to JSONL tracking only")
    return MultiTracker(*trackers)
