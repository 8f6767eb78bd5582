"""Experiment tracking with the reference's mlflow contract: a copy of
polyp_tpu/track/tracker.py.

One surface, mlflow's (`start_run(run_name=|run_id=)` as a context
manager, `log_params`, `log_metric`, `log_artifact`), with run-linking by
run id, so the augmentation eval logs into the generator's run. Two
backends:

* `JsonlTracker` (the default): a run is the directory
  `<root>/<experiment>/<run_id>/` with `params.json`, `metrics.jsonl` and
  copied artifacts; linking reopens the directory;
* `MlflowTracker`: mlflow, imported only when the tracker is built
  (POLYP_MLFLOW_URI set and mlflow importable).
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Iterator


class Run:
    def __init__(self, tracker: "Tracker", run_id: str):
        self._tracker = tracker
        self.run_id = run_id

    @property
    def info(self):  # mlflow parity: run.info.run_id
        return self


class Tracker:
    """Abstract tracking interface (mlflow-shaped)."""

    def set_experiment(self, name: str) -> None:
        raise NotImplementedError

    @contextmanager
    def start_run(self, run_name: str | None = None,
                  run_id: str | None = None) -> Iterator[Run]:
        raise NotImplementedError

    def log_params(self, params: dict[str, Any]) -> None:
        raise NotImplementedError

    def log_param(self, key: str, value: Any) -> None:
        self.log_params({key: value})

    def log_metric(self, key: str, value: float, step: int | None = None) -> None:
        raise NotImplementedError

    def log_metrics(self, metrics: dict[str, float], step: int | None = None) -> None:
        for k, v in metrics.items():
            self.log_metric(k, v, step)

    def log_artifact(self, local_path: str, artifact_path: str | None = None) -> None:
        raise NotImplementedError


class NullTracker(Tracker):
    """Records nothing: the tracker of a data-parallel group's ranks other
    than rank 0, which alone writes the run's records."""

    def set_experiment(self, name: str) -> None:
        pass

    @contextmanager
    def start_run(self, run_name: str | None = None,
                  run_id: str | None = None) -> Iterator[Run]:
        yield Run(self, run_id or "")

    def log_params(self, params: dict[str, Any]) -> None:
        pass

    def log_metric(self, key: str, value: float, step: int | None = None) -> None:
        pass

    def log_artifact(self, local_path: str, artifact_path: str | None = None) -> None:
        pass


class JsonlTracker(Tracker):
    def __init__(self, root: str | Path = "mlruns_local"):
        self.root = Path(root)
        self.experiment = "default"
        self._run_dir: Path | None = None
        self._run_stack: list[Path] = []

    # -- runs ------------------------------------------------------------
    def set_experiment(self, name: str) -> None:
        self.experiment = name

    def _dir_for(self, run_id: str) -> Path:
        # run_ids are unique across experiments; search for an existing dir
        # so run-linking works across scripts with different experiments set.
        for exp_dir in self.root.glob("*"):
            cand = exp_dir / run_id
            if cand.is_dir():
                return cand
        return self.root / self.experiment / run_id

    @contextmanager
    def start_run(self, run_name: str | None = None,
                  run_id: str | None = None) -> Iterator[Run]:
        if run_id is None:
            run_id = uuid.uuid4().hex[:16]
        run_dir = self._dir_for(run_id)
        run_dir.mkdir(parents=True, exist_ok=True)
        meta = run_dir / "meta.json"
        if not meta.exists():
            meta.write_text(json.dumps({
                "run_id": run_id,
                "run_name": run_name or run_id,
                "experiment": self.experiment,
                "start_time": time.time(),
            }))
        self._run_stack.append(run_dir)
        self._run_dir = run_dir
        try:
            yield Run(self, run_id)
        finally:
            self._run_stack.pop()
            self._run_dir = self._run_stack[-1] if self._run_stack else None

    def _require_run(self) -> Path:
        if self._run_dir is None:
            raise RuntimeError("No active run; use `with tracker.start_run(...):`")
        return self._run_dir

    # -- logging ---------------------------------------------------------
    def log_params(self, params: dict[str, Any]) -> None:
        run_dir = self._require_run()
        path = run_dir / "params.json"
        existing = json.loads(path.read_text()) if path.exists() else {}
        existing.update({k: _jsonable(v) for k, v in params.items()})
        path.write_text(json.dumps(existing, indent=2))

    def log_metric(self, key: str, value: float, step: int | None = None) -> None:
        run_dir = self._require_run()
        with (run_dir / "metrics.jsonl").open("a") as f:
            f.write(json.dumps({"key": key, "value": float(value),
                                "step": step, "time": time.time()}) + "\n")

    def log_artifact(self, local_path: str, artifact_path: str | None = None) -> None:
        run_dir = self._require_run()
        dest_dir = run_dir / "artifacts" / (artifact_path or "")
        dest_dir.mkdir(parents=True, exist_ok=True)
        src = Path(local_path)
        if src.is_dir():
            shutil.copytree(src, dest_dir / src.name, dirs_exist_ok=True)
        else:
            shutil.copy2(src, dest_dir / src.name)

    # -- reading back (for tests / reports) ------------------------------
    def read_metrics(self, run_id: str) -> list[dict[str, Any]]:
        path = self._dir_for(run_id) / "metrics.jsonl"
        if not path.exists():
            return []
        return [json.loads(line) for line in path.read_text().splitlines()]

    def read_params(self, run_id: str) -> dict[str, Any]:
        path = self._dir_for(run_id) / "params.json"
        return json.loads(path.read_text()) if path.exists() else {}


class MlflowTracker(Tracker):
    """Delegates to mlflow (kept API-identical; only built when importable)."""

    def __init__(self, tracking_uri: str):
        import mlflow  # imported only when this backend is built
        self._mlflow = mlflow
        mlflow.set_tracking_uri(tracking_uri)

    def set_experiment(self, name: str) -> None:
        self._mlflow.set_experiment(name)

    @contextmanager
    def start_run(self, run_name: str | None = None,
                  run_id: str | None = None) -> Iterator[Run]:
        # JsonlTracker supports a run stack; mlflow needs nested=True when a
        # run is already active or it raises.
        nested = self._mlflow.active_run() is not None
        with self._mlflow.start_run(run_name=run_name, run_id=run_id,
                                    nested=nested) as r:
            yield Run(self, r.info.run_id)

    def log_params(self, params: dict[str, Any]) -> None:
        self._mlflow.log_params({k: _jsonable(v) for k, v in params.items()})

    def log_metric(self, key: str, value: float, step: int | None = None) -> None:
        self._mlflow.log_metric(key, float(value), step=step or 0)

    def log_artifact(self, local_path: str, artifact_path: str | None = None) -> None:
        # The framework logs whole DIRECTORIES (LoRA bundles, model dirs,
        # train_with_lora_per_class.py:192-193); mlflow.log_artifact only
        # takes files — route dirs through log_artifacts under `{path}/{name}`
        # so the layout matches JsonlTracker's copytree(dest/src.name).
        src = Path(local_path)
        if src.is_dir():
            dest = f"{artifact_path}/{src.name}" if artifact_path else src.name
            self._mlflow.log_artifacts(str(src), artifact_path=dest)
        else:
            self._mlflow.log_artifact(str(src), artifact_path=artifact_path)

    def read_metrics(self, run_id: str) -> list[dict[str, Any]]:
        """JsonlTracker.read_metrics parity, via MlflowClient history."""
        client = self._mlflow.tracking.MlflowClient()
        run = client.get_run(run_id)
        out = []
        for key in run.data.metrics:
            for m in client.get_metric_history(run_id, key):
                out.append({"key": key, "value": m.value, "step": m.step,
                            "time": m.timestamp / 1000.0})
        return out

    def read_params(self, run_id: str) -> dict[str, Any]:
        client = self._mlflow.tracking.MlflowClient()
        return dict(client.get_run(run_id).data.params)


def _jsonable(v: Any) -> Any:
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


def get_tracker(root: str | Path = "mlruns_local") -> Tracker:
    """Tracker factory: mlflow if POLYP_MLFLOW_URI is set and mlflow is
    importable, else the local JSONL backend."""
    uri = os.environ.get("POLYP_MLFLOW_URI")
    if uri:
        try:
            return MlflowTracker(uri)
        except ImportError:
            pass
    return JsonlTracker(root)
