"""Checkpoint: a directory handle, and the controller's top-k manager
(port of ray_tpu/train/_checkpoint.py). Storage is a local or NFS path;
a model's state goes into the directory through ``jax_checkpoint.py``
(torch state, ``torch.save``) or any files the loop writes."""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import uuid


class Checkpoint:
    def __init__(self, path: str):
        self.path = str(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, path: str | None = None) -> str:
        """Materialize into `path` (copy); returns the directory."""
        if path is None:
            path = tempfile.mkdtemp(prefix="rt_ckpt_")
        if os.path.abspath(path) != os.path.abspath(self.path):
            shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    @contextlib.contextmanager
    def as_directory(self):
        """Context manager giving a local directory view (no copy when the
        checkpoint is already local)."""
        yield self.path

    def update_metadata(self, metadata: dict):
        meta = self.get_metadata()
        meta.update(metadata)
        with open(os.path.join(self.path, ".metadata.json"), "w") as f:
            json.dump(meta, f)

    def get_metadata(self) -> dict:
        p = os.path.join(self.path, ".metadata.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"

    def __eq__(self, other):
        return isinstance(other, Checkpoint) and os.path.abspath(self.path) == os.path.abspath(other.path)


class CheckpointManager:
    """Top-k checkpoint retention keyed on a score attribute.

    The controller-side arbiter: workers write, the controller copies and
    registers, rank 0's metrics score.
    """

    def __init__(self, run_dir: str, config=None):
        from ray_tpu_torch.train.config import CheckpointConfig

        self.run_dir = run_dir
        self.config = config or CheckpointConfig()
        self._tracked: list[tuple[float | None, int, Checkpoint, dict]] = []
        self._seq = 0
        os.makedirs(run_dir, exist_ok=True)

    def new_checkpoint_dir(self, name: str | None = None) -> str:
        self._seq += 1
        name = name or f"checkpoint_{self._seq:06d}_{uuid.uuid4().hex[:6]}"
        d = os.path.join(self.run_dir, name)
        os.makedirs(d, exist_ok=True)
        return d

    def register_checkpoint(self, checkpoint: Checkpoint, metrics: dict) -> Checkpoint:
        score = None
        attr = self.config.checkpoint_score_attribute
        if attr is not None and attr in (metrics or {}):
            score = float(metrics[attr])
        self._tracked.append((score, self._seq, checkpoint, dict(metrics or {})))
        self._evict()
        return checkpoint

    def _evict(self):
        k = self.config.num_to_keep
        if k is None or len(self._tracked) <= k:
            return
        sign = 1.0 if self.config.checkpoint_score_order == "max" else -1.0

        def keep_rank(entry):
            score, seq, _, _ = entry
            # unscored checkpoints fall back to recency
            return (0, sign * score) if score is not None else (-1, seq)

        latest = self._tracked[-1]  # never delete the most recent (resume anchor)
        ranked = sorted(self._tracked[:-1], key=keep_rank, reverse=True)
        keep = ranked[: k - 1] + [latest]
        for score, seq, ckpt, _ in self._tracked:
            if all(c is not ckpt for _, _, c, _ in keep):
                shutil.rmtree(ckpt.path, ignore_errors=True)
        self._tracked = [e for e in self._tracked if any(e[2] is c for _, _, c, _ in keep)]

    @property
    def latest_checkpoint(self) -> Checkpoint | None:
        return self._tracked[-1][2] if self._tracked else None

    @property
    def best_checkpoint(self) -> Checkpoint | None:
        scored = [e for e in self._tracked if e[0] is not None]
        if not scored:
            return self.latest_checkpoint
        sign = 1.0 if self.config.checkpoint_score_order == "max" else -1.0
        return max(scored, key=lambda e: sign * e[0])[2]

    def best_checkpoints(self) -> list[tuple[Checkpoint, dict]]:
        return [(c, m) for _, _, c, m in self._tracked]
