"""Offline RL datasets: episode JSONL in and out (port of
ray_tpu/rllib/offline/json_io.py; the same format, so a file either
package writes reads back in the other).

Env runners write sampled episodes to JSONL shards
(``config.offline_data(output=...)``). Rows are the env runner's episode
batches (obs has T+1 rows; ``terminated`` marks true ends), stored as
plain lists so any tool can read them.
"""

from __future__ import annotations

import json
import os

import numpy as np


class JsonWriter:
    """Append episode batches to sharded JSONL files."""

    def __init__(self, path: str, max_rows_per_shard: int = 5000):
        import uuid

        self.path = path
        os.makedirs(path, exist_ok=True)
        self.max_rows = max_rows_per_shard
        # unique per WRITER, not just per pid: two writers in one process
        # (sequential runs on the same path) must not append to the same
        # shard file
        self._tag = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self._shard = 0
        self._rows = 0
        self._f = None

    def _file(self):
        if self._f is None or self._rows >= self.max_rows:
            if self._f is not None:
                self._f.close()
                self._shard += 1
                self._rows = 0
            self._f = open(os.path.join(self.path, f"episodes-{self._tag}-{self._shard:05d}.jsonl"), "a", buffering=1)
        return self._f

    def write(self, episode_batch: dict):
        row = {
            "obs": np.asarray(episode_batch["obs"], np.float32).tolist(),
            "actions": np.asarray(episode_batch["actions"]).tolist(),
            "rewards": np.asarray(episode_batch["rewards"], np.float32).tolist(),
            "logp": np.asarray(episode_batch.get("logp", [])).tolist(),
            "terminated": bool(episode_batch.get("terminated", False)),
        }
        self._file().write(json.dumps(row) + "\n")
        self._rows += 1

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class JsonReader:
    """Iterate episode batches from a JSONL file or shard directory."""

    def __init__(self, path: str):
        self.path = path

    def _files(self):
        if os.path.isdir(self.path):
            return sorted(
                os.path.join(self.path, n) for n in os.listdir(self.path) if n.endswith(".jsonl")
            )
        return [self.path]

    def __iter__(self):
        for fp in self._files():
            with open(fp) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    row = json.loads(line)
                    yield {
                        "obs": np.asarray(row["obs"], np.float32),
                        "actions": np.asarray(row["actions"]),
                        "rewards": np.asarray(row["rewards"], np.float32),
                        "logp": np.asarray(row.get("logp", []), np.float32),
                        "terminated": bool(row.get("terminated", False)),
                    }


def write_episodes(path: str, episode_batches: list):
    w = JsonWriter(path)
    for b in episode_batches:
        w.write(b)
    w.close()


def read_episodes(path: str) -> list:
    return list(JsonReader(path))


def fill_replay(replay, path: str, refuse_overflow: bool = False) -> int:
    """Every transition of the episode dataset at ``path`` into ``replay``
    (a replay buffer); their number. An empty dataset raises, and with
    ``refuse_overflow`` (DQN) so does one larger than the buffer: its ring
    would drop the first transitions."""
    n = 0
    for episode in JsonReader(path):
        n += len(replay.add(episode))
        if refuse_overflow and n > replay.capacity:
            raise ValueError(
                f"offline dataset {path!r} exceeds replay_buffer_capacity "
                f"({replay.capacity}): the ring would silently drop early "
                "transitions — raise replay_buffer_capacity to at least the dataset size"
            )
    if n == 0:
        raise ValueError(f"offline input {path!r} contained no transitions")
    return n
