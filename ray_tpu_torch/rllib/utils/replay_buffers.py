"""Replay buffers for off-policy RL (port of
ray_tpu/rllib/utils/replay_buffers.py: a copy, numpy only).

Uniform transition sampling out of stored episodes, and proportional
prioritization over a sum tree. Transitions live in preallocated numpy
ring arrays, so ``sample()`` returns contiguous stacked batches that a
learner copies to its device in one transfer a column. The draws are
ray_tpu's: the same adds and ``seed`` give the same indices, rows,
importance weights and priorities.
"""

from __future__ import annotations

import numpy as np


class SumTree:
    """Binary sum tree over `capacity` priorities: O(log n) update and
    prefix-sum sampling (reference: rllib/execution/segment_tree.py)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        size = 1
        while size < self.capacity:
            size *= 2
        self._size = size
        self._tree = np.zeros(2 * size, dtype=np.float64)

    def set(self, idx: int, value: float):
        i = idx + self._size
        self._tree[i] = value
        i //= 2
        while i >= 1:
            self._tree[i] = self._tree[2 * i] + self._tree[2 * i + 1]
            i //= 2

    def get(self, idx: int) -> float:
        return float(self._tree[idx + self._size])

    def total(self) -> float:
        return float(self._tree[1])

    def prefix_index(self, mass: float) -> int:
        """Largest idx with prefix_sum(idx) <= mass (proportional pick)."""
        i = 1
        while i < self._size:
            left = self._tree[2 * i]
            if mass < left:
                i = 2 * i
            else:
                mass -= left
                i = 2 * i + 1
        return min(i - self._size, self.capacity - 1)


class EpisodeReplayBuffer:
    """Uniform transition replay. `add(episode_batch)` ingests one episode
    segment (the env runner's to_batch dict: obs has T+1 rows); `sample(n)`
    returns {obs, actions, rewards, next_obs, done} stacked arrays."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = int(capacity)
        self._arrays: dict[str, np.ndarray] | None = None
        self._write = 0
        self._count = 0
        self._rng = np.random.default_rng(seed)

    def _ensure(self, obs, action):
        if self._arrays is not None:
            return
        obs_shape = np.asarray(obs).shape
        act = np.asarray(action)
        self._arrays = {
            "obs": np.zeros((self.capacity, *obs_shape), np.float32),
            "next_obs": np.zeros((self.capacity, *obs_shape), np.float32),
            "actions": np.zeros((self.capacity, *act.shape), act.dtype if act.dtype != np.float64 else np.float32),
            "rewards": np.zeros((self.capacity,), np.float32),
            "done": np.zeros((self.capacity,), np.float32),
        }

    def __len__(self) -> int:
        return self._count

    def _add_row(self, obs, next_obs, action, reward, done) -> int:
        i = self._write
        a = self._arrays
        a["obs"][i] = obs
        a["next_obs"][i] = next_obs
        a["actions"][i] = action
        a["rewards"][i] = reward
        a["done"][i] = done
        self._write = (self._write + 1) % self.capacity
        self._count = min(self._count + 1, self.capacity)
        return i

    def add(self, episode_batch: dict) -> list[int]:
        """Ingest an episode segment; returns the row indices written.
        `done` marks true terminals only — truncation/segment cuts
        bootstrap (reference: episode_replay_buffer add() semantics)."""
        obs = np.asarray(episode_batch["obs"], np.float32)
        actions = np.asarray(episode_batch["actions"])
        rewards = np.asarray(episode_batch["rewards"], np.float32)
        terminated = bool(episode_batch.get("terminated", False))
        T = len(actions)
        if T == 0:
            return []
        self._ensure(obs[0], actions[0])
        rows = []
        for t in range(T):
            done = terminated and t == T - 1
            rows.append(self._add_row(obs[t], obs[t + 1], actions[t], rewards[t], float(done)))
        return rows

    def sample(self, n: int) -> dict:
        idx = self._rng.integers(0, self._count, size=n)
        return self._gather(idx)

    def _gather(self, idx) -> dict:
        a = self._arrays
        return {k: v[idx] for k, v in a.items()}


class PrioritizedEpisodeReplayBuffer(EpisodeReplayBuffer):
    """Proportional prioritized replay (reference:
    prioritized_episode_replay_buffer.py): P(i) ~ priority_i^alpha, with
    importance weights (N * P(i))^-beta normalized by the max weight.
    New transitions enter at max priority; update_priorities() feeds
    |td_error| back after each learner step."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6, beta: float = 0.4, eps: float = 1e-6, seed: int = 0):
        super().__init__(capacity, seed=seed)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.eps = float(eps)
        self._tree = SumTree(self.capacity)
        self._max_priority = 1.0

    def _add_row(self, *args) -> int:
        i = super()._add_row(*args)
        self._tree.set(i, self._max_priority**self.alpha)
        return i

    def sample(self, n: int) -> dict:
        total = self._tree.total()
        masses = (self._rng.random(n) + np.arange(n)) / n * total  # stratified
        idx = np.array([self._tree.prefix_index(m) for m in masses], dtype=np.int64)
        idx = np.minimum(idx, self._count - 1)
        batch = self._gather(idx)
        probs = np.array([self._tree.get(i) for i in idx]) / max(total, 1e-12)
        weights = (self._count * np.maximum(probs, 1e-12)) ** (-self.beta)
        batch["weights"] = (weights / weights.max()).astype(np.float32)
        batch["batch_indices"] = idx
        return batch

    def update_priorities(self, idx, td_errors):
        for i, td in zip(np.asarray(idx), np.asarray(td_errors)):
            p = float(abs(td)) + self.eps
            self._max_priority = max(self._max_priority, p)
            self._tree.set(int(i), p**self.alpha)
