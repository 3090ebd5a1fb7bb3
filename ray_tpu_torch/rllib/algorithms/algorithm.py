"""Algorithm: the RL training driver (port of
ray_tpu/rllib/algorithms/algorithm.py): an EnvRunnerGroup and a
LearnerGroup; subclasses implement ``training_step()`` and name their
Learner class. Offline training (``offline_data(input_=...)``) is for
the algorithms that say ``supports_offline_input`` (DQN, CQL, BC,
MARWIL); their env runners only evaluate, greedily.

The checkpoint is the port's own: ``torch.save`` of host tensors and
plain values (``algorithm_state.pt``), read back with
``weights_only=True``; it does not read ray_tpu's pickles.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ray_tpu_torch.rllib.core.rl_module import MLPModule, RLModuleSpec
from ray_tpu_torch.rllib.env.env_runner import EnvRunnerGroup, import_gymnasium

CHECKPOINT_FILE = "algorithm_state.pt"


class Algorithm:
    learner_cls: type = None  # set by subclasses
    supports_offline_input = False  # DQN-family overrides

    def __init__(self, config):
        self.config = config
        self.iteration = 0
        self._total_env_steps = 0
        self.setup()

    # -- topology --
    def setup(self):
        cfg = self.config
        if cfg.env is None:
            raise ValueError("config.environment(env=...) is required")
        if cfg.input_ and not type(self).supports_offline_input:
            raise NotImplementedError(
                f"{type(self).__name__} does not support offline_data(input_=...); "
                "use an off-policy algorithm (DQN)"
            )
        if cfg.input_ and cfg.output:
            raise ValueError(
                "offline_data(input_=..., output=...) conflict: offline mode "
                "evaluates greedily and recording those episodes would pollute "
                "the dataset — drop output for offline training"
            )
        # spaces come from a throwaway env (cheap for gym registry ids)
        gym = import_gymnasium()
        probe = gym.make(cfg.env, **cfg.env_config)
        obs_space, act_space = probe.observation_space, probe.action_space
        probe.close()
        self.module_spec = RLModuleSpec(cfg.module_class or MLPModule, obs_space, act_space, cfg.model)
        self.env_runner_group = EnvRunnerGroup(
            self.module_spec, cfg.env, cfg.env_config, num_env_runners=cfg.num_env_runners,
            num_envs_per_env_runner=cfg.num_envs_per_env_runner, seed=cfg.seed, output=cfg.output,
            env_to_module=cfg.env_to_module_connector, module_to_env=cfg.module_to_env_connector)
        from ray_tpu_torch.rllib.core.learner import LearnerGroup

        self.learner_group = LearnerGroup(type(self).learner_cls, self.module_spec, cfg, num_learners=cfg.num_learners)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())

    # -- public API --
    def train(self) -> dict:
        t0 = time.perf_counter()
        self.iteration += 1
        result = self.training_step()
        result.setdefault("training_iteration", self.iteration)
        result.setdefault("time_this_iter_s", time.perf_counter() - t0)
        result.setdefault("num_env_steps_sampled_lifetime", self._total_env_steps)
        return result

    def training_step(self) -> dict:
        raise NotImplementedError

    def stop(self):
        self.env_runner_group.stop()
        self.learner_group.stop()

    # -- checkpointing --
    def save_to_path(self, path: str) -> str:
        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        state = {"iteration": self.iteration, "total_env_steps": self._total_env_steps,
                 "learner": self.learner_group.get_state()}
        torch.save(state, p / CHECKPOINT_FILE)
        return str(p)

    def restore_from_path(self, path: str):
        state = torch.load(Path(path) / CHECKPOINT_FILE, weights_only=True)
        self.iteration = state["iteration"]
        self._total_env_steps = state["total_env_steps"]
        self.learner_group.set_state(state["learner"])
        self.env_runner_group.sync_weights(self.learner_group.get_weights())

    # -- shared helpers --
    def _require_offline_only(self):
        """Guard of the offline-only algorithms (BC, MARWIL)."""
        cfg = self.config
        if not cfg.input_:
            raise ValueError(
                f"{type(self).__name__} is offline-only: configure "
                "offline_data(input_=<episode dataset path>)"
            )
        if cfg.num_learners > 0:
            raise NotImplementedError(f"{type(self).__name__} runs a single (local) learner")

    def _offline_eval_result(self, learner_metrics: dict, num_updates: int) -> dict:
        """Tail of an offline training_step: push the weights, evaluate the
        policy greedily (no exploration data enters offline training) and
        package the result."""
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        _, runner_metrics = self.env_runner_group.sample(self.config.rollout_fragment_length, explore=False)
        result = self._merge_runner_metrics(runner_metrics)
        result["learner"] = {"num_updates": num_updates, **learner_metrics}
        return result

    @staticmethod
    def _merge_runner_metrics(metrics: list[dict]) -> dict:
        returns = [m["episode_return_mean"] for m in metrics if np.isfinite(m.get("episode_return_mean", float("nan")))]
        return {
            "env_runners": {
                "episode_return_mean": float(np.mean(returns)) if returns else float("nan"),
                "num_episodes": int(sum(m.get("num_episodes", 0) for m in metrics)),
            }
        }

    @staticmethod
    def _merge_learner_metrics(learner_metrics: list[dict]) -> dict:
        return {k: float(np.mean([m[k] for m in learner_metrics])) for k in learner_metrics[0]}
