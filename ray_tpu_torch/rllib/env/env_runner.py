"""Env runners: CPU rollout workers (port of
ray_tpu/rllib/env/env_runner.py).

Rollouts stay on the CPU, as ray_tpu pins them: gymnasium vector envs and
a CPU forward of the same RLModule the learner trains, under
``torch.no_grad``. Weight sync ships host tensors (the module's state
dict). Remote runners are the port's actors. Actions are drawn from a
``torch.Generator`` seeded ``seed + 10_000 * worker_idx`` (ray_tpu's
PRNG key seed): other draws than ray_tpu's, the same law.

gymnasium is imported where an env is made; without it the ImportError
names it.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.env.episode import Episode


def import_gymnasium():
    try:
        import gymnasium
    except ImportError as e:
        raise ImportError(
            "RLlib's env runners make their environments with gymnasium, which this Python does not have "
            f"({e}); the learners, modules and algorithms' updates run without it") from e
    return gymnasium


def _make_env(env_id, env_config, num_envs):
    gym = import_gymnasium()
    return gym.make_vec(env_id, num_envs=num_envs, vectorization_mode="sync", **(env_config or {}))


class SingleAgentEnvRunner:
    """Steps ``num_envs`` vectorized envs; actions from the module's
    exploration pass. Runs in process (local mode) or as a remote actor."""

    def __init__(self, module_spec, env_id: str, env_config: dict | None = None, num_envs: int = 1, seed: int = 0,
                 worker_idx: int = 0, env_to_module=None, module_to_env=None):
        self.envs = _make_env(env_id, env_config, num_envs)
        self.num_envs = num_envs
        self.module = module_spec.build()  # on the CPU: rollouts are latency-bound host loops
        # connector pipelines: the obs transform applies ONCE at receipt,
        # so the module's forward and the learner (through the stored
        # episode obs) see one representation; the action transform
        # applies only on the way into env.step (episodes keep module-space
        # actions, so replayed logp inputs stay consistent)
        self._env_to_module = env_to_module
        self._module_to_env = module_to_env
        self._weights_set = False
        self._gen = torch.Generator().manual_seed(seed + 10_000 * worker_idx)
        obs, _ = self.envs.reset(seed=seed + 10_000 * worker_idx)
        self._obs = self._obs_transform(obs)
        self._building = [Episode() for _ in range(num_envs)]
        for ep, o in zip(self._building, self._obs):
            ep.obs.append(np.asarray(o))
        # gymnasium >= 1.0 NEXT_STEP autoreset: the step after a terminal
        # ignores the action and returns the reset obs: not a transition
        self._pending_reset = np.zeros(num_envs, dtype=bool)
        # true per-env episode return, accumulated across segment cuts
        self._return_acc = np.zeros(num_envs, dtype=np.float64)
        self._episode_returns: deque = deque(maxlen=100)
        self._episodes_this_sample = 0

    def _obs_transform(self, obs):
        if self._env_to_module is None:
            return obs
        return self._env_to_module(obs, action_space=self.envs.single_action_space)

    def _action_transform(self, actions):
        if self._module_to_env is None:
            return actions
        return self._module_to_env(actions, action_space=self.envs.single_action_space)

    def get_connector_states(self) -> dict:
        return {
            "env_to_module": self._env_to_module.get_state() if self._env_to_module else {},
            "module_to_env": self._module_to_env.get_state() if self._module_to_env else {},
        }

    def set_weights(self, weights: dict):
        self.module.load_state_dict(weights)
        self._weights_set = True

    def set_exploration(self, **kw):
        """Push exploration knobs (DQN's ``eps``) onto the module's
        distribution; a knob it lacks is ignored."""
        dist = self.module.action_dist_cls
        for k, v in kw.items():
            if hasattr(dist, k):
                setattr(dist, k, v)

    def get_exploration(self, name: str):
        """An exploration knob's value on this runner (None if absent)."""
        return getattr(self.module.action_dist_cls, name, None)

    def get_spaces(self):
        return self.envs.single_observation_space, self.envs.single_action_space

    @torch.no_grad()
    def sample(self, num_steps: int, explore: bool = True) -> tuple[list[dict], dict]:
        """Collect ~num_steps env steps (across vector envs); returns
        (episode segment batches, metrics). Segments end at a terminal, a
        truncation or the collection cut; each carries a bootstrap obs row."""
        if not self._weights_set:
            raise RuntimeError("set_weights before sample")
        segments: list[Episode] = []
        steps_left = num_steps
        self._episodes_this_sample = 0
        dist = self.module.action_dist_cls
        while steps_left > 0:
            out = self.module.forward_exploration(torch.as_tensor(np.asarray(self._obs, dtype=np.float32)))
            inputs = out["action_dist_inputs"]
            actions = dist.sample(self._gen, inputs) if explore else dist.deterministic(inputs)
            logp_np = dist.logp(inputs, actions).numpy()
            actions_np = actions.numpy()
            vf_np = out["vf"].numpy()
            obs, rewards, terms, truncs, _ = self.envs.step(self._action_transform(actions_np))
            obs = self._obs_transform(obs)
            for i in range(self.num_envs):
                if self._pending_reset[i]:
                    # this step reset env i: obs[i] starts a new episode and
                    # the action was ignored; record nothing
                    fresh = Episode()
                    fresh.obs.append(np.asarray(obs[i]))
                    self._building[i] = fresh
                    self._pending_reset[i] = False
                    continue
                ep = self._building[i]
                ep.actions.append(actions_np[i])
                ep.rewards.append(float(rewards[i]))
                ep.logp.append(float(logp_np[i]))
                ep.vf_preds.append(float(vf_np[i]))
                ep.obs.append(np.asarray(obs[i]))  # NEXT_STEP mode: the true final obs at a terminal
                self._return_acc[i] += float(rewards[i])
                if terms[i] or truncs[i]:
                    ep.is_terminated = bool(terms[i])
                    self._episode_returns.append(float(self._return_acc[i]))
                    self._episodes_this_sample += 1
                    self._return_acc[i] = 0.0
                    segments.append(ep)
                    self._pending_reset[i] = True
            self._obs = obs
            steps_left -= self.num_envs
        # cut still-running episodes into segments (bootstrap from the last obs)
        for i in range(self.num_envs):
            if self._pending_reset[i]:
                continue  # episode already emitted; the env resets next step
            ep = self._building[i]
            if len(ep) > 0:
                segments.append(ep)
                fresh = Episode()
                fresh.obs.append(ep.obs[-1])
                self._building[i] = fresh
        returns = list(self._episode_returns)
        metrics = {
            "episode_return_mean": float(np.mean(returns)) if returns else float("nan"),
            "num_episodes": self._episodes_this_sample,
            "num_env_steps": int(num_steps - steps_left),
        }
        return [s.to_batch() for s in segments], metrics


class EnvRunnerActor(SingleAgentEnvRunner):
    """A remote env runner (module level: the port sends classes by
    reference). Its forwards are a few rows wide: one intra-op thread, so
    several runners and learners on one host do not spin against each
    other's thread pools."""

    def __init__(self, *args, **kwargs):
        torch.set_num_threads(1)
        super().__init__(*args, **kwargs)


class EnvRunnerGroup:
    """N remote env-runner actors, or one runner in process when
    ``num_env_runners == 0``."""

    def __init__(self, module_spec, env_id, env_config=None, num_env_runners: int = 0,
                 num_envs_per_env_runner: int = 1, seed: int = 0, output: str | None = None, env_to_module=None,
                 module_to_env=None):
        self.num_env_runners = num_env_runners
        # offline-data recording: every collected episode batch is
        # appended to JSONL shards as it reaches the driver
        self._writer = None
        if output:
            from ray_tpu_torch.rllib.offline import JsonWriter

            self._writer = JsonWriter(output)
        self._local = None
        self._actors = []
        if num_env_runners == 0:
            self._local = SingleAgentEnvRunner(module_spec, env_id, env_config, num_envs_per_env_runner, seed,
                                               env_to_module=env_to_module, module_to_env=module_to_env)
        else:
            cls = ray_tpu_torch.remote(EnvRunnerActor)
            self._actors = [
                cls.remote(module_spec, env_id, env_config, num_envs_per_env_runner, seed, worker_idx=i + 1,
                           env_to_module=env_to_module, module_to_env=module_to_env)
                for i in range(num_env_runners)
            ]

    def get_spaces(self):
        if self._local is not None:
            return self._local.get_spaces()
        return ray_tpu_torch.get(self._actors[0].get_spaces.remote())

    def sync_weights(self, weights: dict):
        """``weights``: host tensors (a learner's ``get_weights()``)."""
        if self._local is not None:
            self._local.set_weights(weights)
        else:
            ray_tpu_torch.get([a.set_weights.remote(weights) for a in self._actors])

    def set_exploration(self, **kw):
        if self._local is not None:
            self._local.set_exploration(**kw)
        else:
            ray_tpu_torch.get([a.set_exploration.remote(**kw) for a in self._actors])

    def get_exploration(self, name: str) -> list:
        """The knob's value on every runner."""
        if self._local is not None:
            return [self._local.get_exploration(name)]
        return ray_tpu_torch.get([a.get_exploration.remote(name) for a in self._actors])

    def sample(self, num_steps: int, explore: bool = True):
        """Returns (all segment batches, per-runner metrics list)."""
        if self._local is not None:
            segs, m = self._local.sample(num_steps, explore)
            self._record(segs)
            return segs, [m]
        return self.collect(self.sample_async(num_steps, explore))

    def sample_async(self, num_steps: int, explore: bool = True):
        """Start sampling on every remote runner; returns refs for
        ``collect()`` (IMPALA overlaps sampling with the learner update)."""
        if not self._actors:
            raise RuntimeError("sample_async needs remote env runners (num_env_runners >= 1)")
        per = max(1, num_steps // len(self._actors))
        return [a.sample.remote(per, explore) for a in self._actors]

    def collect(self, refs):
        outs = ray_tpu_torch.get(refs)
        segments: list[dict] = []
        metrics = []
        for segs, m in outs:
            segments.extend(segs)
            metrics.append(m)
        self._record(segments)
        return segments, metrics

    def _record(self, segments):
        if self._writer is not None:
            for s in segments:
                self._writer.write(s)

    def stop(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        for a in self._actors:
            ray_tpu_torch.kill(a)
        self._actors = []
