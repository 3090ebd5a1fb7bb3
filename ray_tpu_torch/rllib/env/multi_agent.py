"""Multi-agent environments and per-policy rollout collection (port of
ray_tpu/rllib/env/multi_agent.py).

``MultiAgentEnv`` is the dict-keyed env protocol with the "__all__" done
flag; ``MultiAgentEnvRunner`` steps all agents of one env, each agent's
actions from the module of the policy its id maps to
(``policy_mapping_fn``), and routes each agent's experience into that
policy's episode segments. Per-policy batches feed independent learners.
Forwards run on the CPU under ``torch.no_grad``; draws come from a
``torch.Generator`` seeded ``seed + 10_000 * worker_idx``.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ray_tpu_torch.rllib.env.episode import Episode


class MultiAgentEnv:
    """Dict-keyed env protocol:

    reset() -> (obs_dict, info_dict)
    step(action_dict) -> (obs, rewards, terminateds, truncateds, infos),
    each keyed by agent id; terminateds/truncateds carry "__all__".
    Agents may appear and disappear between steps (act only for present ids).
    """

    possible_agents: list = []
    observation_spaces: dict = {}
    action_spaces: dict = {}

    def reset(self, *, seed=None, options=None):
        raise NotImplementedError

    def step(self, action_dict: dict):
        raise NotImplementedError


def _identity(agent_id):
    return agent_id


class MultiAgentEnvRunner:
    """Steps one multi-agent env; routes each agent's experience to its
    policy's segments."""

    def __init__(self, env_factory, module_specs: dict, policy_mapping_fn=None, seed: int = 0, worker_idx: int = 0):
        self.env = env_factory() if callable(env_factory) else env_factory
        self.modules = {pid: spec.build() for pid, spec in module_specs.items()}
        self.policy_mapping_fn = policy_mapping_fn or _identity
        self._weights_set = False
        self._gen = torch.Generator().manual_seed(seed + 10_000 * worker_idx)
        self._seed = seed + 10_000 * worker_idx
        self._obs, _ = self.env.reset(seed=self._seed)
        self._building: dict = {}  # agent_id -> Episode
        self._done_agents: set = set()  # terminated before __all__: no more actions
        self._new_episodes()

    def _new_episodes(self):
        for aid, o in self._obs.items():
            if aid not in self._building and aid not in self._done_agents:
                ep = Episode()
                ep.obs.append(np.asarray(o))
                self._building[aid] = ep

    def _reset(self):
        self._seed += 1
        self._obs, _ = self.env.reset(seed=self._seed)
        self._done_agents.clear()
        self._building = {}
        self._new_episodes()

    def set_weights(self, weights_by_policy: dict):
        for pid, w in weights_by_policy.items():
            self.modules[pid].load_state_dict(w)
        self._weights_set = True

    @torch.no_grad()
    def sample(self, num_steps: int, explore: bool = True) -> tuple[dict, dict]:
        """Collect ~num_steps env steps. Returns
        ({policy_id: [episode batches]}, metrics)."""
        if not self._weights_set:
            raise RuntimeError("set_weights before sample")
        out_segments: dict[str, list] = defaultdict(list)
        episodes_done = 0
        returns: list[float] = []
        for _ in range(num_steps):
            # group LIVE agents by policy for batched forwards (an agent
            # terminated before __all__ takes no further actions)
            by_policy: dict[str, list] = defaultdict(list)
            for aid in self._obs:
                if aid not in self._done_agents:
                    by_policy[self.policy_mapping_fn(aid)].append(aid)
            if not by_policy:
                self._reset()  # everyone done but the env never raised __all__
                continue
            actions: dict = {}
            step_info: dict = {}
            for pid, aids in by_policy.items():
                obs_arr = torch.as_tensor(np.stack([np.asarray(self._obs[a], np.float32) for a in aids]))
                module = self.modules[pid]
                fwd = module.forward_exploration(obs_arr)
                dist = module.action_dist_cls
                inputs = fwd["action_dist_inputs"]
                acts = dist.sample(self._gen, inputs) if explore else dist.deterministic(inputs)
                logp = dist.logp(inputs, acts).numpy()
                vf = fwd["vf"].numpy()
                acts = acts.numpy()
                for i, a in enumerate(aids):
                    actions[a] = acts[i]
                    step_info[a] = (float(logp[i]), float(vf[i]))
            obs, rewards, terms, truncs, _ = self.env.step(actions)
            done_all = bool(terms.get("__all__", False) or truncs.get("__all__", False))
            for aid, act in actions.items():
                ep = self._building.get(aid)
                if ep is None:
                    continue
                lp, v = step_info[aid]
                ep.actions.append(act)
                ep.rewards.append(float(rewards.get(aid, 0.0)))
                ep.logp.append(lp)
                ep.vf_preds.append(v)
                ep.obs.append(np.asarray(obs.get(aid, ep.obs[-1])))
                if terms.get(aid, False) or truncs.get(aid, False) or done_all:
                    ep.is_terminated = bool(terms.get(aid, False) or terms.get("__all__", False))
                    out_segments[self.policy_mapping_fn(aid)].append(ep)
                    returns.append(ep.total_reward)
                    self._building.pop(aid, None)
                    if not done_all:
                        self._done_agents.add(aid)  # dead until the episode ends
            if done_all:
                episodes_done += 1
                self._reset()
            else:
                self._obs = obs
                self._new_episodes()
        # cut still-running agent episodes (bootstrap from the last obs)
        for aid, ep in list(self._building.items()):
            if len(ep) > 0:
                out_segments[self.policy_mapping_fn(aid)].append(ep)
                fresh = Episode()
                fresh.obs.append(ep.obs[-1])
                self._building[aid] = fresh
        metrics = {
            "episode_return_mean": float(np.mean(returns)) if returns else float("nan"),
            "num_episodes": episodes_done,
        }
        return {pid: [s.to_batch() for s in segs] for pid, segs in out_segments.items()}, metrics


class MultiAgentEnvRunnerActor(MultiAgentEnvRunner):
    """A remote multi-agent runner (module level: classes travel by
    reference; wrap it with ``ray_tpu_torch.remote``), on one intra-op
    thread as ``EnvRunnerActor``."""

    def __init__(self, *args, **kwargs):
        torch.set_num_threads(1)
        super().__init__(*args, **kwargs)
