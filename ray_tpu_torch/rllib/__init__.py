"""ray_tpu_torch.rllib: reinforcement learning over the port's runtime
(port of ray_tpu/rllib/, its on-policy half).

An Algorithm over an EnvRunnerGroup of CPU rollout runners and a
LearnerGroup of learners on the card (``torch.nn.Module`` policies,
``torch.optim.Adam``); several learners average their gradients through
the port's collective API. Ported: PPO, IMPALA and APPO, the modules,
distributions, learners, env runners, multi-agent runners, connectors,
episodes and the JSONL episode writer and reader.

DQN, SAC, CQL, BC, MARWIL and the replay buffers (the off-policy and
offline half) are not ported yet: each raises NotImplementedError naming
ROADMAP.md's item ``RLLIB_ITEM``.
"""

from ray_tpu_torch.core.context import RLLIB_ITEM, not_ported
from ray_tpu_torch.util.usage import record_library_usage as _rlu

_rlu("rllib")

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm  # noqa: E402, F401
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig  # noqa: E402, F401
from ray_tpu_torch.rllib.algorithms.appo.appo import APPO, APPOConfig  # noqa: E402, F401
from ray_tpu_torch.rllib.algorithms.impala.impala import IMPALA, IMPALAConfig  # noqa: E402, F401
from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig  # noqa: E402, F401
from ray_tpu_torch.rllib.connectors import ConnectorPipeline, ConnectorV2  # noqa: E402, F401
from ray_tpu_torch.rllib.core.rl_module import MLPModule, RLModule, RLModuleSpec  # noqa: E402, F401
from ray_tpu_torch.rllib.env.multi_agent import MultiAgentEnv, MultiAgentEnvRunner  # noqa: E402, F401


class _NotPorted:
    """An off-policy or offline name of ray_tpu.rllib: raises on use."""

    def __init__(self, *args, **kwargs):
        not_ported(f"ray_tpu.rllib's {type(self).__name__}", RLLIB_ITEM)


def _not_ported(name: str) -> type:
    return type(name, (_NotPorted,), {"__module__": __name__})


DQN, DQNConfig = _not_ported("DQN"), _not_ported("DQNConfig")
SAC, SACConfig = _not_ported("SAC"), _not_ported("SACConfig")
CQL, CQLConfig = _not_ported("CQL"), _not_ported("CQLConfig")
BC, BCConfig = _not_ported("BC"), _not_ported("BCConfig")
MARWIL, MARWILConfig = _not_ported("MARWIL"), _not_ported("MARWILConfig")
EpisodeReplayBuffer = _not_ported("EpisodeReplayBuffer")
PrioritizedEpisodeReplayBuffer = _not_ported("PrioritizedEpisodeReplayBuffer")
