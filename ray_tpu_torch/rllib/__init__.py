"""ray_tpu_torch.rllib: reinforcement learning over the port's runtime
(port of ray_tpu/rllib/, whole).

An Algorithm over an EnvRunnerGroup of CPU rollout runners and a
LearnerGroup of learners on the card (``torch.nn.Module`` policies,
``torch.optim.Adam``); several learners average their gradients through
the port's collective API. On-policy: PPO, IMPALA and APPO. Off-policy
and offline: DQN (uniform or prioritized replay, double Q), SAC, and CQL,
BC and MARWIL over recorded episode datasets (``offline_data(input_=...)``).
Also the modules, distributions, learners, env runners, multi-agent
runners, connectors, episodes, the replay buffers and the JSONL episode
writer and reader.
"""

from ray_tpu_torch.util.usage import record_library_usage as _rlu

_rlu("rllib")

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm  # noqa: E402, F401
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig  # noqa: E402, F401
from ray_tpu_torch.rllib.algorithms.appo.appo import APPO, APPOConfig  # noqa: E402, F401
from ray_tpu_torch.rllib.algorithms.bc.bc import BC, BCConfig  # noqa: E402, F401
from ray_tpu_torch.rllib.algorithms.cql.cql import CQL, CQLConfig  # noqa: E402, F401
from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQN, DQNConfig  # noqa: E402, F401
from ray_tpu_torch.rllib.algorithms.impala.impala import IMPALA, IMPALAConfig  # noqa: E402, F401
from ray_tpu_torch.rllib.algorithms.marwil.marwil import MARWIL, MARWILConfig  # noqa: E402, F401
from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig  # noqa: E402, F401
from ray_tpu_torch.rllib.algorithms.sac.sac import SAC, SACConfig  # noqa: E402, F401
from ray_tpu_torch.rllib.connectors import ConnectorPipeline, ConnectorV2  # noqa: E402, F401
from ray_tpu_torch.rllib.core.rl_module import MLPModule, RLModule, RLModuleSpec  # noqa: E402, F401
from ray_tpu_torch.rllib.env.multi_agent import MultiAgentEnv, MultiAgentEnvRunner  # noqa: E402, F401
from ray_tpu_torch.rllib.utils.replay_buffers import (  # noqa: E402, F401
    EpisodeReplayBuffer,
    PrioritizedEpisodeReplayBuffer,
)
