from ray_tpu_torch.rllib.env.env_runner import EnvRunnerGroup, SingleAgentEnvRunner  # noqa: F401
from ray_tpu_torch.rllib.env.episode import Episode  # noqa: F401
