from ray_tpu_torch.rllib.core.distributions import Categorical, DiagGaussian  # noqa: F401
from ray_tpu_torch.rllib.core.learner import Learner, LearnerGroup  # noqa: F401
from ray_tpu_torch.rllib.core.rl_module import MLPModule, RLModule, RLModuleSpec, params_from_jax  # noqa: F401
