from ray_tpu_torch.rllib.algorithms.impala.impala import IMPALA, IMPALAConfig, IMPALALearner, vtrace  # noqa: F401
