from ray_tpu_torch.rllib.algorithms.bc.bc import BC, BCConfig, BCLearner

__all__ = ["BC", "BCConfig", "BCLearner"]
