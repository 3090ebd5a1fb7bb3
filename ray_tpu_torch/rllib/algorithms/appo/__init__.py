from ray_tpu_torch.rllib.algorithms.appo.appo import APPO, APPOConfig, APPOLearner

__all__ = ["APPO", "APPOConfig", "APPOLearner"]
