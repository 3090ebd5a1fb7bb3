from ray_tpu_torch.rllib.algorithms.marwil.marwil import MARWIL, MARWILConfig, MARWILLearner, returns_to_go

__all__ = ["MARWIL", "MARWILConfig", "MARWILLearner", "returns_to_go"]
