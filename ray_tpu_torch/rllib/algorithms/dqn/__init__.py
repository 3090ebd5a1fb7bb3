from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQN, DQNConfig, DQNLearner, EpsilonGreedy, QModule

__all__ = ["DQN", "DQNConfig", "DQNLearner", "EpsilonGreedy", "QModule"]
