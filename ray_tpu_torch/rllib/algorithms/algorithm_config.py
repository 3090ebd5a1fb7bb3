"""AlgorithmConfig builder (port of
ray_tpu/rllib/algorithms/algorithm_config.py): fluent
``.environment()/.env_runners()/.training()/.learners()`` chaining that
``build_algo()``s into an Algorithm.

The port adds one argument: ``learners(device=...)`` sets where every
learner runs (``None``, the default, is the card; ``"cpu"`` the host), as
the port's other entry points take ``device=``.
"""

from __future__ import annotations

import copy


class AlgorithmConfig:
    algo_class: type | None = None

    def __init__(self):
        # environment
        self.env: str | None = None
        self.env_config: dict = {}
        # env runners
        self.num_env_runners: int = 0
        self.num_envs_per_env_runner: int = 1
        self.rollout_fragment_length: int = 200
        # connector pipelines (rllib/connectors/)
        self.env_to_module_connector = None
        self.module_to_env_connector = None
        # learners
        self.num_learners: int = 0
        self.device: str | None = None  # None: the card
        # training
        self.lr: float = 5e-4
        self.gamma: float = 0.99
        self.train_batch_size: int = 4000
        self.minibatch_size: int | None = None
        self.num_epochs: int = 1
        self.grad_clip: float | None = None
        self.model: dict = {}
        # offline data
        self.output: str | None = None  # record sampled episodes to JSONL
        self.input_: str | None = None  # train from recorded episodes
        # rl module
        self.module_class: type | None = None
        # debugging
        self.seed: int = 0

    # -- fluent sections --
    def environment(self, env: str | None = None, *, env_config: dict | None = None):
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def env_runners(self, *, num_env_runners: int | None = None, num_envs_per_env_runner: int | None = None,
                    rollout_fragment_length: int | None = None, env_to_module_connector=None,
                    module_to_env_connector=None):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if env_to_module_connector is not None:
            self.env_to_module_connector = env_to_module_connector
        if module_to_env_connector is not None:
            self.module_to_env_connector = module_to_env_connector
        return self

    def learners(self, *, num_learners: int | None = None, device: str | None = None):
        """``device``: where every learner runs ("cpu"; the card when
        never set)."""
        if num_learners is not None:
            self.num_learners = num_learners
        if device is not None:
            self.device = device
        return self

    def training(self, **kwargs):
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def offline_data(self, *, input_: str | None = None, output: str | None = None):
        if input_ is not None:
            self.input_ = input_
        if output is not None:
            self.output = output
        return self

    def rl_module(self, *, module_class: type | None = None, model_config: dict | None = None):
        if module_class is not None:
            self.module_class = module_class
        if model_config is not None:
            self.model = dict(model_config)
        return self

    def debugging(self, *, seed: int | None = None):
        if seed is not None:
            self.seed = seed
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def build_algo(self):
        if self.algo_class is None:
            raise ValueError("use a concrete config (PPOConfig, IMPALAConfig, APPOConfig, DQNConfig, SACConfig, ...)")
        return self.algo_class(self.copy())

    build = build_algo  # the reference's spelling
