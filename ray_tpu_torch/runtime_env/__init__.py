from ray_tpu_torch.runtime_env.packaging import apply_runtime_env_in_worker, prepare_runtime_env

__all__ = ["apply_runtime_env_in_worker", "prepare_runtime_env"]
