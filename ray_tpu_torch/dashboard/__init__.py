from ray_tpu_torch.dashboard.dashboard import Dashboard, start_dashboard

__all__ = ["Dashboard", "start_dashboard"]
