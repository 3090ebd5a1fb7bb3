"""Training step construction (port of ray_tpu/parallel, one device):
``ray_tpu_torch.parallel.train_step``."""
