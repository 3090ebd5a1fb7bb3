"""Accelerator managers (port of ray_tpu/accelerators/): the card as a
resource the runtime schedules."""
