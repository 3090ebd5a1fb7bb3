"""Job submission (port of ray_tpu/job/)."""

from ray_tpu_torch.job.job_manager import JobInfo, JobManager, JobStatus, JobSubmissionClient

__all__ = ["JobInfo", "JobManager", "JobStatus", "JobSubmissionClient"]
