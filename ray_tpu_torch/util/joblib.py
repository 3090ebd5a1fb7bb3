"""joblib backend over ray_tpu_torch (port of ray_tpu/util/joblib.py;
reference: ray/util/joblib/__init__.py — register_ray() so sklearn's
n_jobs parallelism fans out to the cluster). ``joblib`` is imported when
``register_ray()`` runs; ImportError where it is absent.

    from ray_tpu_torch.util.joblib import register_ray
    register_ray()
    with joblib.parallel_backend("ray_tpu_torch"):
        ...
"""

from __future__ import annotations


def register_ray():
    from joblib import register_parallel_backend
    from joblib._parallel_backends import MultiprocessingBackend

    import ray_tpu_torch

    class RayTpuBackend(MultiprocessingBackend):
        supports_timeout = True

        def configure(self, n_jobs=1, parallel=None, prefer=None, require=None, **kw):
            n_jobs = self.effective_n_jobs(n_jobs)
            self.parallel = parallel
            from ray_tpu_torch.util.multiprocessing import Pool

            self._pool = Pool(processes=n_jobs)
            return n_jobs

        def effective_n_jobs(self, n_jobs):
            if n_jobs == 0:
                raise ValueError("n_jobs == 0 has no meaning")
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init()
            cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
            return cpus if n_jobs is None or n_jobs < 0 else n_jobs

        def terminate(self):
            if getattr(self, "_pool", None) is not None:
                self._pool.terminate()

    register_parallel_backend("ray_tpu_torch", RayTpuBackend)
