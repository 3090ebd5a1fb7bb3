"""Job submission (port of ray_tpu/job/job_manager.py): driver
entrypoints run as supervised subprocesses of the head.

A job is a shell command run by a supervisor thread of the submitting
process, with its output in ``<session dir>/jobs/<job id>.log`` and its
``JobInfo`` mirrored into the GCS KV (namespace ``_jobs``, key
``job::<id>``, the fields as a dict: ray_tpu's shape), so a restarted head
on a persistent GCS still lists it. The entrypoint gets
``RT_HEAD_ADDRESS`` and ``RT_HEAD_AUTHKEY`` from the session's
``cluster_info.json``: a plain ``ray_tpu_torch.init()`` there attaches to
this cluster. ``runtime_env``'s ``env_vars`` are the job's environment.

    client = JobSubmissionClient()          # in a driver after init()
    job_id = client.submit_job(entrypoint="python train.py",
                               runtime_env={"env_vars": {...}})
    client.get_job_status(job_id)           # PENDING, RUNNING, SUCCEEDED, ...
    client.get_job_logs(job_id)
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field

def _session_dir() -> str:
    from ray_tpu_torch.util.state import session_dir

    d = session_dir()
    os.makedirs(os.path.join(d, "jobs"), exist_ok=True)
    return d


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@dataclass
class JobInfo:
    job_id: str
    entrypoint: str
    status: str = JobStatus.PENDING
    submission_time: float = field(default_factory=time.time)
    start_time: float | None = None
    end_time: float | None = None
    returncode: int | None = None
    message: str = ""
    metadata: dict = field(default_factory=dict)
    log_path: str = ""


class JobManager:
    """Supervises driver subprocesses; their state mirrors into the GCS KV."""

    def __init__(self, client=None):
        from ray_tpu_torch.core import context

        self._client = client or context.get_client()
        self._jobs: dict[str, JobInfo] = {}
        self._procs: dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def _kv_put(self, info: JobInfo):
        try:
            self._client.kv("put", key=f"job::{info.job_id}", value=asdict(info), namespace="_jobs")
        except (ConnectionError, OSError, RuntimeError):
            pass  # the head is gone: the job goes on, unmirrored

    def submit_job(
        self,
        *,
        entrypoint: str,
        runtime_env: dict | None = None,
        submission_id: str | None = None,
        metadata: dict | None = None,
    ) -> str:
        job_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:16]}"
        log_path = os.path.join(_session_dir(), "jobs", f"{job_id}.log")
        info = JobInfo(job_id=job_id, entrypoint=entrypoint, metadata=metadata or {}, log_path=log_path)
        with self._lock:
            if job_id in self._jobs:
                raise ValueError(f"job {job_id} already exists")
            self._jobs[job_id] = info
        self._kv_put(info)

        env = dict(os.environ)
        renv = runtime_env or {}
        env.update({str(k): str(v) for k, v in (renv.get("env_vars") or {}).items()})
        env["RT_JOB_SUBMISSION_ID"] = job_id
        # the attach credentials: the entrypoint's plain init() joins this
        # cluster as a driver instead of starting a head of its own
        try:
            import json as _json

            with open(os.path.join(_session_dir(), "cluster_info.json")) as f:
                ci = _json.load(f)
            env["RT_HEAD_ADDRESS"] = f"{ci['agent_address'][0]}:{ci['agent_address'][1]}"
            env["RT_HEAD_AUTHKEY"] = ci["authkey"]
        except (OSError, ValueError, KeyError):
            pass  # local_mode (no listener): the job runs self-contained
        cwd = renv.get("working_dir") if renv.get("working_dir") and os.path.isdir(renv["working_dir"]) else None

        def run():
            logf = open(log_path, "wb")
            try:
                proc = subprocess.Popen(
                    entrypoint,
                    shell=True,
                    stdout=logf,
                    stderr=subprocess.STDOUT,
                    env=env,
                    cwd=cwd,
                    start_new_session=True,  # stop_job kills the whole group
                )
            except OSError as e:
                with self._lock:
                    info.status = JobStatus.FAILED
                    info.end_time = time.time()
                    info.message = f"failed to launch: {e}"
                self._kv_put(info)
                logf.close()
                return
            with self._lock:
                self._procs[job_id] = proc
                info.status = JobStatus.RUNNING
                info.start_time = time.time()
            self._kv_put(info)
            rc = proc.wait()
            logf.close()
            with self._lock:
                info.returncode = rc
                info.end_time = time.time()
                if info.status != JobStatus.STOPPED:
                    info.status = JobStatus.SUCCEEDED if rc == 0 else JobStatus.FAILED
                    info.message = "" if rc == 0 else f"driver exited with code {rc}"
                self._procs.pop(job_id, None)
            self._kv_put(info)

        threading.Thread(target=run, daemon=True, name=f"rt-job-{job_id[:18]}").start()
        return job_id

    def stop_job(self, job_id: str) -> bool:
        import signal

        with self._lock:
            info = self._jobs.get(job_id)
            proc = self._procs.get(job_id)
            if info is None or proc is None or info.status in JobStatus.TERMINAL:
                return False
            info.status = JobStatus.STOPPED
            info.message = "stopped by user"
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
        except OSError:
            proc.terminate()
        self._kv_put(info)
        return True

    def get_job_info(self, job_id: str) -> JobInfo:
        with self._lock:
            info = self._jobs.get(job_id)
        if info is None:
            raise ValueError(f"no such job {job_id}")
        return info

    def get_job_status(self, job_id: str) -> str:
        return self.get_job_info(job_id).status

    def get_job_logs(self, job_id: str) -> str:
        info = self.get_job_info(job_id)
        try:
            with open(info.log_path, "rb") as f:
                return f.read().decode(errors="replace")
        except FileNotFoundError:
            return ""

    def tail_job_logs(self, job_id: str, poll_s: float = 0.2):
        """Generator of log chunks until the job reaches a terminal state."""
        info = self.get_job_info(job_id)
        pos = 0
        while True:
            try:
                with open(info.log_path, "rb") as f:
                    f.seek(pos)
                    chunk = f.read()
                    pos = f.tell()
            except FileNotFoundError:
                chunk = b""
            if chunk:
                yield chunk.decode(errors="replace")
            if info.status in JobStatus.TERMINAL:
                return
            time.sleep(poll_s)

    def list_jobs(self) -> list[JobInfo]:
        with self._lock:
            return list(self._jobs.values())

    def wait_until_finished(self, job_id: str, timeout: float | None = None) -> str:
        deadline = None if timeout is None else time.time() + timeout
        while True:
            st = self.get_job_status(job_id)
            if st in JobStatus.TERMINAL:
                return st
            if deadline is not None and time.time() > deadline:
                raise TimeoutError(f"job {job_id} still {st}")
            time.sleep(0.1)


_default_manager: JobManager | None = None


class JobSubmissionClient:
    """ray_tpu's JobSubmissionClient: one manager per process, over this
    process's current client (a new one after a re-init)."""

    def __init__(self, address: str | None = None):
        global _default_manager
        from ray_tpu_torch.core import context

        if _default_manager is None or _default_manager._client is not context.get_client():
            _default_manager = JobManager()
        self._mgr = _default_manager

    def submit_job(self, **kw) -> str:
        return self._mgr.submit_job(**kw)

    def stop_job(self, job_id: str) -> bool:
        return self._mgr.stop_job(job_id)

    def get_job_status(self, job_id: str) -> str:
        return self._mgr.get_job_status(job_id)

    def get_job_info(self, job_id: str) -> JobInfo:
        return self._mgr.get_job_info(job_id)

    def get_job_logs(self, job_id: str) -> str:
        return self._mgr.get_job_logs(job_id)

    def tail_job_logs(self, job_id: str):
        return self._mgr.tail_job_logs(job_id)

    def list_jobs(self) -> list[JobInfo]:
        return self._mgr.list_jobs()
