"""Attached drivers in the port (``core/driver_client.py``,
``init(address=...)``, ``RT_HEAD_ADDRESS``): the cases of
``tests/test_driver_attach.py`` on ray_tpu_torch, and the refusals it
keeps from ray_tpu (sizing arguments with an address, a wrong authkey, a
head on another host).

A driver that defines remote code is a script file (code travels by
reference: a worker imports the attached driver's script, not the
head's); the others run with ``-c``. Every wait has its own bound."""

import os
import subprocess
import sys
import textwrap
import time

import pytest
import torch_cluster_defs as defs

import ray_tpu_torch
from ray_tpu_torch.core import context

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
T = 60


@pytest.fixture(scope="module")
def head(tmp_path_factory):
    """The module's head, its session under a temporary directory of its own
    (the drivers get it as TMPDIR): ``address="auto"`` finds this head, not
    another test process's."""
    import tempfile

    old = tempfile.tempdir
    tempfile.tempdir = str(tmp_path_factory.mktemp("sessions"))
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    try:
        yield context.get_client()
    finally:
        ray_tpu_torch.shutdown()
        tempfile.tempdir = old


def _env(extra: dict | None = None) -> dict:
    import tempfile

    env = {k: v for k, v in os.environ.items() if k not in ("RT_HEAD_ADDRESS", "RT_HEAD_AUTHKEY")}
    env["PYTHONPATH"] = os.pathsep.join([REPO, TESTS])
    env["TMPDIR"] = tempfile.gettempdir()
    env.update(extra or {})
    return env


def _run_driver(tmp_path, script: str, extra_env: dict | None = None, timeout: float = 180.0, file: bool = True):
    code = textwrap.dedent(script)
    if file:
        path = tmp_path / f"drv_{time.monotonic_ns()}.py"
        path.write_text(code)
        cmd = [sys.executable, str(path)]
    else:
        cmd = [sys.executable, "-c", code]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=_env(extra_env))


def test_external_driver_tasks_objects_and_named_actors(head, tmp_path):
    c = ray_tpu_torch.remote(defs.Counter).options(name="shared_counter", namespace="default").remote()
    assert ray_tpu_torch.get(c.add.remote(5), timeout=T) == 5
    p = _run_driver(tmp_path, """
        import numpy as np
        import ray_tpu_torch


        @ray_tpu_torch.remote
        def f(x):
            return x * 2


        if __name__ == "__main__":
            ray_tpu_torch.init(address="auto")
            r = ray_tpu_torch.put(np.arange(100))
            assert ray_tpu_torch.get(r, timeout=60).sum() == 4950
            big = ray_tpu_torch.put(np.ones(1_000_000))  # through the head's shared memory
            assert ray_tpu_torch.get(big, timeout=60).sum() == 1_000_000
            assert ray_tpu_torch.get(f.remote(21), timeout=60) == 42
            c = ray_tpu_torch.get_actor("shared_counter", namespace="default")
            print("ATTACH_RESULT", ray_tpu_torch.get(c.add.remote(7), timeout=60))
            ray_tpu_torch.shutdown()
        """)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "ATTACH_RESULT 12" in p.stdout
    # the head's actor changed, not a private copy
    assert ray_tpu_torch.get(c.add.remote(1), timeout=T) == 13
    ray_tpu_torch.kill(c)


def test_driver_attach_requires_authkey(head, tmp_path):
    """A dialer without the session's authkey is rejected at the listener's
    handshake, the gate agents pass too."""
    from ray_tpu_torch.util.state import load_latest_cluster_info

    info = load_latest_cluster_info()
    assert info is not None and info["pid"] == os.getpid()
    host, port = info["agent_address"]
    p = _run_driver(tmp_path, f"""
        from multiprocessing import connection
        try:
            conn = connection.Client(("{host}", {port}), "AF_INET", authkey=b"wrong-key-000000")
            print("CONNECTED")  # must not happen
        except Exception as e:
            print("REJECTED", type(e).__name__)
        """, timeout=60, file=False)
    assert "REJECTED" in p.stdout and "CONNECTED" not in p.stdout


def test_submitted_job_runs_against_shared_cluster(head):
    """The job manager exports RT_HEAD_ADDRESS, so a plain init() in the
    entrypoint attaches instead of starting a head of its own."""
    from ray_tpu_torch.job import JobSubmissionClient

    b = ray_tpu_torch.remote(defs.Board).options(name="board", namespace="default").remote()
    ray_tpu_torch.get(b.set.remote("empty"), timeout=T)
    client = JobSubmissionClient()
    ep = (f"{sys.executable} -c \""
          "import ray_tpu_torch; ray_tpu_torch.init(); "
          "b = ray_tpu_torch.get_actor('board', namespace='default'); "
          "ray_tpu_torch.get(b.set.remote('written-by-job'), timeout=60); ray_tpu_torch.shutdown()\"")
    job_id = client.submit_job(entrypoint=ep, runtime_env={"env_vars": {"PYTHONPATH": REPO}})
    status = client._mgr.wait_until_finished(job_id, timeout=120)
    assert status == "SUCCEEDED", client.get_job_logs(job_id)[-2000:]
    assert ray_tpu_torch.get(b.get.remote(), timeout=T) == "written-by-job"
    ray_tpu_torch.kill(b)


def test_driver_disconnect_drops_ref_holder(head, tmp_path):
    """A driver that exits holding the only reference leaves no holder
    entry behind: the head drops it as a dead worker's."""
    before = len(head._drivers)
    p = _run_driver(tmp_path, """
        import os, sys
        import ray_tpu_torch
        ray_tpu_torch.init(address="auto")
        r = ray_tpu_torch.put(b"x" * 1024)
        print("PUT_OK", r.id.hex())
        sys.stdout.flush()
        os._exit(0)  # no shutdown: the pump's end of file cleans up
        """, file=False)
    assert "PUT_OK" in p.stdout, p.stderr[-1500:]
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and len(head._drivers) > before:
        time.sleep(0.2)
    assert len(head._drivers) == before


def test_head_shutdown_fails_driver_calls_fast(head, tmp_path):
    """With the link to the head gone, a blocked or later driver call
    raises instead of hanging."""
    p = _run_driver(tmp_path, """
        import time
        import ray_tpu_torch
        import torch_cluster_defs as defs

        if __name__ == "__main__":
            client = ray_tpu_torch.init(address="auto")
            s = ray_tpu_torch.remote(defs.Sleeper).remote()
            ref = s.nap.remote(60)
            time.sleep(1)
            client.conn.close()  # the link is cut (the head's death, for this driver)
            try:
                ray_tpu_torch.get(ref, timeout=30)
                print("NO_ERROR")
            except Exception as e:
                print("FAILED_FAST", type(e).__name__)
        """, timeout=120)
    assert "FAILED_FAST ConnectionError" in p.stdout, (p.stdout, p.stderr[-1500:])


def test_env_attach_yields_to_explicit_sizing(head, tmp_path):
    """An entrypoint that asks for a runtime of its own (sizing arguments)
    gets one, though RT_HEAD_ADDRESS is exported."""
    p = _run_driver(tmp_path, """
        import ray_tpu_torch
        client = ray_tpu_torch.init(num_cpus=1)
        from ray_tpu_torch.core.runtime import Runtime
        assert isinstance(client, Runtime), type(client)
        ray_tpu_torch.shutdown()
        print("OWN_RUNTIME_OK")
        """, extra_env={"RT_HEAD_ADDRESS": "127.0.0.1:1"}, file=False)  # would fail if dialed
    assert "OWN_RUNTIME_OK" in p.stdout, p.stderr[-1500:]


def test_attach_from_another_host_is_refused(head, tmp_path):
    """The head's objects live in its host's shared memory: a driver whose
    host name differs is refused, naming the job and agent paths."""
    p = _run_driver(tmp_path, """
        import socket
        socket.gethostname = lambda: "another-host"
        import ray_tpu_torch
        try:
            ray_tpu_torch.init(address="auto")
            print("ATTACHED")
        except ConnectionError as e:
            print("REFUSED", e)
        """, file=False)
    assert "REFUSED" in p.stdout and "ATTACHED" not in p.stdout and "rt agent" in p.stdout, (p.stdout,
                                                                                             p.stderr[-1500:])


def test_attach_rejects_resource_args():
    """Last in the file: it stops the module's head first."""
    ray_tpu_torch.shutdown()
    with pytest.raises(ValueError, match="attaches to an existing cluster"):
        ray_tpu_torch.init(address="auto", num_cpus=2)
