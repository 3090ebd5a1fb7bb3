"""Job submission and the session's files in the port (``job/``,
``util/state.py``, ``scripts/cli.py``): ``tests/test_ops_layer.py``'s
job lifecycle case on ray_tpu_torch, and the shapes it shares with
ray_tpu: ``JobInfo``'s fields, the ``_jobs`` KV record a restarted head
reads, and ``cluster_info.json``'s keys. Then the CLI: ``status`` and
``list`` from the session's ``state.json``, and the subcommands that
raise naming their ROADMAP.md items. Last, twins run on both packages:
``test_ops_layer.py``'s ``test_job_stop_and_failure`` and
``test_state_api_and_cli`` (ray_tpu's leg on a head of its own). Every
wait has its own bound."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.job import job_manager as jjm
from ray_tpu_torch.core import context
from ray_tpu_torch.job import job_manager as tjm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def rt(tmp_path_factory):
    """The module's head, its session under a temporary directory of its
    own (the CLI gets it as TMPDIR): the newest session is this head's."""
    import tempfile

    old = tempfile.tempdir
    tempfile.tempdir = str(tmp_path_factory.mktemp("sessions"))
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, _system_config={"state_dump_interval_s": 0.2})
    try:
        yield context.get_client()
    finally:
        ray_tpu_torch.shutdown()
        tempfile.tempdir = old


def test_job_submission_lifecycle(rt):
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient

    client = JobSubmissionClient()
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('hello from job'); import os; print(os.environ['GREETING'])\"",
        runtime_env={"env_vars": {"GREETING": "bonjour"}},
    )
    mgr = client._mgr
    assert mgr.wait_until_finished(job_id, timeout=60) == JobStatus.SUCCEEDED
    logs = client.get_job_logs(job_id)
    assert "hello from job" in logs and "bonjour" in logs
    assert client.get_job_info(job_id).returncode == 0
    # the log lives in the session's directory
    from ray_tpu_torch.util.state import session_dir

    assert client.get_job_info(job_id).log_path == os.path.join(session_dir(), "jobs", f"{job_id}.log")


def test_job_info_and_kv_record_have_ray_tpus_shape(rt):
    """JobInfo's fields and defaults, JobStatus's values, and the ``_jobs``
    record (key ``job::<id>``, the fields as a dict) equal ray_tpu's."""
    assert [(f.name, f.default) for f in dataclasses.fields(tjm.JobInfo) if f.default is not dataclasses.MISSING] == \
        [(f.name, f.default) for f in dataclasses.fields(jjm.JobInfo) if f.default is not dataclasses.MISSING]
    assert [f.name for f in dataclasses.fields(tjm.JobInfo)] == [f.name for f in dataclasses.fields(jjm.JobInfo)]
    assert (tjm.JobStatus.TERMINAL, tjm.JobStatus.PENDING, tjm.JobStatus.RUNNING) == \
        (jjm.JobStatus.TERMINAL, jjm.JobStatus.PENDING, jjm.JobStatus.RUNNING)
    mgr = tjm.JobManager(rt)
    jid = mgr.submit_job(entrypoint="echo shaped", submission_id="raysubmit_shape", metadata={"k": "v"})
    assert mgr.wait_until_finished(jid, timeout=60) == tjm.JobStatus.SUCCEEDED
    rec = rt.gcs.kv.get("job::raysubmit_shape", namespace="_jobs")
    assert rec == dataclasses.asdict(mgr.get_job_info(jid))
    assert set(rec) == {f.name for f in dataclasses.fields(jjm.JobInfo)}
    assert rec["status"] == "SUCCEEDED" and rec["returncode"] == 0 and rec["metadata"] == {"k": "v"}
    with pytest.raises(ValueError, match="already exists"):
        mgr.submit_job(entrypoint="echo again", submission_id="raysubmit_shape")


def test_cluster_info_has_ray_tpus_keys(rt):
    """Both heads in this process write cluster_info.json with the same
    keys (0600), so either package's `rt agent` reads the shape it knows."""
    from ray_tpu.util.state import session_dir as jsession_dir
    from ray_tpu_torch.util.state import load_latest_cluster_info, session_dir

    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=1)
    try:
        with open(os.path.join(jsession_dir(), "cluster_info.json")) as f:
            jinfo = json.load(f)
    finally:
        ray_tpu.shutdown()
    path = os.path.join(session_dir(), "cluster_info.json")
    with open(path) as f:
        tinfo = json.load(f)
    assert set(tinfo) == set(jinfo)
    assert os.stat(path).st_mode & 0o777 == 0o600
    assert tinfo["pid"] == os.getpid() and tuple(tinfo["agent_address"]) == rt._agent_listener.address
    assert load_latest_cluster_info() == tinfo


def _cli(*args):
    import tempfile

    return subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts.cli", *args], capture_output=True, text=True,
                          timeout=60, env={**os.environ, "PYTHONPATH": REPO, "TMPDIR": tempfile.gettempdir()},
                          cwd=REPO)


def test_cli_reads_the_sessions_state(rt):
    import time

    from ray_tpu_torch.util.state import session_dir

    deadline = time.monotonic() + 30
    while not os.path.exists(os.path.join(session_dir(), "state.json")):
        assert time.monotonic() < deadline, "the head never dumped state.json"
        time.sleep(0.1)
    p = _cli("status")
    assert p.returncode == 0 and f"session pid {os.getpid()}" in p.stdout and "CPU=2" in p.stdout, p.stderr
    p = _cli("list", "nodes")
    nodes = json.loads(p.stdout)
    assert [n["node_id"] for n in nodes] == [rt.node_id.hex()]
    assert _cli("summary", "actors").returncode == 0


@pytest.mark.parametrize("args,item", [(("lint",), "LINT_ITEM")])
def test_cli_not_ported_subcommands_name_their_items(args, item):
    from ray_tpu_torch.core import context as tctx

    p = _cli(*args)
    assert p.returncode != 0 and "NotImplementedError" in p.stderr and getattr(tctx, item) in p.stderr, p.stderr


# ---------------------------------------------------------------- twins on both packages
@pytest.fixture
def on(request, rt):
    """The parameter's package with a runtime up: the module's head for
    the port, a head of its own for ray_tpu."""
    pkg = request.param
    if pkg is ray_tpu_torch:
        yield pkg
        return
    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=2)
    try:
        yield pkg
    finally:
        ray_tpu.shutdown()


BOTH = pytest.mark.parametrize("on", [ray_tpu, ray_tpu_torch], indirect=True, ids=lambda p: p.__name__)


@BOTH
def test_job_stop_and_failure(on):
    """``tests/test_ops_layer.py::test_job_stop_and_failure``: a failing
    entrypoint ends FAILED with its exit code; a running one is stopped
    (``job_manager.py::stop_job``) and ends STOPPED."""
    import time

    if on is ray_tpu_torch:
        from ray_tpu_torch.job import JobStatus, JobSubmissionClient
    else:
        from ray_tpu.job import JobStatus, JobSubmissionClient
    client = JobSubmissionClient()
    bad = client.submit_job(entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
    assert client._mgr.wait_until_finished(bad, timeout=60) == JobStatus.FAILED
    assert client.get_job_info(bad).returncode == 3

    slow = client.submit_job(entrypoint=f"{sys.executable} -c 'import time; time.sleep(60)'")
    deadline = time.time() + 30
    while time.time() < deadline and client.get_job_status(slow) == JobStatus.PENDING:
        time.sleep(0.05)
    assert client.stop_job(slow)
    assert client._mgr.wait_until_finished(slow, timeout=30) == JobStatus.STOPPED
    assert not client.stop_job(slow)  # a terminal job is not stopped again
    assert len(client.list_jobs()) >= 2


@BOTH
def test_state_api_and_cli(on):
    """``tests/test_ops_layer.py::test_state_api_and_cli``: the state API's
    lists and summaries, a dumped snapshot read back, and the CLI's
    ``status`` (each package's banner)."""
    import torch_env_defs as defs

    if on is ray_tpu_torch:
        from ray_tpu_torch.util import state
    else:
        from ray_tpu.util import state
    assert on.get([on.remote(defs.one).remote() for _ in range(3)], timeout=60) == [1, 1, 1]
    nodes = state.list_nodes()
    assert nodes and all("node_id" in n for n in nodes)
    assert isinstance(state.summarize_tasks(), dict)
    st = state.cluster_status()
    assert st["cluster_resources"].get("CPU", 0) > 0

    path = state.dump_state()
    assert os.path.exists(path)
    snap = state.load_latest_state()
    assert snap is not None and snap["pid"] == os.getpid()

    # the CLI renders the snapshot
    if on is ray_tpu_torch:
        out = _cli("status")
    else:
        out = subprocess.run([sys.executable, "-m", "ray_tpu.scripts.cli", "status"], capture_output=True, text=True,
                             timeout=60, env={**os.environ, "PYTHONPATH": REPO}, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert f"{on.__name__} status" in out.stdout
    assert "Cluster resources" in out.stdout
