"""Usage stats in the port (``util/usage.py``, the report ``shutdown()``
writes): the three cases of ``tests/test_usage.py`` on both packages, the
reports' keys held equal, and the port's rule that an attached driver's
shutdown writes no report (ray_tpu's ``api.py`` rule, which its tests do
not exercise)."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

import ray_tpu
import ray_tpu_torch

PKGS = (ray_tpu, ray_tpu_torch)
ids = {"ids": lambda p: p.__name__}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _usage(pkg):
    if pkg is ray_tpu_torch:
        from ray_tpu_torch.util import usage
    else:
        from ray_tpu.util import usage
    return usage


def _session_dir(pkg):
    if pkg is ray_tpu_torch:
        from ray_tpu_torch.util.state import session_dir
    else:
        from ray_tpu.util.state import session_dir
    return session_dir()


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_disabled_by_default(pkg, monkeypatch, tmp_path):
    usage = _usage(pkg)
    monkeypatch.delenv("RT_USAGE_STATS_ENABLED", raising=False)
    assert not usage.usage_stats_enabled()
    assert usage.write_usage_stats(path=str(tmp_path / "u.json")) is None
    assert not (tmp_path / "u.json").exists()


def test_report_schema_and_library_markers(monkeypatch, tmp_path):
    import ray_tpu.data  # noqa: F401 — registers the "data" marker
    import ray_tpu.tune  # noqa: F401
    import ray_tpu_torch.data  # noqa: F401
    import ray_tpu_torch.tune  # noqa: F401

    monkeypatch.setenv("RT_USAGE_STATS_ENABLED", "1")
    reports = {}
    for pkg in PKGS:
        usage = _usage(pkg)
        usage.record_extra_usage_tag("test_tag", "42")
        out = usage.write_usage_stats(path=str(tmp_path / f"{pkg.__name__}.json"))
        with open(out) as f:
            data = reports[pkg] = json.load(f)
        assert data["schema_version"]
        assert data["source"] == "LOCAL"
        assert "data" in data["library_usages"] and "tune" in data["library_usages"]
        assert data["extra_usage_tags"]["test_tag"] == "42"
        assert data["python_version"].count(".") == 2
    assert set(reports[ray_tpu]) == set(reports[ray_tpu_torch])


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_shutdown_writes_report_with_cluster_shape(pkg, monkeypatch):
    monkeypatch.setenv("RT_USAGE_STATS_ENABLED", "1")
    pkg.shutdown()
    pkg.init(num_cpus=2)
    path = os.path.join(_session_dir(pkg), "usage_stats.json")
    if os.path.exists(path):
        os.unlink(path)  # an earlier head of this process (same pid, same session)
    pkg.shutdown()
    assert os.path.exists(path)
    with open(path) as f:
        data = json.load(f)
    assert data["total_num_cpus"] == 2
    assert data["total_num_nodes"] >= 1


def test_attached_driver_writes_no_report(monkeypatch, tmp_path):
    """A driver attached to the head (``init(address="auto")``, another
    process) shuts down without a report; the head's own shutdown writes
    one. The session lives under a temporary directory of its own, which
    the driver gets as TMPDIR."""
    import tempfile

    monkeypatch.setenv("RT_USAGE_STATS_ENABLED", "1")
    old = tempfile.tempdir
    tempfile.tempdir = str(tmp_path)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=1)
    try:
        path = os.path.join(_session_dir(ray_tpu_torch), "usage_stats.json")
        script = tmp_path / "drv.py"
        script.write_text(textwrap.dedent("""
            import ray_tpu_torch

            if __name__ == "__main__":
                ray_tpu_torch.init(address="auto")
                assert ray_tpu_torch.cluster_resources().get("CPU") == 1.0
                ray_tpu_torch.shutdown()
                print("DETACHED")
        """))
        env = {**os.environ, "TMPDIR": str(tmp_path), "PYTHONPATH": REPO}
        out = subprocess.run([sys.executable, str(script)], env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0 and "DETACHED" in out.stdout, out.stderr[-3000:]
        assert not os.path.exists(path)
    finally:
        ray_tpu_torch.shutdown()
        tempfile.tempdir = old
    assert os.path.exists(path)
