"""Serve on the port's runtime (``ray_tpu_torch.serve``) against ray_tpu's
Serve, on the CPU: every case of ``tests/test_serve.py`` but the HTTP one
(``test_torch_serve_proxy.py`` runs it), each run on both runtimes with
the same results and error types: deploy and call, a function deployment,
init args and ``user_config``, replicas spreading load, handle injection,
redeploy, delete, autoscaling up and down, replica crash recovery.
``test_torch_serve_v2.py`` runs ``tests/test_serve_v2.py``'s cases with
this module's fixtures and helpers.

Then the port's own rules: ``@serve.deployment`` on a class or function
of an importable module deploys; a closure, a lambda or a class of a
file-less ``__main__`` raises TypeError at ``serve.run``.

One runtime of each package for the module (8 CPUs, one logical card);
each test deletes its apps and waits for their replicas to go. The deployments live
in ``tests/torch_serve_defs.py``. Every result and get carries a timeout."""

import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch_serve_defs as defs

import ray_tpu
import ray_tpu.serve as jserve
import ray_tpu_torch
import ray_tpu_torch.serve as tserve
from ray_tpu import exceptions as jexc
from ray_tpu_torch import exceptions as texc

T = 60
PKGS = (ray_tpu, ray_tpu_torch)
SERVE = {ray_tpu: jserve, ray_tpu_torch: tserve}
EXC = {ray_tpu: jexc, ray_tpu_torch: texc}
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def both():
    for pkg in PKGS:
        SERVE[pkg].shutdown()
        pkg.shutdown()
    ray_tpu.init(num_cpus=8, num_tpus=1)
    ray_tpu_torch.init(num_cpus=8, num_gpus=1)
    yield
    for pkg in PKGS:
        SERVE[pkg].shutdown()
        pkg.shutdown()


def teardown_apps(pkg):
    """Delete every app of ``pkg``'s Serve and wait until its replicas are
    gone and their CPUs back (the controller stays: ray_tpu keeps a killed
    named actor's name, so a module-scoped runtime keeps one controller)."""
    serve = SERVE[pkg]
    for name in list(serve.status()["applications"]):
        serve.delete(name)
    assert wait_until(lambda: not serve.status()["applications"], timeout_s=15)
    assert wait_until(lambda: pkg.available_resources().get("CPU", 0) == 8, timeout_s=30)


@pytest.fixture
def serve_both(both):
    yield
    for pkg in PKGS:
        teardown_apps(pkg)


def same(fn):
    """``fn`` on each runtime, the two at once (each in its own thread):
    their results must be equal. Returns ray_tpu's."""
    with ThreadPoolExecutor(2) as pool:
        a, b = (f.result(timeout=300) for f in [pool.submit(fn, pkg) for pkg in PKGS])
    assert a == b, (a, b)
    return a


def dep(pkg, target, **opts):
    d = SERVE[pkg].deployment(target)
    return d.options(**opts) if opts else d


def wait_until(cond, timeout_s: float = 20.0, every_s: float = 0.1) -> bool:
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(every_s)
    return cond()


# ---------------------------------------------------------------- test_serve.py
def test_deploy_and_call(serve_both):
    def case(pkg):
        serve = SERVE[pkg]
        h = serve.run(dep(pkg, defs.Echo).bind(), name="echo_app")
        return (h.remote(41).result(timeout_s=T), h.shout.remote("hi").result(timeout_s=T),
                serve.status()["applications"]["echo_app"]["status"])

    assert same(case) == (("echo", 41), "HI", "RUNNING")


def test_function_deployment(serve_both):
    assert same(lambda pkg: SERVE[pkg].run(dep(pkg, defs.double).bind(), name="fn_app").remote(21)
                .result(timeout_s=T)) == 42


def test_init_args_and_user_config(serve_both):
    def case(pkg):
        d = dep(pkg, defs.Greeter).options(user_config={"suffix": "!"})
        return SERVE[pkg].run(d.bind("hello"), name="greet").remote("tpu").result(timeout_s=T)

    assert same(case) == "hello, tpu!"


def test_multiple_replicas_spread_load(serve_both):
    def case(pkg):
        h = SERVE[pkg].run(dep(pkg, defs.WhoAmI, num_replicas=3, max_ongoing_requests=2).bind(), name="who")
        refs = [h.remote() for _ in range(12)]
        return len({r.result(timeout_s=T) for r in refs}) >= 2

    assert same(case)


def test_composition_handle_injection(serve_both):
    def case(pkg):
        app = dep(pkg, defs.Pipeline).bind(dep(pkg, defs.Adder).bind(5))
        return SERVE[pkg].run(app, name="pipe").remote(1).result(timeout_s=T)

    assert same(case) == 60


def test_redeploy_updates_code(serve_both):
    def case(pkg):
        serve = SERVE[pkg]
        first = serve.run(dep(pkg, defs.V).bind(), name="ver").remote().result(timeout_s=T)
        h = serve.run(dep(pkg, defs.V2, name="V").bind(), name="ver")
        wait_until(lambda: h.remote().result(timeout_s=T) == 2, timeout_s=10)
        return first, h.remote().result(timeout_s=T)

    assert same(case) == (1, 2)


def test_delete_application(serve_both):
    def case(pkg):
        serve = SERVE[pkg]
        serve.run(dep(pkg, defs.ok).bind(), name="delme")
        serve.delete("delme")
        wait_until(lambda: serve.status()["applications"].get("delme") is None, timeout_s=10)
        return "delme" in serve.status()["applications"]

    assert same(case) is False


def test_autoscaling_up_and_down(serve_both):
    def case(pkg):
        serve = SERVE[pkg]
        d = dep(pkg, defs.SlowAuto, max_ongoing_requests=1, autoscaling_config=serve.AutoscalingConfig(
            min_replicas=1, max_replicas=4, target_ongoing_requests=1.0, upscale_delay_s=0.0, downscale_delay_s=0.5,
            metrics_interval_s=0.1, look_back_period_s=0.4))
        h = serve.run(d.bind(), name="auto")
        controller = pkg.get_actor("SERVE_CONTROLLER")

        def target():
            return pkg.get(controller.get_deployment_status.remote("auto", "SlowAuto"), timeout=T)["target_replicas"]

        start = target()
        refs = [h.remote() for _ in range(8)]  # 8 concurrent requests against target_ongoing 1
        scaled = [start]
        wait_until(lambda: scaled.append(target()) or max(scaled) >= 3, timeout_s=20, every_s=0.05)
        done = [r.result(timeout_s=30) for r in refs]
        down = wait_until(lambda: target() == 1, timeout_s=20)
        return start, max(scaled) >= 3, done, down

    assert same(case) == (1, True, ["done"] * 8, True)


def test_replica_crash_recovery(serve_both):
    def case(pkg):
        h = SERVE[pkg].run(dep(pkg, defs.Fragile, num_replicas=1).bind(), name="fragile")
        pid0 = h.pid.remote().result(timeout_s=T)
        with pytest.raises(Exception) as ei:
            h.die.remote().result(timeout_s=5)
        err = type(ei.value).__name__

        def replaced():
            try:
                return h.pid.remote().result(timeout_s=5) != pid0
            except Exception:  # noqa: BLE001 — the dead replica is still in the handle's view
                return False

        return err, wait_until(replaced, timeout_s=30, every_s=0.2), h.remote().result(timeout_s=T)

    assert same(case)[1:] == (True, "alive")


# ---------------------------------------------------------------- the port's own rules
def test_decorated_module_level_class_and_function_deploy(serve_both):
    h = tserve.run(defs.Decorated.bind(), name="decorated")
    tag, x, pid = h.remote(7).result(timeout_s=T)
    assert (tag, x) == ("decorated", 7) and pid != os.getpid()
    assert tserve.run(defs.decorated_fn.bind(), name="decorated_fn").remote(1).result(timeout_s=T) == 2
    assert isinstance(defs.Decorated, tserve.Deployment)  # the module's name is the Deployment


def test_closure_and_lambda_raise_type_error_at_run(serve_both):
    class Local:
        def __call__(self):
            return 1

    for target, what in ((Local, "closure"), (lambda: 1, "lambda")):
        with pytest.raises(TypeError, match=what):
            tserve.run(tserve.deployment(target).bind(), name="local")
    assert "local" not in tserve.status()["applications"]  # refused before anything was deployed
    # ray_tpu ships code by value: the closure deploys there
    assert jserve.run(jserve.deployment(Local).bind(), name="local").remote().result(timeout_s=T) == 1


def test_fileless_main_raises_type_error_at_run():
    """A class of a ``__main__`` with no file (a ``-c`` driver) raises
    TypeError at serve.run, naming the difference, before a runtime
    starts."""
    code = ("import ray_tpu_torch\nfrom ray_tpu_torch import serve\n"
            "class Here:\n    def __call__(self):\n        return 1\n"
            "try:\n    serve.run(serve.deployment(Here).bind())\n"
            "except TypeError as e:\n    print('TypeError', e, ray_tpu_torch.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=str(REPO), env={**os.environ, "PYTHONPATH": str(REPO)})
    # raised before anything started: no runtime came up
    assert "TypeError" in out.stdout and "no file" in out.stdout and out.stdout.strip().endswith("False"), (
        out.stdout + out.stderr)
