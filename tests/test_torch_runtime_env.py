"""runtime_env in the port (``ray_tpu_torch/runtime_env/``, the head's
packing and the workers' binding in ``core/runtime.py``, the setup in
``core/worker_main.py``), against ray_tpu on the CPU.

- Twins of ``tests/test_ops_layer.py``'s three runtime_env cases, each run
  on both packages: ``working_dir`` and ``py_modules`` (the port's cwd under
  its own root, ``<tempdir>/ray_tpu_torch/runtime_env``, never ray_tpu's
  ``/tmp/ray_tpu/runtime_env``; a plain task after it does not land on the
  bound worker), ``pip`` gated (and ``conda``, ``uv``, ``container``), and an
  actor's ``env_vars``.
- The port's rules: a function whose module only the env's ``py_modules``
  hold resolves by reference; an edit packs again; a setup error fails the
  task; a card-bound actor with a runtime_env keeps both bindings and
  shares its worker with neither a plain task nor another env's; a worker
  on an agent's node in a shm namespace of its own fetches the archive
  through the transfer server.

One runtime of each package for the module (the agent case adds a node
of its own); remote code lives in ``tests/torch_env_defs.py``. Every get
carries a timeout."""

import hashlib
import os
import time

import pytest
import torch_env_defs as defs

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.core import context as tcontext
from ray_tpu_torch.core import transport
from ray_tpu_torch.runtime_env import packaging

T = 60
PKGS = (ray_tpu, ray_tpu_torch)


@pytest.fixture(scope="module")
def both():
    for pkg in PKGS:
        pkg.shutdown()
        pkg.init(num_cpus=4)
    yield
    for pkg in PKGS:
        pkg.shutdown()


def _dirs(tmp_path, payload="payload-42", value=1234):
    wd = tmp_path / "app"
    wd.mkdir()
    (wd / "data.txt").write_text(payload)
    mod = tmp_path / "extra_mod"
    mod.mkdir()
    (mod / "shiny_helper.py").write_text(f"VALUE = {value}\n\n\ndef answer():\n    return VALUE + 1\n")
    return str(wd), str(mod)


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.__name__)
def test_runtime_env_working_dir_and_py_modules(both, pkg, tmp_path):
    wd, mod = _dirs(tmp_path)
    probe = pkg.remote(runtime_env={"working_dir": wd, "py_modules": [mod]})(defs.probe)
    data, val, cwd = pkg.get(probe.remote(), timeout=T)
    assert data == "payload-42"
    assert val == 1234
    own_root = "/ray_tpu_torch/runtime_env/" if pkg is ray_tpu_torch else "/tmp/ray_tpu/runtime_env/"
    assert own_root in cwd
    if pkg is ray_tpu_torch:
        assert cwd.startswith(packaging.cache_root()) and "/tmp/ray_tpu/runtime_env/" not in cwd
    # plain tasks must not land on the polluted worker
    assert own_root not in pkg.get(pkg.remote(defs.plain_cwd).remote(), timeout=T)[0]


@pytest.mark.parametrize("kind", ["pip", "conda", "uv", "container"])
@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.__name__)
def test_runtime_env_pip_is_gated(both, pkg, kind):
    f = pkg.remote(runtime_env={kind: ["requests"]})(defs.one)
    with pytest.raises(Exception, match=kind):
        pkg.get(f.remote(), timeout=30)


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.__name__)
def test_runtime_env_actor_env_vars(both, pkg):
    A = pkg.remote(runtime_env={"env_vars": {"ACTOR_FLAVOR": "mint"}})(defs.Flavor)
    a = A.remote()
    assert pkg.get(a.flavor.remote(), timeout=T) == "mint"
    pkg.kill(a)


def test_module_only_in_py_modules_resolves_by_reference(both, tmp_path):
    """The task's code is the py_modules module's own function: the driver
    imports it from its file without putting the directory on its
    ``sys.path`` (a worker takes the driver's), so only the env's archive
    lets the worker resolve it."""
    import importlib.util
    import sys

    _, mod = _dirs(tmp_path, value=77)
    spec = importlib.util.spec_from_file_location("shiny_helper", os.path.join(mod, "shiny_helper.py"))
    m = importlib.util.module_from_spec(spec)
    sys.modules["shiny_helper"] = m
    try:
        spec.loader.exec_module(m)
        f = ray_tpu_torch.remote(runtime_env={"py_modules": [mod]})(m.answer)
        assert ray_tpu_torch.get(f.remote(), timeout=T) == 78
    finally:
        sys.modules.pop("shiny_helper", None)


def test_edit_packs_again_and_same_env_reuses_its_worker(both, tmp_path):
    wd, mod = _dirs(tmp_path)
    env = {"working_dir": wd, "py_modules": [mod]}
    f = ray_tpu_torch.remote(runtime_env=env)(defs.probe)
    g = ray_tpu_torch.remote(runtime_env=env)(defs.cwd_and_worker)
    assert ray_tpu_torch.get(f.remote(), timeout=T)[0] == "payload-42"
    cwd1, w1 = ray_tpu_torch.get(g.remote(), timeout=T)
    cwd2, w2 = ray_tpu_torch.get(g.remote(), timeout=T)
    assert cwd1 == cwd2 and w1 == w2  # the bound worker serves its env again
    time.sleep(0.01)
    with open(os.path.join(wd, "data.txt"), "w") as fh:
        fh.write("payload-43!")  # another size: another fingerprint
    data, _, cwd3 = ray_tpu_torch.get(f.remote(), timeout=T)
    assert data == "payload-43!" and cwd3 != cwd1


def test_setup_error_fails_the_task(both, tmp_path):
    """The archive's unpack target is a file: the worker's chdir fails,
    and the task fails with that error instead of hanging its caller."""
    wd, _ = _dirs(tmp_path, payload="setup-error-case")
    digest = hashlib.sha256(packaging._zip_dir(wd)).hexdigest()[:16]
    os.makedirs(packaging.cache_root(), exist_ok=True)
    blocker = os.path.join(packaging.cache_root(), digest)
    open(blocker, "w").close()
    try:
        f = ray_tpu_torch.remote(runtime_env={"working_dir": wd})(defs.plain_cwd)
        with pytest.raises(ray_tpu_torch.exceptions.TaskError, match="NotADirectoryError|Not a directory"):
            ray_tpu_torch.get(f.remote(), timeout=T)
    finally:
        os.unlink(blocker)


def test_card_bound_actor_keeps_both_bindings(tmp_path):
    """A GPU actor with a runtime_env (a host with one counted card that no
    worker touches): its worker carries the card's CUDA_VISIBLE_DEVICES and
    the env's key; a plain task and a task under the same env each run on
    another worker."""
    wd, mod = _dirs(tmp_path)
    env = {"working_dir": wd, "py_modules": [mod]}
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, num_gpus=1)
    try:
        A = ray_tpu_torch.remote(num_gpus=1, runtime_env=env)(defs.Flavor)
        a = A.remote()
        assert ray_tpu_torch.get(a.flavor.remote(), timeout=T) is None
        client = tcontext.get_client()
        (w,) = [w for n in client.node_list() for w in n.workers.values() if w.state == "actor"]
        assert w.env_binding.get("CUDA_VISIBLE_DEVICES") == "0" and w.env_binding.get("runtime_env")
        wid = w.worker_id.hex()
        plain = ray_tpu_torch.get(ray_tpu_torch.remote(defs.plain_cwd).remote(), timeout=T)
        same_env = ray_tpu_torch.get(ray_tpu_torch.remote(runtime_env=env)(defs.cwd_and_worker).remote(), timeout=T)
        assert plain[1] != wid and same_env[1] != wid
        assert "/ray_tpu_torch/runtime_env/" not in plain[0] and "/ray_tpu_torch/runtime_env/" in same_env[0]
    finally:
        ray_tpu_torch.shutdown()


def test_agent_worker_fetches_the_archive_across_namespaces(tmp_path):
    """A worker on an agent's node with a shm namespace of its own (the
    port's ``core/transport.py``) unpacks an archive the head stores: the
    archive (over the inline threshold) crosses through the transfer
    server, and the worker is bound as on the head's node. ray_tpu's
    runtime_env rides its own transport the same way; its
    ``tests/test_transport.py`` has no runtime_env case to twin."""
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    wd, mod = _dirs(tmp_path)
    with open(os.path.join(wd, "blob.bin"), "wb") as fh:
        fh.write(os.urandom(512 << 10))  # incompressible: the archive goes to shm
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=1)
    try:
        client = tcontext.get_client()
        node = client.add_node({"CPU": 2.0}, shm_isolation=True)
        transport.reset_stats()
        pin = NodeAffinitySchedulingStrategy(node_id=node.node_id.hex(), soft=False)
        f = ray_tpu_torch.remote(runtime_env={"working_dir": wd, "py_modules": [mod]},
                                 scheduling_strategy=pin)(defs.probe)
        data, val, cwd = ray_tpu_torch.get(f.remote(), timeout=120)
        assert (data, val) == ("payload-42", 1234) and "/ray_tpu_torch/runtime_env/" in cwd
        assert transport.STATS["pull_bytes"] + transport.STATS["serve_bytes"] > 512 << 10, transport.STATS
        (w,) = [w for w in node.workers.values() if w.env_binding.get("runtime_env")]
        plain = ray_tpu_torch.remote(scheduling_strategy=pin)(defs.plain_cwd)
        assert ray_tpu_torch.get(plain.remote(), timeout=T)[1] != w.worker_id.hex()
    finally:
        ray_tpu_torch.shutdown()
