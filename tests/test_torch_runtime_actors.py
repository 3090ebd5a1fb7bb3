"""Actors on the port's runtime (``ray_tpu_torch``) against ray_tpu's, on
the CPU: every case of ``tests/test_core_actors.py`` (ordering, errors,
named actors, kill, restarts, handles passed to tasks and actors, async,
threaded and streaming actors), each run on both runtimes (one of each
for the module, 4 CPUs) with the same results and error types. Then the
card as a resource: a ``num_gpus=1`` actor on a logical card gets a
worker of its own that sees only its card, a second one stays pending
until the first is killed, and the available resources follow, "TPU" in
ray_tpu and "GPU" in the port. Every get carries a timeout."""

import time

import pytest
import torch_runtime_defs as defs

import ray_tpu
import ray_tpu_torch
from ray_tpu import exceptions as jexc
from ray_tpu_torch import exceptions as texc

T = 60
PKGS = (ray_tpu, ray_tpu_torch)
EXC = {ray_tpu: jexc, ray_tpu_torch: texc}


@pytest.fixture(scope="module")
def both():
    for pkg in PKGS:
        pkg.shutdown()
    ray_tpu.init(num_cpus=4, num_tpus=1)
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    yield
    for pkg in PKGS:
        pkg.shutdown()


def same(fn):
    a, b = fn(ray_tpu), fn(ray_tpu_torch)
    assert a == b, (a, b)
    return a


def counter(pkg, *args, **opts):
    cls = pkg.remote(defs.Counter)
    return (cls.options(**opts) if opts else cls).remote(*args)


def test_actor_basic(both):
    def case(pkg):
        c = counter(pkg)
        return [pkg.get(c.incr.remote(), timeout=T), pkg.get(c.incr.remote(5), timeout=T),
                pkg.get(c.read.remote(), timeout=T)]

    assert same(case) == [1, 6, 6]


def test_actor_init_args(both):
    assert same(lambda pkg: pkg.get(counter(pkg, 100).read.remote(), timeout=T)) == 100


def test_actor_ordering(both):
    def case(pkg):
        c = counter(pkg)
        refs = [c.incr.remote() for _ in range(50)]
        return pkg.get(refs[-1], timeout=T), pkg.get(refs, timeout=T)

    assert same(case) == (50, list(range(1, 51)))


def test_two_actors_isolated(both):
    def case(pkg):
        a, b = counter(pkg), counter(pkg)
        pkg.get([a.incr.remote(), a.incr.remote(), b.incr.remote()], timeout=T)
        return pkg.get(a.read.remote(), timeout=T), pkg.get(b.read.remote(), timeout=T)

    assert same(case) == (2, 1)


def test_actor_method_error(both):
    def case(pkg):
        b = pkg.remote(defs.Bad).remote()
        with pytest.raises(EXC[pkg].TaskError) as ei:
            pkg.get(b.boom.remote(), timeout=T)
        return type(ei.value.cause).__name__, pkg.get(b.ok.remote(), timeout=T)  # the actor survives

    assert same(case) == ("RuntimeError", "fine")


def test_actor_creation_error(both):
    def case(pkg):
        a = pkg.remote(defs.FailsInit).remote()
        with pytest.raises((EXC[pkg].TaskError, EXC[pkg].ActorDiedError)) as ei:
            pkg.get(a.m.remote(), timeout=10)
        return type(ei.value).__name__, "init failed" in str(ei.value)

    assert same(case)[1]


def test_named_actor(both):
    def case(pkg):
        c = counter(pkg, 7, name="global_counter")
        pkg.get(c.read.remote(), timeout=T)
        return pkg.get(pkg.get_actor("global_counter").read.remote(), timeout=T)

    assert same(case) == 7


def test_kill_actor(both):
    def case(pkg):
        c = counter(pkg)
        first = pkg.get(c.incr.remote(), timeout=T)
        pkg.kill(c)
        with pytest.raises(EXC[pkg].ActorDiedError):
            pkg.get(c.incr.remote(), timeout=10)
        return first

    assert same(case) == 1


def test_actor_restart(both):
    def case(pkg):
        p = pkg.remote(defs.Phoenix).options(max_restarts=2).remote()
        first = pkg.get(p.incr.remote(), timeout=T)
        pid1 = pkg.get(p.pid.remote(), timeout=T)
        with pytest.raises((EXC[pkg].ActorDiedError, EXC[pkg].RayTpuError)):
            pkg.get(p.die.remote(), timeout=5)
        deadline = time.time() + 30
        while True:  # restarted: its state reset, a new process
            try:
                after = pkg.get(p.incr.remote(), timeout=10)
                break
            except EXC[pkg].ActorDiedError:
                if time.time() > deadline:
                    raise
                time.sleep(0.2)
        return first, after, pkg.get(p.pid.remote(), timeout=T) != pid1

    assert same(case) == (1, 1, True)


def test_actor_handle_passed_to_task(both):
    def case(pkg):
        c = counter(pkg)
        return pkg.get(pkg.remote(defs.use_counter).remote(c), timeout=T), pkg.get(c.read.remote(), timeout=T)

    assert same(case) == (10, 10)


def test_actor_to_actor_calls(both):
    def case(pkg):
        f = pkg.remote(defs.Front).remote(counter(pkg))
        return pkg.get(f.go.remote(), timeout=T)

    assert same(case) == 101


def test_async_actor(both):
    def case(pkg):
        a = pkg.remote(defs.AsyncWorker).remote()
        pkg.get(a.work.remote(0.0, -1), timeout=T)  # started
        t0 = time.time()
        out = pkg.get([a.work.remote(0.5, i) for i in range(4)], timeout=T)
        return out, time.time() - t0 < 1.8  # the four sleeps overlap

    assert same(case) == ([0, 1, 2, 3], True)


def test_threaded_actor_concurrency(both):
    def case(pkg):
        s = pkg.remote(defs.Slow).options(max_concurrency=4).remote()
        pkg.get(s.work.remote(0.0), timeout=T)  # started
        t0 = time.time()
        pkg.get([s.work.remote(0.5) for _ in range(4)], timeout=T)
        return time.time() - t0 < 1.8

    assert same(case)


def test_actor_streaming_method(both):
    def case(pkg):
        g = pkg.remote(defs.Gen).remote()
        return [pkg.get(r, timeout=T) for r in g.stream.options(num_returns="streaming").remote(4)]

    assert same(case) == [0, 1, 2, 3]


def test_get_actor_after_death_fails(both):
    def case(pkg):
        c = counter(pkg, name="dies")
        pkg.get(c.read.remote(), timeout=T)
        pkg.kill(c)
        time.sleep(0.5)
        with pytest.raises(ValueError):
            pkg.get_actor("dies")
        return True

    assert same(case)


def test_card_actor_worker_pending_and_release(both):
    """A card-bound actor (num_tpus=1 in ray_tpu, num_gpus=1 in the port,
    on one logical card) runs in a worker of its own that sees only its
    card; the available card count drops to 0; a second card-bound actor
    stays pending until the first is killed; every actor after the kill is
    in a new process."""
    res = {ray_tpu: "TPU", ray_tpu_torch: "GPU"}
    opts = {ray_tpu: {"num_tpus": 1}, ray_tpu_torch: {"num_gpus": 1}}
    out = {}
    for pkg in PKGS:
        cls = pkg.remote(defs.CardHolder).options(**opts[pkg])
        a = cls.remote()
        cuda, tpu, keys, pid_a = pkg.get(a.env.remote(), timeout=T)
        assert pkg.cluster_resources()[res[pkg]] == 1
        avail = pkg.available_resources().get(res[pkg], 0)
        b = cls.remote()
        ready, _ = pkg.wait([b.env.remote()], timeout=2.0)
        pending = ready == []
        pkg.kill(a)
        cuda_b, tpu_b, _, pid_b = pkg.get(b.env.remote(), timeout=T)
        pkg.kill(b)
        out[pkg] = (avail, pending, pid_a != pid_b, keys)
        if pkg is ray_tpu_torch:
            assert (cuda, cuda_b) == ("0", "0")  # the worker sees its card only
        else:
            assert (tpu, tpu_b) == ("0", "0")
    assert out[ray_tpu][:3] == out[ray_tpu_torch][:3] == (0, True, True)
    assert [k.replace("TPU", "GPU") for k in out[ray_tpu][3]] == out[ray_tpu_torch][3]
    deadline = time.monotonic() + 20  # the cards come back once both processes have exited
    while time.monotonic() < deadline and any(pkg.available_resources().get(res[pkg], 0) != 1 for pkg in PKGS):
        time.sleep(0.05)
    assert [pkg.available_resources().get(res[pkg], 0) for pkg in PKGS] == [1, 1]


def test_card_worker_large_returns_outlive_the_worker(both, tmp_path):
    """A card-bound task's return and a card-bound actor's, each past the
    inline limit, stay in the head's store after the worker that wrote
    them has exited and later workers have started (a worker's start
    sweeps the segments of writers that died): get returns both, and
    neither ran twice."""
    import numpy as np

    res = {ray_tpu: "TPU", ray_tpu_torch: "GPU"}
    opts = {ray_tpu: {"num_tpus": 1}, ray_tpu_torch: {"num_gpus": 1}}
    for pkg in PKGS:
        log = tmp_path / f"{pkg.__name__}.log"
        ref = pkg.remote(defs.counted_big).options(**opts[pkg]).remote(str(log), 1)
        assert pkg.wait([ref], timeout=T)[0] == [ref]
        a = pkg.remote(defs.CardHolder).options(**opts[pkg]).remote()  # a new worker, once the card is back
        aref = a.big.remote(str(log), 2)
        assert pkg.wait([aref], timeout=T)[0] == [aref]
        pkg.kill(a)
        # one more card-bound worker starts once the actor's has exited
        assert pkg.get(pkg.remote(defs.pid).options(**opts[pkg]).remote(), timeout=T) > 0
        np.testing.assert_array_equal(pkg.get(ref, timeout=T), defs.big(1))
        np.testing.assert_array_equal(pkg.get(aref, timeout=T), defs.big(2))
        assert log.read_text().count("ran") == 2
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and pkg.available_resources().get(res[pkg], 0) != 1:
            time.sleep(0.05)
