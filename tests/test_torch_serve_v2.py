"""Serve's data plane on the port's runtime against ray_tpu's, on the CPU:
every case of ``tests/test_serve_v2.py`` but the HTTP one
(``test_torch_serve_proxy.py`` runs it), each run on both runtimes with
the same results and error types: handle and async-generator streaming,
``@serve.batch``, the request timeout, stream cancel, the router's submit
overhead, the shutdown hook on drain, and multiplexing's LRU with sticky
routing. ray_tpu's gRPC case runs on ray_tpu only; the port raises naming
its ROADMAP.md item. Then the card as a replica's resource: a replica
with ``num_tpus=1`` holds one ``"GPU"`` (ray_tpu: one ``"TPU"``), its
worker sees only its card, and the card comes back after
``serve.delete``. The fixtures and helpers are
``test_torch_serve.py``'s: one runtime of each package for the module,
each test's apps deleted after it. Every result carries a timeout."""

import os
import threading
import time

import pytest
import torch_serve_defs as defs
from test_torch_serve import EXC, REPO, SERVE, T, both, dep, same, serve_both, wait_until  # noqa: F401 (fixtures)

import ray_tpu
import ray_tpu.serve as jserve
import ray_tpu_torch
import ray_tpu_torch.serve as tserve
from ray_tpu_torch.core import context as tcontext


def test_streaming_response_through_handle(serve_both):
    def case(pkg):
        h = SERVE[pkg].run(dep(pkg, defs.Streamer).bind(), name="stream_app")
        return list(h.options(stream=True).counts.remote(5))

    assert same(case) == [{"i": i} for i in range(5)]


def test_async_generator_streaming(serve_both):
    def case(pkg):
        h = SERVE[pkg].run(dep(pkg, defs.AStream).bind(), name="astream_app")
        return list(h.options(stream=True).gen.remote(4))

    assert same(case) == [0, 1, 4, 9]


def test_serve_batch_fuses_concurrent_calls(serve_both):
    def case(pkg):
        h = SERVE[pkg].run(dep(pkg, defs.Batcher, max_ongoing_requests=16).bind(), name="batch_app")
        h.remote(0).result(timeout_s=T)  # warm the replica (exclude its start from the window)
        responses = [h.remote(i) for i in range(8)]
        results = [r.result(timeout_s=T) for r in responses]
        sizes = h.sizes.remote().result(timeout_s=T)
        return results, max(sizes) >= 2, sum(sizes)

    assert same(case) == ([i * 10 for i in range(8)], True, 9)


def test_request_timeout_cancels_and_frees_slot(serve_both):
    def case(pkg):
        # a short graceful stop: the cancelled request still sleeps in its replica thread
        d = dep(pkg, defs.SlowFor, max_ongoing_requests=1, graceful_shutdown_timeout_s=0.5)
        h = SERVE[pkg].run(d.bind(), name="slow_app")
        warm = h.remote(0).result(timeout_s=T)
        r = h.remote(30)
        with pytest.raises(EXC[pkg].GetTimeoutError):
            r.result(timeout_s=0.5)
        r.cancel()  # the timeout alone must not cancel (the poll pattern); cancel does
        t0 = time.time()
        again = h.remote(0).result(timeout_s=T)
        return warm, again, time.time() - t0 < 25

    assert same(case) == ("done", "done", True)


def test_stream_cancel_stops_replica_generator(serve_both, tmp_path):
    def case(pkg):
        progress = str(tmp_path / f"progress_{pkg.__name__}")
        h = SERVE[pkg].run(dep(pkg, defs.Infinite).bind(), name="cancel_app")
        stream = h.options(stream=True).gen.remote(progress)
        it = iter(stream)
        got = [next(it) for _ in range(3)]
        stream.cancel()
        time.sleep(1.0)
        frozen = open(progress).read()
        time.sleep(1.0)
        return got, open(progress).read() == frozen

    assert same(case) == ([0, 1, 2], True)


def test_router_overhead_p50_under_load(serve_both):
    """p50 of the handle's submit (``.remote()``) under 5 ms with 100
    concurrent requests in flight."""

    def case(pkg):
        h = SERVE[pkg].run(dep(pkg, defs.EchoAfter50ms, max_ongoing_requests=300).bind(), name="lat_app")
        h.remote(0).result(timeout_s=T)  # warm: replica up, router synced
        lat, responses = [], []
        lock = threading.Lock()

        def one(i):
            t0 = time.perf_counter()
            r = h.remote(i)
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)
                responses.append((i, r))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(100)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        echoed = all(r.result(timeout_s=T) == i for i, r in responses)
        lat.sort()
        return echoed, lat[len(lat) // 2] < 0.005

    assert same(case) == (True, True)


def test_shutdown_hook_runs_on_drain(serve_both, tmp_path):
    def case(pkg):
        serve = SERVE[pkg]
        marker = str(tmp_path / f"shutdown_{pkg.__name__}.marker")
        h = serve.run(dep(pkg, defs.WithHook).bind(marker), name="hook_app")
        first = h.remote(1).result(timeout_s=T)
        t0 = time.time()
        serve.delete("hook_app")
        t1 = time.time()
        ran = wait_until(lambda: os.path.exists(marker), timeout_s=15)
        # shown with a failure: which package's leg missed the marker, and where its time went
        print(f"{pkg.__name__}: serve.delete {t1 - t0:.3f} s, then the marker {'after' if ran else 'not within'} "
              f"{time.time() - t1:.3f} s")
        return first, ran, open(marker).read() if ran else None

    assert same(case) == (1, True, "clean")


def test_grpc_ingress_unary_and_streaming(serve_both):
    """ray_tpu's gRPC ingress (a generic proto-less method, unary and
    server streaming); the port raises naming its ROADMAP.md item."""
    from ray_tpu.serve._grpc_proxy import grpc_call, grpc_call_streaming

    jserve.run(jserve.deployment(defs.GrpcApi).bind(), name="grpc_app")
    jserve.start(grpc_port=0)
    addr = f"127.0.0.1:{jserve.api._grpc_proxy.port}"
    assert grpc_call(addr, "grpc_app", 21) == {"doubled": 42}
    assert list(grpc_call_streaming(addr, "grpc_app", 3, method="tokens")) == [{"t": 0}, {"t": 1}, {"t": 2}]
    with pytest.raises(RuntimeError):
        grpc_call(addr, "no_such_app", 1)
    with pytest.raises(NotImplementedError, match=tcontext.GRPC_ITEM):
        tserve.start(grpc_port=0)
    assert "**serve grpc ingress" in (REPO / "ROADMAP.md").read_text().lower()  # a bold item of queue 1


def test_multiplexed_models_lru_and_sticky_routing(serve_both):
    def case(pkg):
        h = SERVE[pkg].run(dep(pkg, defs.ModelServer, num_replicas=2, max_ongoing_requests=8).bind(), name="mux")
        outs = [h.options(multiplexed_model_id="m1").remote(i).result(timeout_s=T) for i in range(6)]
        later = [h.options(multiplexed_model_id=mid).remote(0).result(timeout_s=T)["out"] for mid in ("m2", "m3", "m2")]
        st = h.options(multiplexed_model_id="m1", method_name="stats").remote().result(timeout_s=T)
        return ([o["out"] for o in outs], len({o["replica"] for o in outs}), later, st["loads"].count("m1"),
                len(st["evicted"]) >= 1, set(st["evicted"]) <= {"m1", "m2", "m3"})

    assert same(case) == ([f"m1:{i}" for i in range(6)], 1, ["m2:0", "m3:0", "m2:0"], 1, True, True)


# ---------------------------------------------------------------- the port's card resource
def test_replica_config_num_tpus_is_the_card(serve_both):
    from ray_tpu_torch.core.runtime import _sched_options

    assert jserve.ReplicaConfig(num_tpus=1).to_actor_options() == {"num_cpus": 1.0, "resources": {"TPU": 1}}
    opts = tserve.ReplicaConfig(num_tpus=1).to_actor_options()
    assert _sched_options(opts, is_actor=True).resources == {"CPU": 1.0, "GPU": 1.0}

    def case(pkg):
        h = SERVE[pkg].run(dep(pkg, defs.Visible, num_tpus=1).bind(), name="card")
        env = h.remote().result(timeout_s=T)
        card = "TPU" if pkg is ray_tpu else "GPU"
        held = pkg.available_resources().get(card, 0)
        SERVE[pkg].delete("card")
        back = wait_until(lambda: pkg.available_resources().get(card, 0) == 1, timeout_s=20)
        return env, held, back

    (_, held_j, back_j), (env, held_t, back_t) = case(ray_tpu), case(ray_tpu_torch)
    assert (held_j, back_j) == (held_t, back_t) == (0, True)
    assert env["CUDA_VISIBLE_DEVICES"] == "0" and env["pid"] != os.getpid()
