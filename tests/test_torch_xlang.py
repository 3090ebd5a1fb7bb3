"""Cross-language drivers and workers in the port (``core/xlang.py``),
against ray_tpu on the CPU.

Twins of ``tests/test_xlang_cpp.py``, each run on both packages' heads:
the repository's ``cpp/example_driver.cpp`` (PUT, GET, a CALL and a JSON
result) and ``cpp/example_worker.cpp`` (a C++ function and actor called
from Python), built once with g++ and unchanged; the raw Python client,
whose response frames must be the same bytes from both heads. Then the
port's own: ``export`` refuses a closure or a lambda at once, and a
large PUT crosses the object store's segments. The exported functions
live in ``tests/torch_tooling_defs.py``: the port sends code by
reference. One runtime of each package for the module."""

import shutil
import socket
import struct
import subprocess
import time
from pathlib import Path

import pytest
import torch_tooling_defs as defs

import ray_tpu
import ray_tpu_torch
from ray_tpu.core import xlang as jxlang
from ray_tpu_torch.core import xlang as txlang

REPO = Path(__file__).resolve().parents[1]
T = 120
PKGS = (ray_tpu, ray_tpu_torch)
XLANG = {ray_tpu: jxlang, ray_tpu_torch: txlang}
ids = {"ids": lambda p: p.__name__}
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


@pytest.fixture(scope="module")
def both():
    for pkg in PKGS:
        pkg.shutdown()
        pkg.init(num_cpus=2)
    yield
    for pkg in PKGS:
        XLANG[pkg].shutdown()
        pkg.shutdown()


@pytest.fixture
def xl(both, request):
    """The parameter's package's xlang module, its server up for the test."""
    x = XLANG[request.param]
    yield x
    x.shutdown()


@pytest.fixture(scope="module")
def binaries(tmp_path_factory):
    """The repository's example driver and worker, built once, unchanged."""
    out = tmp_path_factory.mktemp("cpp")
    built = {}
    for name, extra in (("example_driver", []), ("example_worker", ["-pthread"])):
        built[name] = str(out / name)
        subprocess.run(["g++", "-std=c++17", "-O2", *extra, "-o", built[name], str(REPO / "cpp" / f"{name}.cpp")],
                       check=True, capture_output=True, timeout=300)
    return built


@needs_gxx
@pytest.mark.parametrize("xl", PKGS, indirect=True, **ids)
def test_cpp_driver_end_to_end(xl, binaries):
    info = xl.serve()
    xl.export("double_it")(defs.double_it)
    xl.export("describe")(defs.describe)
    out = subprocess.run([binaries["example_driver"], info["host"], str(info["port"]), info["authkey"]],
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert "CPP_DRIVER_OK" in out.stdout, out.stdout
    assert '{"name":"tensor","len":6}' in out.stdout, out.stdout


def _raw_session(x) -> list:
    """ray_tpu's raw client case on ``x``'s head: every response frame, the
    object ids (random per head) replaced by their length."""
    info = x.serve()
    x.export("upper")(defs.upper)
    sock = socket.create_connection((info["host"], info["port"]), timeout=30)
    sock.settimeout(60)
    x_transport = __import__(x.__name__.rsplit(".", 1)[0] + ".transport", fromlist=["_auth_client"])
    x_transport._auth_client(sock, bytes.fromhex(info["authkey"]))
    frames = []

    def rpc(req: bytes) -> bytes:
        x_transport._send_frame(sock, req)
        resp = bytes(x._recv_frame(sock))
        frames.append(resp if len(resp) != 21 else resp[:1] + b"<id 20>")
        return resp

    try:
        oid = rpc(bytes([0x01]) + b"\x00\x01raw")[1:]  # put raw bytes
        assert len(oid) == 20
        assert rpc(bytes([0x02]) + oid + struct.pack("<d", 30.0)) == b"\x00\x00\x01raw"
        rid = rpc(bytes([0x03]) + struct.pack("<H", 5) + b"upper" + b"abc")[1:]  # call -> id -> get
        assert rpc(bytes([0x02]) + rid + struct.pack("<d", 60.0)) == b"\x00ABC"
        err = rpc(bytes([0x03]) + struct.pack("<H", 4) + b"nope" + b"")  # unknown function
        assert err[0] == 1 and b"nope" in err[1:]
        rpc(bytes([0x7F]))  # unknown op
        rpc(bytes([0x02]) + b"\x01" * 20 + struct.pack("<d", 0.2))  # an id nobody made: GetTimeoutError
    finally:
        sock.close()
    return frames


@pytest.mark.parametrize("xl", PKGS, indirect=True, **ids)
def test_xlang_python_client_semantics(xl):
    frames = _raw_session(xl)
    assert frames[-2][0] == 1 and b"unknown xlang op 0x7f" in frames[-2]
    assert frames[-1][0] == 1 and frames[-1][1:].startswith(b"GetTimeoutError"), frames[-1]


def test_xlang_response_bytes_equal_across_heads(both):
    """The same requests give the same response frames from both heads."""
    try:
        got = {pkg: _raw_session(XLANG[pkg]) for pkg in PKGS}
    finally:
        for x in XLANG.values():
            x.shutdown()
    j, t = got[ray_tpu], got[ray_tpu_torch]
    assert len(j) == len(t) == 7
    # the timeout's message names each head's own object id prefix and wording
    assert j[:-1] == t[:-1], (j, t)
    assert j[-1].split(b":")[0] == t[-1].split(b":")[0] == b"\x01GetTimeoutError"


@needs_gxx
@pytest.mark.parametrize("xl", PKGS, indirect=True, **ids)
def test_cpp_worker_tasks_and_actors(xl, binaries, request):
    pkg = request.node.callspec.params["xl"]
    info = xl.serve()
    proc = subprocess.Popen([binaries["example_worker"], info["host"], str(info["port"]), info["authkey"], "cppw"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        scale = xl.cpp_function("cppw", "scale")
        assert pkg.get(scale.remote(b"14"), timeout=T) == b"42"
        refs = [scale.remote(str(i).encode()) for i in range(8)]
        assert [int(pkg.get(r, timeout=T)) for r in refs] == [3 * i for i in range(8)]
        h = xl.cpp_actor("cppw", "Counter")
        outs = [h.call.remote("add", b"2") for _ in range(5)]
        assert [int(pkg.get(o, timeout=T)) for o in outs] == [2, 4, 6, 8, 10]
        assert int(pkg.get(h.call.remote("get"), timeout=T)) == 10
        h2 = xl.cpp_actor("cppw", "Counter")
        assert int(pkg.get(h2.call.remote("get"), timeout=T)) == 0
        with pytest.raises(Exception, match="unknown method nope"):
            pkg.get(h.call.remote("nope"), timeout=60)
        pkg.kill(h)
        pkg.kill(h2)
    finally:
        proc.terminate()
        proc.wait(timeout=10)


# ---------------------------------------------------------------- the port's own
@needs_gxx
@pytest.mark.parametrize("xl", PKGS, indirect=True, **ids)
def test_generate_driver_against_each_head(xl, tmp_path):
    """The port's own C++ driver (``ray_tpu_torch/cpp/generate_driver.cpp``,
    built by ``ray_tpu_torch.cpp.build``): 10 small round trips, a 4 MiB
    PUT and GET compared byte for byte, and a CALL of "generate" whose
    JSON result it prints; the same line's result from both heads."""
    import json

    from ray_tpu_torch import cpp

    binary = cpp.build(cpp.HERE / "generate_driver.cpp")
    info = xl.serve()
    xl.export("generate")(defs.echo_generate)
    prompts = [[1, 2, 3], [40, 50], [7]]
    path = tmp_path / "prompts.json"
    path.write_text(json.dumps(prompts))
    out = subprocess.run([binary, info["host"], str(info["port"]), info["authkey"], str(path), str(4 << 20), "10"],
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["result"] == {"tokens": [[3, 2, 1], [50, 40], [7]], "n": 3}
    assert line["bulk_bytes"] == 4 << 20 and line["put_gbps"] > 0 and line["get_gbps"] > 0
    assert 0 < line["put_us"] <= line["rtt_us"] and line["call_s"] > 0


def test_cpp_build_fails_loudly(tmp_path):
    from ray_tpu_torch import cpp

    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( {")
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        cpp.build(bad)


def test_export_refuses_closures_and_lambdas(both):
    """Code by reference: export raises TypeError at once for code a worker
    cannot import, before any CALL."""
    txlang.serve()
    try:
        def local(payload: bytes) -> bytes:
            return payload

        with pytest.raises(TypeError, match="closure"):
            txlang.export("local")(local)
        with pytest.raises(TypeError, match="lambda"):
            txlang.export("anon")(lambda payload: payload)
        assert "local" not in txlang._server._fns and "anon" not in txlang._server._fns
        txlang.export("double_it")(defs.double_it)  # a module-level function is taken
        assert "double_it" in txlang._server._fns
        txlang.shutdown()
        with pytest.raises(RuntimeError, match="serve"):
            txlang.export("double_it")(defs.double_it)
    finally:
        txlang.shutdown()


@pytest.mark.parametrize("xl", PKGS, indirect=True, **ids)
def test_call_with_a_large_result(xl):
    """A CALL whose 4 MiB result the worker seals in the head's store (a
    REDIRECT in the port's direct plane): the GET resolves it on the
    server's connection thread."""
    info = xl.serve()
    xl.export("repeat")(defs.repeat_mib)
    tr = __import__(xl.__name__.rsplit(".", 1)[0] + ".transport", fromlist=["_auth_client"])
    sock = socket.create_connection((info["host"], info["port"]), timeout=30)
    sock.settimeout(120)
    try:
        tr._auth_client(sock, bytes.fromhex(info["authkey"]))
        tr._send_frame(sock, bytes([0x03]) + struct.pack("<H", 6) + b"repeat" + b"xy")
        resp = bytes(xl._recv_frame(sock))
        assert resp[0] == 0 and len(resp) == 21, resp[:200]
        tr._send_frame(sock, bytes([0x02]) + resp[1:] + struct.pack("<d", 120.0))
        got = xl._recv_frame(sock)
        assert got[0] == 0 and bytes(got[1:]) == b"xy" * (2 << 20)
    finally:
        sock.close()


@pytest.mark.parametrize("xl", PKGS, indirect=True, **ids)
def test_large_put_get_round_trip(xl):
    """An 8 MiB PUT (a shared-memory segment in both stores) comes back
    byte for byte; the server holds it until the client's GET."""
    import numpy as np

    info = xl.serve()
    blob = np.random.default_rng(3).bytes(8 << 20)
    tr = __import__(xl.__name__.rsplit(".", 1)[0] + ".transport", fromlist=["_auth_client"])
    sock = socket.create_connection((info["host"], info["port"]), timeout=30)
    sock.settimeout(60)
    try:
        tr._auth_client(sock, bytes.fromhex(info["authkey"]))
        tr._send_frame(sock, bytes([0x01]) + blob)
        resp = bytes(xl._recv_frame(sock))
        assert resp[0] == 0 and len(resp) == 21
        time.sleep(0.5)  # no Python reference holds the object meanwhile
        tr._send_frame(sock, bytes([0x02]) + resp[1:] + struct.pack("<d", 30.0))
        got = xl._recv_frame(sock)
        assert got[0] == 0 and bytes(got[1:]) == blob
    finally:
        sock.close()
