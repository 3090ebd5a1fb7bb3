"""The collective API on the port's runtime (``ray_tpu_torch.collective``)
against ray_tpu's, on the CPU: the five cases of
``tests/test_collective.py``, each parametrised over both packages. The
port's parameter runs the case's own assertions and holds its results
against ray_tpu's on the same inputs (equal arrays, exactly: the same
numpy reductions in the same rank order). Then the port's own rules: a
torch tensor in gives a torch tensor of its dtype out (bf16 included),
a p2p payload above the 32 KiB plane threshold rides the object store,
and the mixin's hook joins a group declared from the driver. The
``"xla"`` backend's twin is in ``tests/test_torch_tp_collective.py``.

One runtime of each package for the module (4 CPUs each). The ranks'
class lives in ``tests/torch_train_defs.py`` (actors travel by reference
on the port). Every get carries a timeout."""

import numpy as np
import pytest
import torch_train_defs as defs

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch import collective as tcol

PKGS = ("ray_tpu", "ray_tpu_torch")
RT = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}
T = 60  # seconds: the bound on every get
_REF: dict = {}


@pytest.fixture(scope="module")
def runtimes():
    for rt in RT.values():
        rt.shutdown()
        rt.init(num_cpus=4)
    yield
    for rt in RT.values():
        rt.shutdown()


@pytest.fixture(params=PKGS)
def pkg(request, runtimes):
    return request.param


def _make_group(pkg, n, group):
    rt = RT[pkg]
    actors = [rt.remote(defs.Rank).options(num_cpus=0).remote(pkg) for _ in range(n)]
    rt.get([a.setup.remote(n, i, group) for i, a in enumerate(actors)], timeout=T)
    return actors


def _norm(x):
    if isinstance(x, list):
        return [_norm(v) for v in x]
    return None if x is None else (np.asarray(x).dtype.str, np.asarray(x).tolist())


def same(pkg, method, n, group):
    """``method`` on every rank of an ``n``-rank group; on the port also
    equal to ray_tpu's results on the same inputs."""
    rt = RT[pkg]
    actors = _make_group(pkg, n, f"{group}_{pkg}")
    outs = rt.get([getattr(a, method).remote(f"{group}_{pkg}") for a in actors], timeout=T)
    if pkg == "ray_tpu":
        _REF[group] = _norm(outs)
    elif group in _REF:
        assert _norm(outs) == _REF[group], (outs, _REF[group])
    for a in actors:
        rt.kill(a)
    return outs


# ---------------------------------------------------------------- test_collective.py's cases
def test_allreduce(pkg):
    for o in same(pkg, "do_allreduce", 4, "g1"):
        np.testing.assert_allclose(o, np.full((4,), 1.0 + 2 + 3 + 4))


def test_allgather(pkg):
    for o in same(pkg, "do_allgather", 3, "g2"):
        assert [int(x[0]) for x in o] == [0, 1, 2]


def test_reducescatter(pkg):
    outs = same(pkg, "do_reducescatter", 2, "g3")
    # sum over 2 ranks of arange(8) -> 2*arange(8); rank r gets its split
    np.testing.assert_allclose(outs[0], 2 * np.arange(4, dtype=np.float64))
    np.testing.assert_allclose(outs[1], 2 * np.arange(4, 8, dtype=np.float64))


def test_broadcast(pkg):
    for o in same(pkg, "do_broadcast", 3, "g4"):
        np.testing.assert_allclose(o, [42.0])


def test_send_recv(pkg):
    outs = same(pkg, "do_sendrecv", 2, "g5")
    np.testing.assert_allclose(outs[1], [7.0])


# ---------------------------------------------------------------- the port's rules
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_torch_tensor_in_torch_tensor_out(runtimes, dtype):
    actors = _make_group("ray_tpu_torch", 2, f"torch_{dtype}")
    outs = ray_tpu_torch.get([a.torch_allreduce.remote(f"torch_{dtype}", dtype) for a in actors], timeout=T)
    assert outs == [("Tensor", f"torch.{dtype}", [3.0, 3.0, 3.0])] * 2


def test_send_recv_above_the_plane_threshold(runtimes):
    """8 KiB floats (64 KiB) cross the 32 KiB threshold: the send rides the
    object store and the receiver frees it; the bytes arrive whole."""
    n = 8192
    assert n * 8 >= tcol.collective._SHM_PLANE_THRESHOLD
    actors = _make_group("ray_tpu_torch", 2, "big_p2p")
    outs = ray_tpu_torch.get([a.do_sendrecv.remote("big_p2p", n) for a in actors], timeout=T)
    assert outs[0] is None and outs[1].shape == (n,) and (outs[1] == 7.0).all()


def test_declare_group_through_the_mixin(runtimes):
    actors = [ray_tpu_torch.remote(defs.TRank).options(num_cpus=0).remote("ray_tpu_torch") for _ in range(3)]
    ranks = ray_tpu_torch.get(tcol.declare_collective_group(actors, group_name="mixin"), timeout=T)
    assert ranks == [0, 1, 2]
    outs = ray_tpu_torch.get([a.do_allgather.remote("mixin") for a in actors], timeout=T)
    assert [[int(x[0]) for x in o] for o in outs] == [[0, 1, 2]] * 3
