"""Torch DDP under the port's trainers (``train.torch.prepare_model`` and
``prepare_data_loader`` over a gloo group that ``TorchConfig`` bootstraps)
against ray_tpu's, on the CPU: the two cases of
``tests/test_train_torch.py``, each parametrised over both packages.

The same torch code runs in both packages' workers on the same seeds, so
the port's per-rank facts equal ray_tpu's exactly: DDP wrapping, the
DistributedSampler's shard sizes, all 40 epoch losses and the final
weights. Loops live in ``tests/torch_train_defs.py``. Every fit is
bounded (``T``)."""

import json

import pytest
import torch_train_defs as defs
from test_torch_trainer import MODS, PKGS, fit

T = 150
_REF: dict = {}


@pytest.fixture(params=PKGS)
def pkg(request):
    rt = MODS[request.param][0]
    rt.shutdown()
    rt.init(num_cpus=4)
    yield request.param
    rt.shutdown()


def test_ddp_prepare_model_syncs_gradients(pkg, tmp_path):
    _, train, _ = MODS[pkg]
    trainer = train.DataParallelTrainer(
        defs.ddp_syncs_gradients,
        train_loop_config={"pkg": pkg, "out": str(tmp_path)},
        scaling_config=train.ScalingConfig(num_workers=2, resources_per_worker={"CPU": 1}),
        run_config=train.RunConfig(name="t", storage_path=str(tmp_path)),
        backend_config=train.backend.TorchConfig(),
    )
    result = fit(trainer, timeout=T)
    assert result.error is None
    per_worker = {}
    for r in (0, 1):
        with open(tmp_path / f"rank{r}.json") as f:
            m = json.load(f)
            per_worker[m["rank"]] = m
    assert set(per_worker) == {0, 1}
    for m in per_worker.values():
        assert m["is_ddp"], "prepare_model did not wrap DDP at world_size 2"
        assert m["shard_rows"] == 32, m  # DistributedSampler split 64 rows
        assert m["last_loss"] < m["first_loss"]
    # gradient sync: both replicas hold identical weights after training
    assert per_worker[0]["w0"] == pytest.approx(per_worker[1]["w0"], abs=1e-6)
    if pkg == "ray_tpu":
        _REF["ddp"] = per_worker
    elif "ddp" in _REF:
        assert per_worker == _REF["ddp"]  # shard sizes, every loss, the final weights: exactly


def test_prepare_model_noop_single_worker(pkg, tmp_path):
    _, train, _ = MODS[pkg]
    trainer = train.DataParallelTrainer(
        defs.prepare_model_single,
        train_loop_config={"pkg": pkg},
        scaling_config=train.ScalingConfig(num_workers=1, resources_per_worker={"CPU": 1}),
        run_config=train.RunConfig(name="t1", storage_path=str(tmp_path)),
        backend_config=train.backend.TorchConfig(),
    )
    result = fit(trainer, timeout=T)
    assert result.error is None
    assert result.metrics["is_plain"]
