"""The GBDT trainers on the port's runtime (``ray_tpu_torch.train.gbdt``)
against ray_tpu's, on the CPU: the four cases of ``tests/test_gbdt.py``.
The port's histogram engine and its distributed fits grow the same trees
as ray_tpu's: predictions equal within atol 1e-9 (the reference's own
tolerance between its 1- and 2-worker fits), metrics equal exactly.
The trainer's loop is a module-level callable (``gbdt._GBDTLoop``), as
the port sends loops by reference. Every fit is bounded (``T``)."""

import numpy as np
import pytest
from test_torch_trainer import MODS, PKGS, fit

from ray_tpu.train import gbdt as jgbdt
from ray_tpu_torch.train import gbdt as tgbdt

T = 150
ATOL = 1e-9
_REF: dict = {}


def _make_rows(n=600, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 4))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    return [{"f0": X[i, 0], "f1": X[i, 1], "f2": X[i, 2], "f3": X[i, 3], "label": float(y[i])} for i in range(n)], X, y


def _trees(model) -> list:
    def walk(n):
        if n.feature is None:
            return n.leaf_value
        return (n.feature, n.threshold_bin, walk(n.left), walk(n.right))

    return [walk(t) for t in model.trees]


@pytest.mark.parametrize("mod", [jgbdt, tgbdt], ids=["ray_tpu", "ray_tpu_torch"])
def test_hist_engine_learns_regression_and_classification(mod):
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, (2000, 5))
    y = 3 * X[:, 0] - 2 * X[:, 1] + 0.05 * rng.normal(size=2000)
    m = mod.HistGBDT(n_estimators=60, max_depth=4)
    assert m.fit(X, y)["rmse"] < 0.25

    yc = (X[:, 0] + X[:, 1] > 0).astype(np.float64)
    mc = mod.HistGBDT(n_estimators=60, max_depth=3, objective="binary:logistic")
    metrics = mc.fit(X, yc)
    assert metrics["error"] < 0.05
    proba = mc.predict_proba(X[:10])
    assert proba.shape == (10,) and np.all((proba >= 0) & (proba <= 1))
    if mod is tgbdt:
        ref = jgbdt.HistGBDT(n_estimators=60, max_depth=3, objective="binary:logistic")
        assert ref.fit(X, yc) == metrics and _trees(ref) == _trees(mc)
        np.testing.assert_allclose(mc.predict(X), ref.predict(X), rtol=0, atol=ATOL)


def _fit(pkg, rows, num_workers, name, tmp_path, cls="GBDTTrainer", **kw):
    rt, train, data = MODS[pkg]
    rt.shutdown()
    rt.init(num_cpus=4)
    try:
        res = fit(getattr(train, cls)(
            datasets={"train": data.from_items(rows)},
            label_column="label",
            scaling_config=train.ScalingConfig(num_workers=num_workers),
            run_config=train.RunConfig(name=name, storage_path=str(tmp_path)),
            **kw,
        ), timeout=T)
        assert res.error is None, res.error
        return train.GBDTTrainer.get_model(res.checkpoint), res.metrics
    finally:
        rt.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_gbdt_trainer_distributed_matches_single_worker(pkg, tmp_path):
    """Histogram sums are split-invariant: 2 workers on shards of the rows
    grow the trees 1 worker grows on all of them (one session per fit)."""
    rows, X, y = _make_rows()
    params = {"max_depth": 3, "learning_rate": 0.3, "objective": "binary:logistic"}
    m1, met1 = _fit(pkg, rows, 1, "gbdt1", tmp_path, params=params, num_boost_round=12)
    m2, met2 = _fit(pkg, rows, 2, "gbdt2", tmp_path, params=params, num_boost_round=12)
    assert met1["trees"] == met2["trees"] == 12
    p1, p2 = m1.predict(X), m2.predict(X)
    np.testing.assert_allclose(p1, p2, rtol=0, atol=ATOL)
    assert met2["error"] < 0.1
    if pkg == "ray_tpu":
        _REF["dist"] = (p1, p2, _trees(m2))
    elif "dist" in _REF:
        np.testing.assert_allclose(p1, _REF["dist"][0], rtol=0, atol=ATOL)
        np.testing.assert_allclose(p2, _REF["dist"][1], rtol=0, atol=ATOL)
        assert _trees(m2) == _REF["dist"][2]


@pytest.mark.parametrize("pkg", PKGS)
def test_xgboost_param_surface(pkg, tmp_path):
    rows, X, y = _make_rows(300)
    model, metrics = _fit(pkg, rows, 1, "xgb", tmp_path, cls="XGBoostTrainer",
                          params={"eta": 0.3, "max_depth": 3, "objective": "binary:logistic", "max_bin": 32},
                          num_boost_round=8)
    assert metrics["logloss"] < 0.6
    out = ({k: v for k, v in metrics.items() if k in ("logloss", "error", "trees")}, model.predict(X))
    if pkg == "ray_tpu":
        _REF["xgb"] = out
    elif "xgb" in _REF:
        assert out[0] == _REF["xgb"][0]
        np.testing.assert_allclose(out[1], _REF["xgb"][1], rtol=0, atol=ATOL)


@pytest.mark.parametrize("mod", [jgbdt, tgbdt], ids=["ray_tpu", "ray_tpu_torch"])
def test_unsupported_params_rejected(mod):
    with pytest.raises(ValueError, match="unsupported param"):
        mod.XGBoostTrainer(datasets={}, label_column="y", params={"tree_method": "gpu_hist"})
    with pytest.raises(ValueError, match="objective"):
        mod.XGBoostTrainer(datasets={}, label_column="y", params={"objective": "multi:softmax"})
