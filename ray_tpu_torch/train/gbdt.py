"""Distributed gradient-boosted decision trees (port of
ray_tpu/train/gbdt.py): data-parallel boosting where every worker holds a
dataset shard and the per-node gradient histograms are allreduced, so
all workers grow identical trees (the ``tree_method=hist`` + allreduce
algorithm).

The engine is a numpy implementation of that histogram algorithm:
second-order boosting (gradient + hessian), uniform binning over
allreduced per-feature ranges, depth-wise growth with the xgboost gain
formula. ``XGBoostTrainer`` and ``LightGBMTrainer`` map those libraries'
parameter names onto it. The histogram sync rides the port's
``train.collective.allreduce``; the loop is a module-level callable
(``_GBDTLoop``) because the port sends loops by reference.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.train.trainer import DataParallelTrainer


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.clip(x, -30, 30)))


class _Node:
    __slots__ = ("feature", "threshold_bin", "left", "right", "leaf_value")

    def __init__(self, leaf_value=None, feature=None, threshold_bin=None, left=None, right=None):
        self.leaf_value = leaf_value
        self.feature = feature
        self.threshold_bin = threshold_bin
        self.left = left
        self.right = right


class HistGBDT:
    """Histogram GBDT with a pluggable allreduce seam.

    ``histogram_reduce(arr) -> arr`` sums a float64 array across workers;
    the default (identity) trains single-process. All split decisions are
    taken on REDUCED histograms, so every worker with the same bin edges
    grows the same trees.
    """

    def __init__(
        self,
        n_estimators: int = 50,
        max_depth: int = 4,
        learning_rate: float = 0.3,
        n_bins: int = 64,
        objective: str = "reg:squarederror",
        reg_lambda: float = 1.0,
        min_child_weight: float = 1e-3,
        min_gain: float = 0.0,
    ):
        assert objective in ("reg:squarederror", "binary:logistic"), objective
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_bins = n_bins
        self.objective = objective
        self.reg_lambda = reg_lambda
        self.min_child_weight = min_child_weight
        self.min_gain = min_gain
        self.trees: list[_Node] = []
        self.bin_edges: np.ndarray | None = None  # [F, n_bins-1]
        self.base_score = 0.0

    # -- binning -------------------------------------------------------
    def _bin(self, X):
        """Map features to uint8 bin ids using self.bin_edges."""
        B = np.empty(X.shape, np.int32)
        for f in range(X.shape[1]):
            B[:, f] = np.searchsorted(self.bin_edges[f], X[:, f], side="right")
        return B

    # -- training ------------------------------------------------------
    def fit(self, X, y, histogram_reduce=None, extrema_reduce=None, eval_every: int = 0, eval_cb=None):
        """Fit on the local shard (X [N,F], y [N]).

        histogram_reduce: SUM across workers (float64 array -> array).
        extrema_reduce: elementwise MAX across workers; defaults to
        identity. Both default to single-process."""
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        reduce_sum = histogram_reduce or (lambda a: a)
        reduce_max = extrema_reduce or (lambda a: a)
        N, F = X.shape

        # global feature ranges -> shared uniform bin edges
        lo = X.min(axis=0) if N else np.full(F, np.inf)
        hi = X.max(axis=0) if N else np.full(F, -np.inf)
        ext = reduce_max(np.concatenate([-lo, hi]))
        glo, ghi = -ext[:F], ext[F:]
        span = np.where(ghi > glo, ghi - glo, 1.0)
        # n_bins-1 interior edges -> bin ids in [0, n_bins-1]
        steps = np.arange(1, self.n_bins, dtype=np.float64) / self.n_bins
        self.bin_edges = glo[:, None] + span[:, None] * steps[None, :]

        # base score: global mean (sum trick over [sum_y, count])
        agg = reduce_sum(np.array([y.sum(), float(N)]))
        mean = agg[0] / max(agg[1], 1.0)
        if self.objective == "binary:logistic":
            p = np.clip(mean, 1e-6, 1 - 1e-6)
            self.base_score = float(np.log(p / (1 - p)))
        else:
            self.base_score = float(mean)

        B = self._bin(X)
        pred = np.full(N, self.base_score)
        for _ in range(self.n_estimators):
            if self.objective == "binary:logistic":
                prob = _sigmoid(pred)
                g, h = prob - y, np.maximum(prob * (1 - prob), 1e-12)
            else:
                g, h = pred - y, np.ones(N)
            tree = self._grow_tree(B, g, h, reduce_sum)
            self.trees.append(tree)
            pred += self._predict_binned(tree, B)
            if eval_cb is not None and eval_every and len(self.trees) % eval_every == 0:
                eval_cb(len(self.trees), self._metrics(pred, y, reduce_sum))
        return self._metrics(pred, y, reduce_sum)

    def _metrics(self, pred, y, reduce_sum) -> dict:
        if self.objective == "binary:logistic":
            p = np.clip(_sigmoid(pred), 1e-12, 1 - 1e-12)
            ll = -(y * np.log(p) + (1 - y) * np.log(1 - p))
            err = (p > 0.5).astype(np.float64) != y
            agg = reduce_sum(np.array([ll.sum(), err.sum(), float(len(y))]))
            n = max(agg[2], 1.0)
            return {"logloss": agg[0] / n, "error": agg[1] / n}
        se = (pred - y) ** 2
        agg = reduce_sum(np.array([se.sum(), float(len(y))]))
        return {"rmse": float(np.sqrt(agg[0] / max(agg[1], 1.0)))}

    def _grow_tree(self, B, g, h, reduce_sum) -> _Node:
        root_rows = np.arange(len(g))
        gh = reduce_sum(np.array([g.sum(), h.sum()]))
        return self._split_node(B, g, h, root_rows, gh[0], gh[1], 0, reduce_sum)

    def _split_node(self, B, g, h, rows, G, H, depth, reduce_sum) -> _Node:
        lam = self.reg_lambda
        leaf = _Node(leaf_value=float(-G / (H + lam) * self.learning_rate))
        if depth >= self.max_depth or H < 2 * self.min_child_weight:
            return leaf

        # per-(feature, bin) gradient histogram on local rows, then SUM
        # across workers — the one communication per node (xgboost hist)
        F = B.shape[1]
        nb = self.n_bins
        hist = np.zeros((2, F, nb), np.float64)
        if len(rows):
            sub = B[rows]
            gr, hr = g[rows], h[rows]
            for f in range(F):
                hist[0, f] = np.bincount(sub[:, f], weights=gr, minlength=nb)[:nb]
                hist[1, f] = np.bincount(sub[:, f], weights=hr, minlength=nb)[:nb]
        hist = reduce_sum(hist.ravel()).reshape(2, F, nb)

        GL = np.cumsum(hist[0], axis=1)[:, :-1]  # left sums per split point
        HL = np.cumsum(hist[1], axis=1)[:, :-1]
        GR, HR = G - GL, H - HL
        parent = G * G / (H + lam)
        gain = GL * GL / (HL + lam) + GR * GR / (HR + lam) - parent
        gain = np.where((HL >= self.min_child_weight) & (HR >= self.min_child_weight), gain, -np.inf)
        f_best, b_best = np.unravel_index(int(np.argmax(gain)), gain.shape)
        if not np.isfinite(gain[f_best, b_best]) or gain[f_best, b_best] <= self.min_gain:
            return leaf

        mask = B[rows, f_best] <= b_best
        left_rows, right_rows = rows[mask], rows[~mask]
        node = _Node(feature=int(f_best), threshold_bin=int(b_best))
        node.left = self._split_node(B, g, h, left_rows, GL[f_best, b_best], HL[f_best, b_best], depth + 1, reduce_sum)
        node.right = self._split_node(B, g, h, right_rows, GR[f_best, b_best], HR[f_best, b_best], depth + 1, reduce_sum)
        return node

    # -- inference -----------------------------------------------------
    def _predict_binned(self, tree: _Node, B) -> np.ndarray:
        # vectorized level-order walk: rows carry their current node
        out = np.empty(len(B))
        stack = [(tree, np.arange(len(B)))]
        while stack:
            node, idx = stack.pop()
            if node.feature is None:
                out[idx] = node.leaf_value
                continue
            mask = B[idx, node.feature] <= node.threshold_bin
            stack.append((node.left, idx[mask]))
            stack.append((node.right, idx[~mask]))
        return out

    def predict(self, X) -> np.ndarray:
        """Raw margin (regression value / logit)."""
        X = np.asarray(X, np.float64)
        B = self._bin(X)
        pred = np.full(len(X), self.base_score)
        for t in self.trees:
            pred += self._predict_binned(t, B)
        return pred

    def predict_proba(self, X) -> np.ndarray:
        assert self.objective == "binary:logistic"
        return _sigmoid(self.predict(X))


def _shard_to_numpy(shard, label_column: str):
    rows_X, rows_y = [], []
    for batch in shard.iter_batches(batch_size=4096):
        y = np.asarray(batch[label_column], np.float64)
        feats = [np.asarray(batch[k], np.float64).reshape(len(y), -1) for k in sorted(batch) if k != label_column]
        rows_X.append(np.concatenate(feats, axis=1))
        rows_y.append(y)
    if not rows_X:
        return np.zeros((0, 1)), np.zeros(0)
    return np.concatenate(rows_X), np.concatenate(rows_y)


class _GBDTLoop:
    """The train loop of a GBDT fit: a module-level class, so a worker can
    receive it (the port's loops travel by reference)."""

    def __init__(self, label_column: str, params: dict, num_boost_round: int):
        self.label_column = label_column
        self.params = params
        self.num_boost_round = num_boost_round

    def __call__(self, config):
        import pickle
        import tempfile

        from ray_tpu_torch import train
        from ray_tpu_torch.train import collective as tcol
        from ray_tpu_torch.train import session

        ctx = train.get_context()
        shard = session.get_dataset_shard("train")
        X, y = _shard_to_numpy(shard, self.label_column)

        multi = ctx.get_world_size() > 1
        reduce_sum = tcol.allreduce if multi else None
        extrema = None
        if multi:
            from ray_tpu_torch.collective import ReduceOp

            def extrema(a):
                return tcol.allreduce(a, op=ReduceOp.MAX)

            # agree on the global feature width first: a rank whose shard
            # got zero blocks (block count < world size) has X of shape
            # (0, 1) and would feed wrong-shaped buffers into every later
            # reduce, wedging the whole group
            f_global = int(extrema(np.array([float(X.shape[1] if len(X) else 0)]))[0])
            if len(X) == 0:
                X = np.zeros((0, max(f_global, 1)))
            elif X.shape[1] != f_global:
                raise ValueError(
                    f"rank {ctx.get_world_rank()}: shard has {X.shape[1]} feature "
                    f"columns but the group agreed on {f_global}"
                )

        model = HistGBDT(n_estimators=self.num_boost_round, **self.params)
        final = model.fit(X, y, histogram_reduce=reduce_sum, extrema_reduce=extrema)
        if ctx.get_world_rank() == 0:
            d = tempfile.mkdtemp()
            with open(f"{d}/model.pkl", "wb") as f:
                pickle.dump(model, f)
            session.report({"trees": len(model.trees), **final}, checkpoint=train.Checkpoint.from_directory(d))
        else:
            session.report({"trees": len(model.trees), **final})


class GBDTTrainer(DataParallelTrainer):
    """Data-parallel GBDT over dataset shards. Workers sync per-node
    gradient histograms through the train collective and grow identical
    trees."""

    def __init__(
        self,
        *,
        datasets: dict,
        label_column: str,
        params: dict | None = None,
        num_boost_round: int = 20,
        scaling_config=None,
        run_config=None,
        **kw,
    ):
        params = dict(params or {})
        super().__init__(
            _GBDTLoop(label_column, params, num_boost_round),
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            **kw,
        )

    @staticmethod
    def get_model(checkpoint) -> HistGBDT:
        """Load the fitted model back from a Result checkpoint."""
        import os
        import pickle

        with open(os.path.join(checkpoint.path, "model.pkl"), "rb") as f:
            return pickle.load(f)


_XGB_PARAM_MAP = {
    "eta": "learning_rate",
    "learning_rate": "learning_rate",
    "max_depth": "max_depth",
    "lambda": "reg_lambda",
    "reg_lambda": "reg_lambda",
    "objective": "objective",
    "min_child_weight": "min_child_weight",
    "max_bin": "n_bins",
}

_LGBM_PARAM_MAP = {
    **_XGB_PARAM_MAP,
    "num_leaves": None,  # depth-wise growth here; accepted and ignored
    "lambda_l2": "reg_lambda",
}


def _map_params(params: dict, table: dict, trainer: str) -> dict:
    out = {}
    for k, v in (params or {}).items():
        if k not in table:
            raise ValueError(f"{trainer}: unsupported param {k!r} (supported: {sorted(table)})")
        tgt = table[k]
        if tgt is not None:
            out[tgt] = v
    if out.get("objective") not in (None, "reg:squarederror", "binary:logistic"):
        raise ValueError(f"{trainer}: objective {out['objective']!r} not supported by the native engine")
    return out


class XGBoostTrainer(GBDTTrainer):
    """xgboost's parameter names over the numpy histogram engine (the
    hist + allreduce algorithm xgboost runs)."""

    def __init__(self, *, params: dict | None = None, num_boost_round: int = 20, **kw):
        super().__init__(params=_map_params(params, _XGB_PARAM_MAP, "XGBoostTrainer"), num_boost_round=num_boost_round, **kw)


class LightGBMTrainer(GBDTTrainer):
    """lightgbm's parameter names over the numpy histogram engine."""

    def __init__(self, *, params: dict | None = None, num_boost_round: int = 20, **kw):
        super().__init__(params=_map_params(params, _LGBM_PARAM_MAP, "LightGBMTrainer"), num_boost_round=num_boost_round, **kw)
