"""Searchers (port of ray_tpu/tune/search.py): basic variants (grid x
random), the concurrency limiter, TPE and GP-EI Bayesian optimisation in
numpy, and the Optuna adapter (``optuna`` imported lazily; ImportError
where it is absent). Given the same seed and the same completed results,
each suggests exactly what ray_tpu's does.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.tune.search_space import expand_grid, resolve


class Searcher:
    def set_search_properties(self, metric, mode, space):
        self.metric, self.mode, self.space = metric, mode, space

    def suggest(self, trial_id: str) -> dict | None:
        """None = search exhausted."""
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: dict | None = None, error: bool = False):
        pass


class BasicVariantGenerator(Searcher):
    """Grid expansion x num_samples random sampling (reference:
    search/basic_variant.py)."""

    def __init__(self, num_samples: int = 1, seed: int | None = None):
        self.num_samples = num_samples
        self.rng = np.random.default_rng(seed)
        self._queue: list[dict] | None = None

    def set_search_properties(self, metric, mode, space):
        super().set_search_properties(metric, mode, space)
        self._queue = []
        for _ in range(self.num_samples):
            for variant in expand_grid(space):
                self._queue.append(variant)

    def suggest(self, trial_id):
        if not self._queue:
            return None
        variant = self._queue.pop(0)
        return resolve(variant, self.rng)


class OptunaSearch(Searcher):
    """Optuna TPE adapter (reference: search/optuna/optuna_search.py).
    Requires `optuna` (not baked into this image — gated import)."""

    def __init__(self, metric=None, mode=None, seed=None, num_samples: int = 64):
        try:
            import optuna
        except ImportError as e:
            raise ImportError(
                "OptunaSearch requires the 'optuna' package, which is not "
                "installed in this environment"
            ) from e
        self._optuna = optuna
        self.metric = metric
        self.mode = mode
        self.seed = seed
        self.remaining = num_samples
        self._trials: dict[str, object] = {}

    def set_search_properties(self, metric, mode, space):
        # the searcher's own explicit settings win over TuneConfig fallbacks
        super().set_search_properties(self.metric or metric, self.mode or mode or "max", space)
        sampler = self._optuna.samplers.TPESampler(seed=self.seed)
        direction = "maximize" if self.mode == "max" else "minimize"
        self._study = self._optuna.create_study(sampler=sampler, direction=direction)

    def suggest(self, trial_id):
        if self.remaining <= 0:
            return None
        self.remaining -= 1
        from ray_tpu_torch.tune.search_space import Categorical, Float, Integer

        ot = self._study.ask()
        self._trials[trial_id] = ot
        config = {}
        for k, v in self.space.items():
            if isinstance(v, Categorical):
                config[k] = ot.suggest_categorical(k, v.categories)
            elif isinstance(v, Float):
                config[k] = ot.suggest_float(k, v.lower, v.upper, log=v.log)
            elif isinstance(v, Integer):
                config[k] = ot.suggest_int(k, v.lower, v.upper - 1, log=v.log)
            else:
                config[k] = v
        return config

    def on_trial_complete(self, trial_id, result=None, error=False):
        ot = self._trials.pop(trial_id, None)
        if ot is None:
            return
        if error or result is None or self.metric not in result:
            self._study.tell(ot, state=self._optuna.trial.TrialState.FAIL)
        else:
            self._study.tell(ot, result[self.metric])


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggests (reference: search/concurrency_limiter.py)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set[str] = set()

    def set_search_properties(self, metric, mode, space):
        self.searcher.set_search_properties(metric, mode, space)

    def suggest(self, trial_id):
        if len(self._live) >= self.max_concurrent:
            return "__WAIT__"
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None and cfg != "__WAIT__":
            self._live.add(trial_id)
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result=result, error=error)


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator search (reference: the BO half of
    BOHB — tune/search/bohb uses the same KDE-over-good/bad-split model;
    Bergstra et al. 2011). Completed trials split at the gamma quantile
    into good/bad sets; each numeric dimension gets a kernel density
    estimate per set, and suggestions maximize the density ratio
    l_good(x)/l_bad(x) over sampled candidates. Categorical dimensions
    use smoothed category frequencies. Compose with ASHAScheduler for
    the BOHB setup (multi-fidelity HyperBand elimination + model-based
    proposals):

        tune.TuneConfig(search_alg=tune.TPESearcher(num_samples=32),
                        scheduler=tune.ASHAScheduler(...))
    """

    def __init__(
        self,
        num_samples: int = 16,
        *,
        metric: str | None = None,
        mode: str | None = None,
        n_startup_trials: int = 6,
        gamma: float = 0.25,
        n_candidates: int = 64,
        seed: int | None = None,
    ):
        self.metric = metric
        self.mode = mode
        self.remaining = num_samples
        self.n_startup = int(n_startup_trials)
        self.gamma = float(gamma)
        self.n_candidates = int(n_candidates)
        self.rng = np.random.default_rng(seed)
        self._configs: dict[str, dict] = {}
        self._observed: list[tuple[dict, float]] = []

    def set_search_properties(self, metric, mode, space):
        super().set_search_properties(self.metric or metric, self.mode or mode or "max", space)
        for k, v in space.items():
            if isinstance(v, dict):
                raise ValueError(
                    f"TPESearcher supports flat search spaces; flatten nested key {k!r} "
                    "(or use BasicVariantGenerator/OptunaSearch)"
                )

    # -- observation feed --
    def on_trial_complete(self, trial_id, result=None, error=False):
        cfg = self._configs.pop(trial_id, None)
        if cfg is None or error or result is None or self.metric not in result:
            return
        score = float(result[self.metric])
        self._observed.append((cfg, score if self.mode == "max" else -score))

    # -- model --
    def _split(self):
        ranked = sorted(self._observed, key=lambda cv: cv[1], reverse=True)
        k = max(1, int(len(ranked) * self.gamma))
        return [c for c, _ in ranked[:k]], [c for c, _ in ranked[k:]] or [c for c, _ in ranked[:k]]

    @staticmethod
    def _kde_logpdf(xs: np.ndarray, obs: np.ndarray, lo: float, hi: float) -> np.ndarray:
        """1-d Gaussian KDE with Scott bandwidth, floored to 10% of range."""
        bw = max(1.06 * (np.std(obs) + 1e-12) * len(obs) ** -0.2, 0.1 * (hi - lo), 1e-12)
        d = (xs[:, None] - obs[None, :]) / bw
        return np.log(np.exp(-0.5 * d * d).sum(1) + 1e-300)

    def _score_dim(self, domain, cand_vals, good_cfgs, bad_cfgs, key):
        from ray_tpu_torch.tune.search_space import Categorical, Float, Integer

        if isinstance(domain, Categorical):
            cats = list(domain.categories)
            def freq(cfgs):
                counts = np.array([sum(1 for c in cfgs if c.get(key) == cat) for cat in cats], np.float64)
                p = (counts + 1.0) / (counts.sum() + len(cats))  # Laplace smoothing
                return {cat: np.log(pi) for cat, pi in zip(cats, p)}
            lg, lb = freq(good_cfgs), freq(bad_cfgs)
            return np.array([lg[v] - lb[v] for v in cand_vals])
        if isinstance(domain, (Float, Integer)):
            log = bool(getattr(domain, "log", False))
            tx = (lambda a: np.log(np.asarray(a, np.float64))) if log else (lambda a: np.asarray(a, np.float64))
            lo, hi = tx(domain.lower), tx(domain.upper)
            xs = tx(cand_vals)
            g = self._kde_logpdf(xs, tx([c[key] for c in good_cfgs]), lo, hi)
            b = self._kde_logpdf(xs, tx([c[key] for c in bad_cfgs]), lo, hi)
            return g - b
        return np.zeros(len(cand_vals))

    # -- suggestion --
    def suggest(self, trial_id):
        from ray_tpu_torch.tune.search_space import Domain, SampleFrom

        if self.remaining <= 0:
            return None
        self.remaining -= 1
        dims = {k: v for k, v in self.space.items() if isinstance(v, Domain) and not isinstance(v, SampleFrom)}
        derived = {k: v for k, v in self.space.items() if isinstance(v, SampleFrom)}
        fixed = {k: v for k, v in self.space.items() if not isinstance(v, Domain)}
        if len(self._observed) < self.n_startup or not dims:
            cfg = {**fixed, **{k: d.sample(self.rng) for k, d in dims.items()}}
        else:
            good, bad = self._split()
            cands = [{k: d.sample(self.rng) for k, d in dims.items()} for _ in range(self.n_candidates)]
            total = np.zeros(self.n_candidates)
            for k, d in dims.items():
                total += self._score_dim(d, [c[k] for c in cands], good, bad, k)
            cfg = {**fixed, **cands[int(np.argmax(total))]}
        for k, d in derived.items():
            # sample_from fns see the partially-resolved config (they are
            # DERIVED values, not searched dimensions — excluded from the
            # TPE model on both the suggest and observe sides)
            cfg[k] = d.sample(self.rng, cfg)
        self._configs[trial_id] = cfg
        return dict(cfg)


class BayesOptSearcher(Searcher):
    """Gaussian-process Bayesian optimization with Expected Improvement
    (reference capability: tune/search/bayesopt/bayesopt_search.py wraps
    the external bayesian-optimization package; here the GP — RBF kernel
    with jitter over unit-cube-normalized inputs — and the EI acquisition
    are implemented natively, so the searcher works with zero extra
    dependencies).

    Numeric dimensions normalize to [0, 1] (log-aware); categoricals
    one-hot into the kernel. Suggestions before ``n_startup_trials``
    observations are random; afterwards EI is maximized over
    ``n_candidates`` sampled points.
    """

    def __init__(
        self,
        num_samples: int = 16,
        *,
        metric: str | None = None,
        mode: str | None = None,
        n_startup_trials: int = 5,
        n_candidates: int = 256,
        xi: float = 0.01,
        noise: float = 1e-4,
        seed: int | None = None,
    ):
        self.metric = metric
        self.mode = mode
        self.remaining = num_samples
        self.n_startup = int(n_startup_trials)
        self.n_candidates = int(n_candidates)
        self.xi = float(xi)
        self.noise = float(noise)
        self.rng = np.random.default_rng(seed)
        self._configs: dict[str, dict] = {}
        self._observed: list[tuple[dict, float]] = []

    def set_search_properties(self, metric, mode, space):
        super().set_search_properties(self.metric or metric, self.mode or mode or "max", space)
        for k, v in space.items():
            if isinstance(v, dict):
                raise ValueError(f"BayesOptSearcher supports flat search spaces; flatten nested key {k!r}")

    def on_trial_complete(self, trial_id, result=None, error=False):
        cfg = self._configs.pop(trial_id, None)
        if cfg is None or error or result is None or self.metric not in result:
            return
        score = float(result[self.metric])
        self._observed.append((cfg, score if self.mode == "max" else -score))

    # -- featurization: config dict -> unit-cube vector --
    def _dims(self):
        from ray_tpu_torch.tune.search_space import Categorical, Domain, Float, Integer, SampleFrom

        out = []
        for k, v in self.space.items():
            if isinstance(v, (Float, Integer)):
                out.append((k, v, "num"))
            elif isinstance(v, Categorical):
                out.append((k, v, "cat"))
            elif isinstance(v, Domain) and not isinstance(v, SampleFrom):
                out.append((k, v, "other"))
        return out

    def _encode(self, cfg, dims):
        feats = []
        for k, d, kind in dims:
            if kind == "num":
                log = bool(getattr(d, "log", False))
                lo, hi = (np.log(d.lower), np.log(d.upper)) if log else (d.lower, d.upper)
                x = np.log(cfg[k]) if log else cfg[k]
                feats.append((float(x) - lo) / max(hi - lo, 1e-12))
            elif kind == "cat":
                cats = list(d.categories)
                one = [0.0] * len(cats)
                if cfg[k] in cats:
                    one[cats.index(cfg[k])] = 1.0
                feats.extend(one)
            else:
                feats.append(0.0)
        return np.asarray(feats, np.float64)

    @staticmethod
    def _rbf(a, b, ls=0.2):
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (ls * ls))

    def suggest(self, trial_id):
        from ray_tpu_torch.tune.search_space import Domain, SampleFrom

        if self.remaining <= 0:
            return None
        self.remaining -= 1
        dims = self._dims()
        searched = {k for k, _, _ in dims}
        derived = {k: v for k, v in self.space.items() if isinstance(v, SampleFrom)}
        fixed = {k: v for k, v in self.space.items() if not isinstance(v, Domain) and k not in searched}

        def random_cfg():
            return {**fixed, **{k: d.sample(self.rng) for k, d, _ in dims}}

        if len(self._observed) < self.n_startup or not dims:
            cfg = random_cfg()
        else:
            X = np.stack([self._encode(c, dims) for c, _ in self._observed])
            y = np.asarray([s for _, s in self._observed], np.float64)
            y_mean, y_std = y.mean(), max(y.std(), 1e-12)
            yn = (y - y_mean) / y_std
            K = self._rbf(X, X) + self.noise * np.eye(len(X))
            try:
                L = np.linalg.cholesky(K)
            except np.linalg.LinAlgError:
                L = np.linalg.cholesky(K + 1e-6 * np.eye(len(X)))
            alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
            cands = [random_cfg() for _ in range(self.n_candidates)]
            Xc = np.stack([self._encode(c, dims) for c in cands])
            Ks = self._rbf(Xc, X)  # [C, N]
            mu = Ks @ alpha
            v = np.linalg.solve(L, Ks.T)  # [N, C]
            var = np.maximum(1.0 - (v * v).sum(0), 1e-12)
            sigma = np.sqrt(var)
            best = yn.max()
            z = (mu - best - self.xi) / sigma
            # EI = sigma * (z*Phi(z) + phi(z)) without scipy
            phi = np.exp(-0.5 * z * z) / np.sqrt(2 * np.pi)
            from math import erf

            Phi = 0.5 * (1.0 + np.vectorize(erf)(z / np.sqrt(2.0)))
            ei = sigma * (z * Phi + phi)
            cfg = cands[int(np.argmax(ei))]
        for k, d in derived.items():
            cfg[k] = d.sample(self.rng, cfg)
        self._configs[trial_id] = cfg
        return cfg
