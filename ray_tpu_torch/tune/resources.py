"""Trial resource requests: flat dicts or gang-reserved placement groups
(port of ray_tpu/tune/resources.py).

A trial that spawns its own worker actors (a Tuner over a Trainer)
reserves ALL its capacity atomically up front: bundle 0 hosts the trial
driver, bundles 1..N host its workers. Without this, N-worker trials
admitted on flat CPU counts oversubscribe the cluster and thrash; with
it, trials that don't fit stay PENDING until a whole gang frees up.

The card: a bundle's ``"TPU"`` (ray_tpu's name) folds into ``"GPU"`` when
the group is reserved, as ``ScalingConfig`` folds a worker's, so a trial
that asks for either gets the card (``tune_controller.py``).
"""

from __future__ import annotations

from ray_tpu_torch.accelerators.gpu import fold_card


class PlacementGroupFactory:
    """Recipe for a trial's placement group.

    PlacementGroupFactory([{"CPU": 1}, {"CPU": 1}, {"CPU": 1}])
    reserves one driver bundle + two worker bundles per trial; the
    trial's train WorkerGroup schedules its workers into bundles 1..N
    (plumbed via the trial context)."""

    def __init__(self, bundles: list[dict], strategy: str = "PACK"):
        if not bundles or any(not b for b in bundles):
            raise ValueError("bundles must be a non-empty list of non-empty resource dicts")
        self.bundles = [dict(b) for b in bundles]
        self.strategy = strategy

    @property
    def head_bundle(self) -> dict:
        return self.bundles[0]

    def create(self, name: str = ""):
        from ray_tpu_torch.util.placement_group import placement_group

        return placement_group([fold_card(b) for b in self.bundles], strategy=self.strategy, name=name)

    def required_resources(self) -> dict:
        out: dict = {}
        for b in self.bundles:
            for k, v in b.items():
                out[k] = out.get(k, 0) + v
        return out

    def __repr__(self):
        return f"PlacementGroupFactory({self.bundles}, strategy={self.strategy!r})"


class _WithResources:
    """A function trainable carrying a resource request: ray_tpu's
    ``wrapped`` closure as a module-level class, so that it travels to
    the trial actor under the standard library's pickle."""

    def __init__(self, trainable, resources):
        self.trainable = trainable
        self._tune_resources = resources

    def __call__(self, *a, **kw):
        return self.trainable(*a, **kw)


def with_resources(trainable, resources):
    """Return a copy of the trainable carrying a resource request (dict
    or PlacementGroupFactory); the original is untouched so it can be
    reused with different resources (reference: tune.with_resources)."""
    import copy

    if callable(trainable) and not hasattr(trainable, "fit"):
        return _WithResources(trainable, resources)
    clone = copy.copy(trainable)  # trainers: shallow copy, new attr only
    clone._tune_resources = resources
    return clone
