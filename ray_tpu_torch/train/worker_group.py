"""WorkerGroup: one training-worker actor per bundle of a placement group
(port of ray_tpu/train/worker_group.py).

The ``TrainWorker`` actor runs the user loop in a thread of its own, so
``poll()`` and ``execute_fn()`` stay responsive while it trains. Its
resources are ``ScalingConfig._worker_resources``: a worker that asks for
``"GPU"`` gets it from its bundle and the runtime forks its process bound
to that card (``CUDA_VISIBLE_DEVICES``), as it does a ``num_gpus`` actor.
Inside an enclosing Tune trial (``RT_TRIAL_PG``) the workers take the
trial's bundles 1..N instead of reserving a group of their own.
"""

from __future__ import annotations

import inspect
import os
import queue
import threading
import traceback
import uuid

import ray_tpu_torch
from ray_tpu_torch.train import context as _ctx
from ray_tpu_torch.train._checkpoint import Checkpoint


@ray_tpu_torch.remote(max_concurrency=8)
class TrainWorker:
    """One per bundle. The user train loop runs in a dedicated thread so
    poll()/execute_fn() stay responsive."""

    def __init__(self, world_rank: int, env_vars: dict | None = None):
        self.world_rank = world_rank
        for k, v in (env_vars or {}).items():
            os.environ[k] = str(v)
        self._reports: queue.Queue = queue.Queue()
        self._thread = None
        self._status = "idle"
        self._error = None

    def setup_context(
        self,
        world_size: int,
        local_rank: int,
        local_world_size: int,
        node_rank: int,
        experiment_name: str,
        latest_checkpoint_path: str | None,
        dataset_shards: dict | None = None,
        attempt_uid: str = "0",
        num_gpus: float = 0,
    ):
        ckpt = Checkpoint(latest_checkpoint_path) if latest_checkpoint_path else None
        ctx = _ctx.TrainContext(
            world_size=world_size,
            world_rank=self.world_rank,
            local_rank=local_rank,
            local_world_size=local_world_size,
            node_rank=node_rank,
            experiment_name=experiment_name,
            report_fn=self._on_report,
            latest_checkpoint=ckpt,
            dataset_shards=dataset_shards,
            attempt_uid=attempt_uid,
            num_gpus=num_gpus,
        )
        _ctx.set_context(ctx)
        return True

    def _on_report(self, seq, metrics, checkpoint, checkpoint_dir_name):
        self._reports.put(
            {
                "seq": seq,
                "metrics": metrics,
                "checkpoint_path": checkpoint.path if checkpoint is not None else None,
                "checkpoint_dir_name": checkpoint_dir_name,
            }
        )

    def execute_fn(self, fn, *args, **kwargs):
        """Run a callable in the worker process (the backends' hooks)."""
        return fn(*args, **kwargs)

    def run_train_fn(self, train_fn, config):
        """Blocking: runs the user loop in a thread, joins it, re-raises."""
        self._status = "running"

        def target():
            try:
                if len(inspect.signature(train_fn).parameters) == 0:
                    train_fn()
                else:
                    train_fn(config or {})
                self._status = "finished"
            except BaseException as e:  # noqa: BLE001
                self._error = (e, traceback.format_exc())
                self._status = "error"

        self._thread = threading.Thread(target=target, name="rt-train-loop", daemon=True)
        self._thread.start()
        self._thread.join()
        if self._status == "error":
            e, tb = self._error
            raise RuntimeError(f"train loop failed on rank {self.world_rank}:\n{tb}") from e
        return self.world_rank

    def poll(self):
        """Drain pending reports (called by the controller every tick)."""
        out = []
        while True:
            try:
                out.append(self._reports.get_nowait())
            except queue.Empty:
                break
        return {"status": self._status, "reports": out}

    def node_info(self):
        nid = ray_tpu_torch.get_runtime_context().node_id
        return {"node_id": str(nid) if nid is not None else None, "pid": os.getpid()}


class WorkerGroup:
    def __init__(self, scaling_config, experiment_name: str, env_vars: dict | None = None):
        self.scaling = scaling_config
        self.experiment_name = experiment_name
        self.env_vars = env_vars
        self.workers: list = []
        self._pg = None
        self.num_workers = scaling_config.num_workers
        self.attempt_uid = None  # set per start(); scopes per-attempt named actors

    def __len__(self):
        return len(self.workers)

    def _trial_placement_group(self):
        """The enclosing Tune trial's gang reservation, when its bundle
        count covers this group's workers (bundle 0 is the trial driver)."""
        pg_hex = os.environ.get("RT_TRIAL_PG")
        if not pg_hex:
            return None
        from ray_tpu_torch.core.ids import PlacementGroupID
        from ray_tpu_torch.util.placement_group import PlacementGroup

        pg = PlacementGroup(PlacementGroupID.from_hex(pg_hex))
        specs = pg.bundle_specs
        if len(specs) < self.num_workers + 1:
            # an own group here would double-book: the trial's gang stays
            # reserved while a second group queues. Fail fast instead.
            raise ValueError(
                f"trial placement group has {len(specs)} bundles but the worker group needs "
                f"{self.num_workers + 1} (driver + workers); size the PlacementGroupFactory "
                "to the trainer's maximum worker count"
            )
        res = self.scaling._worker_resources
        for b in specs[1 : self.num_workers + 1]:
            if any(b.get(k, 0) < v for k, v in res.items() if v > 0):
                # a too-small bundle would leave the worker unschedulable forever
                raise ValueError(
                    f"trial placement group bundle {b} cannot fit worker resources {res}; "
                    "size the PlacementGroupFactory worker bundles to the trainer's "
                    "resources_per_worker"
                )
        return pg

    # ---------------- lifecycle ----------------
    def start(self, latest_checkpoint_path: str | None = None, dataset_split_fn=None):
        from ray_tpu_torch.util.placement_group import placement_group

        res = self.scaling._worker_resources
        trial_pg = self._trial_placement_group()
        if trial_pg is not None:
            pg, owned = trial_pg, False
        else:
            bundles = [dict(res) for _ in range(self.num_workers)]
            pg, owned = placement_group(bundles, strategy=self.scaling.placement_strategy), True
            self._pg = pg  # only an owned group is removed at shutdown
            pg.wait()
        actor_opts = []
        for i in range(self.num_workers):
            opts = dict(
                num_cpus=res.get("CPU", 1),
                placement_group=pg,
                placement_group_bundle_index=i + (0 if owned else 1),
            )
            extra = {k: v for k, v in res.items() if k != "CPU"}
            if extra:
                opts["resources"] = extra  # "GPU" among them binds the worker to its card
            actor_opts.append(opts)

        self.attempt_uid = uuid.uuid4().hex[:8]
        self.workers = [
            TrainWorker.options(**opts).remote(world_rank=i, env_vars=self.env_vars)
            for i, opts in enumerate(actor_opts)
        ]
        # local ranks: workers sharing a node get consecutive local ranks
        infos = ray_tpu_torch.get([w.node_info.remote() for w in self.workers])
        by_node: dict = {}
        local_ranks, node_ranks = [], []
        for info in infos:
            node = info["node_id"] or "local"
            node_rank = list(by_node).index(node) if node in by_node else len(by_node)
            lr = by_node.setdefault(node, 0)
            by_node[node] += 1
            local_ranks.append(lr)
            node_ranks.append(node_rank)
        shards = dataset_split_fn(self.num_workers) if dataset_split_fn else [None] * self.num_workers
        ray_tpu_torch.get(
            [
                w.setup_context.remote(
                    self.num_workers,
                    local_ranks[i],
                    by_node[infos[i]["node_id"] or "local"],
                    node_ranks[i],
                    self.experiment_name,
                    latest_checkpoint_path,
                    shards[i],
                    self.attempt_uid,
                    res.get("GPU", 0),
                )
                for i, w in enumerate(self.workers)
            ]
        )

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        if self._pg is not None:
            from ray_tpu_torch.util.placement_group import remove_placement_group

            try:
                remove_placement_group(self._pg)
            except Exception:
                pass
            self._pg = None

    # ---------------- execution ----------------
    def execute_async(self, fn, *args, **kwargs):
        return [w.execute_fn.remote(fn, *args, **kwargs) for w in self.workers]

    def execute(self, fn, *args, **kwargs):
        return ray_tpu_torch.get(self.execute_async(fn, *args, **kwargs))

    def execute_single(self, rank: int, fn, *args, **kwargs):
        return ray_tpu_torch.get(self.workers[rank].execute_fn.remote(fn, *args, **kwargs))

    def run_train_async(self, train_fn, config):
        return [w.run_train_fn.remote(train_fn, config) for w in self.workers]

    def poll(self):
        return ray_tpu_torch.get([w.poll.remote() for w in self.workers])
