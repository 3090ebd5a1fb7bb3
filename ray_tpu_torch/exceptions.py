"""Exception types, the port's own copy of the part of
ray_tpu/exceptions.py that it raises: the serving-error taxonomy
(admission and shedding, the KV handoff and live-migration errors, the
routers' terminal errors, the chaos plane's injected fault) and the
runtime's errors (``RayTpuError``, ``TaskError`` with its ``.cause`` and
``tb_str``, pickled as ray_tpu pickles it, ``ObjectLostError``,
``GetTimeoutError``, the worker, actor and node deaths, an unplaceable
placement group, the pending-calls limit, out of memory and a failed
runtime_env).

``SERVING_ERRORS`` maps each typed error a client or a router may observe
to its HTTP status code and a retryable flag, keyed by class name, with
ray_tpu's codes and flags unchanged. A defining module binds its class to
its row with ``@serving_error``, which refuses a name the table lacks and
stamps ``status_code``/``retryable`` on the class.
"""

from __future__ import annotations

import traceback
from dataclasses import dataclass


@dataclass(frozen=True)
class ServingErrorSpec:
    """How one typed serving error crosses the HTTP boundary."""

    status_code: int
    retryable: bool  # may the client/router retry (elsewhere or later)?


SERVING_ERRORS: dict[str, ServingErrorSpec] = {
    # admission / shedding (serve/overload.py)
    "OverloadedError": ServingErrorSpec(429, retryable=True),
    "ReplicaDrainingError": ServingErrorSpec(429, retryable=True),
    # replica stepper death (serve/overload.py): another replica serves
    "StepperDiedError": ServingErrorSpec(503, retryable=True),
    # object plane / ownership (this module)
    "ObjectLostError": ServingErrorSpec(503, retryable=True),
    "ObjectReconstructionError": ServingErrorSpec(503, retryable=True),
    "GetTimeoutError": ServingErrorSpec(504, retryable=True),
    "ActorDiedError": ServingErrorSpec(503, retryable=True),
    "ActorUnavailableError": ServingErrorSpec(503, retryable=True),
    "WorkerCrashedError": ServingErrorSpec(503, retryable=True),
    # live migration (llm/migrate.py): a lost checkpoint fails over, a
    # malformed one is a hard fault (garbage must never reach a pool)
    "MigrationError": ServingErrorSpec(500, retryable=False),
    "MigrationLostError": ServingErrorSpec(503, retryable=True),
    "RequestMigratedError": ServingErrorSpec(503, retryable=True),
    # disagg handoff codec (llm/disagg/handoff.py)
    "HandoffError": ServingErrorSpec(500, retryable=False),
    "HandoffLostError": ServingErrorSpec(503, retryable=True),
    # router terminal failures (llm/disagg/router.py, llm/kvplane/routing.py)
    "DisaggRequestError": ServingErrorSpec(500, retryable=False),
    "KVRouteError": ServingErrorSpec(500, retryable=False),
    # injected faults (chaos.py) that escape a degradation path
    "ChaosError": ServingErrorSpec(500, retryable=False),
}


def serving_error(cls):
    """Class decorator binding a taxonomy class to its registered spec.
    Refuses names missing from ``SERVING_ERRORS`` and stamps
    ``status_code``/``retryable`` on the class."""
    spec = SERVING_ERRORS.get(cls.__name__)
    if spec is None:
        raise KeyError(
            f"{cls.__name__} is not in exceptions.SERVING_ERRORS — add its "
            "(status_code, retryable) row before decorating"
        )
    cls.status_code = spec.status_code
    cls.retryable = spec.retryable
    return cls


def serving_error_spec(e) -> ServingErrorSpec | None:
    """Spec for an exception instance or class, by MRO name lookup (a
    subclass of a registered error inherits its row unless it has its
    own); None for anything outside the taxonomy."""
    t = e if isinstance(e, type) else type(e)
    for base in t.__mro__:
        spec = SERVING_ERRORS.get(base.__name__)
        if spec is not None:
            return spec
    return None


class RayTpuError(Exception):
    pass


class TaskError(RayTpuError):
    """A task raised an exception; re-raised where its result is read.
    Wraps the cause with the remote traceback (``tb_str``)."""

    def __init__(self, cause: BaseException | None = None, tb_str: str = "", task_desc: str = ""):
        self.cause = cause
        self.tb_str = tb_str
        self.task_desc = task_desc
        super().__init__(f"task {task_desc} failed:\n{tb_str}")

    @classmethod
    def from_exception(cls, e: BaseException, task_desc: str = ""):
        return cls(cause=e, tb_str="".join(traceback.format_exception(type(e), e, e.__traceback__)), task_desc=task_desc)

    def __reduce__(self):
        import pickle

        cause = self.cause
        if cause is not None:
            try:
                pickle.dumps(cause)
            except Exception:
                cause = None  # an unpicklable cause: keep the traceback string only
        return (_rebuild_task_error, (cause, self.tb_str, self.task_desc))


def _rebuild_task_error(cause, tb_str, task_desc):
    return TaskError(cause=cause, tb_str=tb_str, task_desc=task_desc)


@serving_error
class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


@serving_error
class ActorDiedError(RayTpuError):
    def __init__(self, actor_id=None, reason: str = ""):
        self.actor_id = actor_id
        self.reason = reason
        super().__init__(f"actor {actor_id} died: {reason}")


@serving_error
class ActorUnavailableError(RayTpuError):
    """Actor temporarily unreachable (restarting)."""


@serving_error
class ObjectLostError(RayTpuError):
    """The object was freed, or its owner died (owned objects die with
    their owner)."""


@serving_error
class ObjectReconstructionError(ObjectLostError):
    pass


@serving_error
class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class NodeDiedError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class PlacementGroupUnschedulableError(RayTpuError):
    pass


class PendingCallsLimitExceeded(RayTpuError):
    pass


class OutOfMemoryError(RayTpuError):
    pass
