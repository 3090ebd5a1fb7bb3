"""The serving-error taxonomy, the port's own copy of the part of
ray_tpu/exceptions.py that it raises: the KV handoff and live-migration
errors.

``SERVING_ERRORS`` maps each typed error a client or a router may observe
to its HTTP status code and a retryable flag, keyed by class name, with
ray_tpu's codes and flags unchanged. A defining module binds its class to
its row with ``@serving_error``, which refuses a name the table lacks and
stamps ``status_code``/``retryable`` on the class.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ServingErrorSpec:
    """How one typed serving error crosses the HTTP boundary."""

    status_code: int
    retryable: bool  # may the client/router retry (elsewhere or later)?


SERVING_ERRORS: dict[str, ServingErrorSpec] = {
    # live migration (llm/migrate.py): a lost checkpoint fails over, a
    # malformed one is a hard fault (garbage must never reach a pool)
    "MigrationError": ServingErrorSpec(500, retryable=False),
    "MigrationLostError": ServingErrorSpec(503, retryable=True),
    "RequestMigratedError": ServingErrorSpec(503, retryable=True),
    # disagg handoff codec (llm/disagg/handoff.py)
    "HandoffError": ServingErrorSpec(500, retryable=False),
    "HandoffLostError": ServingErrorSpec(503, retryable=True),
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
