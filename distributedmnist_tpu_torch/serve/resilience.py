"""Serving resilience: the deadline shed (the port of the JAX package's
serve/resilience.py, its DeadlineExceeded so far).

A request may carry a client deadline (the HTTP server's X-Deadline-Ms).
One that has passed at submit, or passes while it waits in the queue,
is shed before dispatch with DeadlineExceeded: 504, zero device work.

Still to come (ROADMAP §1 item 6): the per-version circuit breaker that
calls the registry's rollback, bisection of a failed dispatch, and the
policy bundle /metrics reports as `resilience_policy`.
"""

from __future__ import annotations


class DeadlineExceeded(RuntimeError):
    """The request's client deadline passed before its batch dispatched:
    shed with 504 semantics (the HTTP server adds a Retry-After derived
    from the pipeline's state)."""

    status = 504
