"""Fixture: unbounded retry loops (retry-discipline violations)."""
import os
import time


def wait_for_file(path):
    # BAD: spins forever if the file never appears -- no attempt bound,
    # no deadline, no structured timeout.
    while not os.path.exists(path):
        time.sleep(0.05)


def poll_until_ready(is_ready):
    # BAD: constant-true test, sleep, and no break/return/raise.
    while True:
        if is_ready():
            pass
        time.sleep(1.0)


def bounded_ok(path, attempts=5):
    # OK: bounded attempts and a structured timeout on exhaustion.
    delay = 0.05
    for _ in range(attempts):
        if os.path.exists(path):
            return True
        time.sleep(delay)
        delay *= 2
    raise TimeoutError(f"{path} never appeared")


def exit_edge_ok(q):
    # OK: the loop sleeps but can break out.
    while True:
        if q.done():
            break
        time.sleep(0.1)
