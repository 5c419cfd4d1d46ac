"""A deadline for the PyTorch port's tests whose fits raise signals or
start threads: imported by those test files, the autouse fixture fails a
test that runs past ``DEADLINE_S`` with its stack, where a hang would
hold the whole run until its clock cuts it."""

import signal

import pytest

#: seconds a test may take
DEADLINE_S = 300


@pytest.fixture(autouse=True)
def deadline():
    """A SIGALRM after ``DEADLINE_S`` raises in the test's main thread."""
    def expire(signum, frame):
        raise TimeoutError("test ran past its %d s deadline" % DEADLINE_S)
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
