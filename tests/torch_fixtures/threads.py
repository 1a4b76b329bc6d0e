"""The port tests' check that a test leaves no thread running.

Take ``before = threads_now()`` before a test and call
``assert_no_thread_started(before)`` after it, or wrap the test in
``no_thread_started()``: the check fails where a thread that was not alive
before the test is still alive after it.  So a thread the test started and
left running fails it, and a thread that was alive before the test (one an
earlier test file left behind on the same worker process) and ends during
it does not.
"""

import contextlib
import threading


def threads_now() -> set:
    """The live thread objects."""
    return set(threading.enumerate())


def new_threads(before) -> list:
    """The live threads that are not in ``before``."""
    return [t for t in threading.enumerate() if t not in before]


def assert_no_thread_started(before) -> None:
    left = new_threads(before)
    assert not left, f"threads left running: {[t.name for t in left]}"


@contextlib.contextmanager
def no_thread_started():
    before = threads_now()
    yield
    assert_no_thread_started(before)


def start_shared_pools() -> None:
    """Start every worker of both packages' shared pools (they live for
    the process), so that a test's thread check does not count them."""
    from parquet_tpu.utils import pool as jpool
    from parquet_tpu_torch.utils import pool as tpool

    for pool, width in ((tpool.shared_pool(), tpool.pool_width()),
                        (jpool.shared_pool(), jpool.pool_width())):
        barrier = threading.Barrier(width + 1)
        futs = [pool.submit(barrier.wait) for _ in range(width)]
        barrier.wait(timeout=30)
        for f in futs:
            f.result(timeout=30)
