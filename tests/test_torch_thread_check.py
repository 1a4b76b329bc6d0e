"""The port tests' thread check (``tests/torch_fixtures/threads.py``): a
thread that was alive before a test and ends inside it passes, a thread
the test starts and leaves running fails.  Each test stops its thread."""

import threading

import pytest

from torch_fixtures.threads import (assert_no_thread_started,
                                    no_thread_started, threads_now)


def _waiter(name: str):
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name=name, daemon=True)
    return stop, t


def test_a_thread_that_ends_inside_the_check_passes():
    stop, t = _waiter("older")
    t.start()
    try:
        with no_thread_started():
            stop.set()
            t.join(timeout=10)
        before = threads_now()
        assert_no_thread_started(before)
    finally:
        stop.set()
        t.join(timeout=10)


def test_a_thread_left_running_fails_the_check():
    stop, t = _waiter("left-behind")
    try:
        with pytest.raises(AssertionError, match="left-behind"):
            with no_thread_started():
                t.start()
        before = threads_now()
        stop.set()
        t.join(timeout=10)
        assert_no_thread_started(before)  # it ended: nothing new is left
    finally:
        stop.set()
        if t.is_alive():
            t.join(timeout=10)
