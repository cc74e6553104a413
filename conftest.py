"""A wall-clock limit for every test phase (setup, call, teardown).

A test marked neither `slow` nor `cuda` has DEFAULT_TIME_LIMIT; those two
run for as long as they take. On expiry SIGALRM fails the phase with its
traceback and the run goes on. A hang inside native code never returns to
Python to take the signal; `faulthandler` then prints every thread's stack
BACKSTOP seconds later and ends the process (under pytest-xdist, the
worker, which xdist reports as that test's failure; no worker runs that
test again).

The run's processes share a fresh directory that the controlling process
makes at start and removes at the end; it holds the list of tests that
ended a worker.
"""

import faulthandler
import os
import pathlib
import shutil
import signal
import tempfile

import pytest

DEFAULT_TIME_LIMIT = 600.0
BACKSTOP = 60.0
_RUN_DIR = pytest.StashKey[pathlib.Path]()
_STDERR_FD = pytest.StashKey[int]()


def pytest_configure(config):
    workerinput = getattr(config, "workerinput", None)
    if workerinput is None:
        run_dir = pathlib.Path(tempfile.mkdtemp(prefix="pytest-run-"))
    else:
        run_dir = pathlib.Path(workerinput["run_dir"])
    config.stash[_RUN_DIR] = run_dir
    # output capture is off here: the backstop's stack dump goes to the
    # process's real stderr, not to a captured test's buffer
    config.stash[_STDERR_FD] = os.dup(2)


@pytest.hookimpl(optionalhook=True)
def pytest_configure_node(node):
    node.workerinput["run_dir"] = str(node.config.stash[_RUN_DIR])


@pytest.hookimpl(optionalhook=True)
def pytest_handlecrashitem(crashitem, report, sched):
    # xdist's loadfile schedule hands the rest of a crashed worker's file,
    # the test that crashed it included, to another worker: record the test
    # so that worker fails it at once instead of hanging again
    with open(sched.config.stash[_RUN_DIR] / "ended", "a") as f:
        f.write(crashitem + "\n")


def pytest_unconfigure(config):
    if not hasattr(config, "workerinput"):
        shutil.rmtree(config.stash[_RUN_DIR], ignore_errors=True)


def _limited(item):
    """Runs the phase that wraps it under the item's time limit."""
    if item.get_closest_marker("slow") or item.get_closest_marker("cuda"):
        return (yield)
    limit = DEFAULT_TIME_LIMIT

    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} ran past its time limit of {limit:g} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(
        limit + BACKSTOP, exit=True, file=item.config.stash[_STDERR_FD])
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    ended = item.config.stash[_RUN_DIR] / "ended"
    if ended.exists() and item.nodeid in ended.read_text().splitlines():
        pytest.fail(f"{item.nodeid} ended a worker earlier in this run")
    return (yield from _limited(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _limited(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    return (yield from _limited(item))
