"""One time limit for every test under ``tests/``, loaded by the root
``conftest.py``.

A test gets ``LIMIT_S`` seconds from the start of its setup to the end of
its teardown: its module's own ``LIMIT_S`` where it defines one, 300
otherwise. Each phase arms ``SIGALRM`` with what is left, so the alarm
fires only inside a phase, and pytest reports the ``TimeoutError`` as that
phase's failure; the stacks of every thread go to stderr first, so the log
shows where the test sat. A teardown that starts with the limit spent gets
a whole limit to clean up.

A phase blocked where no Python signal handler runs (a native call that
never returns) is ended by ``faulthandler`` one limit after its alarm: the
process dumps every stack and exits, and pytest-xdist fails the test and
goes on with a fresh worker (a run without workers ends there).

A test that sets an alarm of its own keeps it: a phase that starts with an
alarm pending arms none, and a phase whose handler the test replaced leaves
the test's handler and alarm as they are."""

import faulthandler
import os
import signal
import sys
import time
from pathlib import Path

import pytest

LIMIT_S = 300
HERE = Path(__file__).resolve().parent
STARTED = pytest.StashKey[float]()
STDERR = pytest.StashKey[int]()


def pytest_configure(config):
    # stderr outside the tests' capture: the backstop ends the process, and
    # what a phase's capture holds is lost with it
    config.stash[STDERR] = os.dup(sys.__stderr__.fileno())


def pytest_unconfigure(config):
    os.close(config.stash[STDERR])


def limit_of(item):
    """The item's limit in seconds, or None for an item outside ``tests/``."""
    if HERE not in item.path.resolve().parents:
        return None
    return getattr(getattr(item, "module", None), "LIMIT_S", LIMIT_S)


def bounded(item, when):
    """One phase of ``item`` under its limit: a hook wrapper's body."""
    limit = limit_of(item)
    if limit is None:
        return (yield)
    now = time.monotonic()
    seconds = item.stash.setdefault(STARTED, now) + limit - now
    if seconds <= 0:  # spent: setup and call fail at once, teardown cleans up
        seconds = limit if when == "teardown" else 1e-3
    over = False

    def expire(signum, frame):
        if over:  # fired as the phase ended: nothing left to interrupt
            return
        faulthandler.dump_traceback(file=sys.__stderr__, all_threads=True)
        raise TimeoutError(f"{item.nodeid} ran past its limit of {limit} s")

    armed = signal.getitimer(signal.ITIMER_REAL)[0] == 0
    if armed:
        previous = signal.signal(signal.SIGALRM, expire)
        signal.setitimer(signal.ITIMER_REAL, seconds)
    faulthandler.dump_traceback_later(seconds + limit, exit=True,
                                      file=item.config.stash[STDERR])
    try:
        return (yield)
    finally:
        over = True
        faulthandler.cancel_dump_traceback_later()
        if armed and signal.getsignal(signal.SIGALRM) is expire:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from bounded(item, "setup"))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from bounded(item, "call"))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    return (yield from bounded(item, "teardown"))
