"""The time limit that every test under ``tests/`` runs under
(``tests/time_limit.py``, loaded by the root ``conftest.py``), seen from a
pytest run of its own: the root conftest and the plugin are copied into a
temporary tree laid out as the repo is, beside a module of tests with
``LIMIT_S`` of its own.

* A test that sleeps past its limit fails with ``TimeoutError`` and the
  stacks of its threads, and the run goes on to its end with exit code 1.
* A test that sets its own alarm keeps its handler for its duration, and
  the limit holds again for the next test.
* A test that blocks ``SIGALRM`` is ended by the ``faulthandler`` backstop
  one limit after its alarm, and pytest-xdist fails it and goes on with a
  fresh worker."""

import os
import re
import shutil
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SLEEPS = """
import signal
import time

LIMIT_S = 2


def test_keeps_its_own_alarm():
    fired = []
    old = signal.signal(signal.SIGALRM, lambda signum, frame: fired.append(signum))
    try:
        signal.setitimer(signal.ITIMER_REAL, 0.1)
        time.sleep(0.5)
    finally:
        signal.signal(signal.SIGALRM, old)
    assert fired == [signal.SIGALRM]


def test_sleeps():
    time.sleep(30)


def test_passes():
    pass
"""

BLOCKS = """
import signal
import time

LIMIT_S = 1


def test_blocks_the_alarm():
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(30)


def test_passes():
    pass
"""


def run_pytest(root: Path, module: str, *args):
    """pytest on ``module`` in a copy of the repo's root conftest and plugin,
    with no plugin loaded but those named: (exit code, seconds,
    {test name: (outcome, message)}, output)."""
    (root / "tests").mkdir()
    shutil.copy(REPO / "conftest.py", root / "conftest.py")
    shutil.copy(REPO / "tests" / "time_limit.py", root / "tests" / "time_limit.py")
    (root / "tests" / "__init__.py").write_text("")
    (root / "tests" / "test_module.py").write_text(module)
    (root / "pytest.ini").write_text("[pytest]\n")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_module.py", "-q", "-p", "no:cacheprovider",
         "--junitxml", "out.xml", *args],
        cwd=root, env=dict(os.environ, PYTEST_DISABLE_PLUGIN_AUTOLOAD="1"),
        capture_output=True, text=True, timeout=60)
    seconds = time.monotonic() - t0
    cases = {}
    for case in ET.parse(root / "out.xml").iter("testcase"):
        bad = case.find("failure")
        if bad is None:
            bad = case.find("error")  # how pytest-xdist reports a crashed worker
        cases[case.get("name")] = ("passed", "") if bad is None else ("failed", bad.get("message"))
    return proc.returncode, seconds, cases, proc.stdout + proc.stderr


def test_a_test_past_its_limit_fails_and_the_run_goes_on(tmp_path):
    rc, seconds, cases, out = run_pytest(tmp_path, SLEEPS)
    assert rc == 1, out[-3000:]
    assert seconds < 15, out[-3000:]
    outcome, message = cases["test_sleeps"]
    assert outcome == "failed" and "TimeoutError" in message, out[-3000:]
    assert "tests/test_module.py::test_sleeps ran past its limit of 2 s" in message
    assert re.search(r'File ".*test_module.py", line \d+ in test_sleeps', out)  # the stacks
    assert cases["test_keeps_its_own_alarm"][0] == "passed", out[-3000:]
    assert cases["test_passes"][0] == "passed", out[-3000:]


def test_a_worker_blocked_past_its_limit_is_ended(tmp_path):
    rc, seconds, cases, out = run_pytest(tmp_path, BLOCKS, "-p", "xdist", "-n", "1")
    assert rc == 1, out[-3000:]
    assert seconds < 15, out[-3000:]
    outcome, message = cases["test_blocks_the_alarm"]
    assert outcome == "failed" and "crashed" in message, out[-3000:]
    # the backstop's dump, one limit (1 s) after the alarm (at most 1 s into the call)
    assert "Timeout (0:00:01." in out, out[-3000:]
    assert re.search(r'File ".*test_module.py", line \d+ in test_blocks_the_alarm', out)
    assert cases["test_passes"][0] == "passed", out[-3000:]
