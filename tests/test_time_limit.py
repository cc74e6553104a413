"""The per-test time limit of the repository's root conftest.py: a test
that runs past its limit fails with its traceback, and the run goes on to
the next test."""

import os
import pathlib
import subprocess
import sys
import xml.etree.ElementTree as ET

ROOT = pathlib.Path(__file__).parent.parent

SLEEPER = '''
import time


def test_sleeps_past_its_limit():
    time.sleep(30)


def test_after_it():
    assert True
'''


def test_test_past_its_limit_fails_and_the_run_goes_on(tmp_path):
    conftest = (ROOT / "conftest.py").read_text()
    assert "DEFAULT_TIME_LIMIT = 600.0\n" in conftest
    (tmp_path / "conftest.py").write_text(
        conftest.replace("DEFAULT_TIME_LIMIT = 600.0\n", "DEFAULT_TIME_LIMIT = 1.0\n"))
    (tmp_path / "test_sleeper.py").write_text(SLEEPER)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-c", str(ROOT / "pyproject.toml"),
         "--rootdir", str(tmp_path), "-p", "no:cacheprovider", "-p", "no:xdist",
         "-p", "no:randomly", "-v", "--junitxml", str(tmp_path / "run.xml"),
         str(tmp_path / "test_sleeper.py")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=100)
    out = run.stdout + run.stderr
    assert run.returncode == 1, out
    assert "test_sleeps_past_its_limit FAILED" in out, out
    assert "test_after_it PASSED" in out, out
    assert "ran past its time limit of 1 s" in out, out
    assert "time.sleep(30)" in out, out  # the traceback reaches the test's line
    took = {case.get("name"): float(case.get("time"))
            for case in ET.parse(tmp_path / "run.xml").getroot().iter("testcase")}
    assert set(took) == {"test_sleeps_past_its_limit", "test_after_it"}, took
    # the failed test took about its limit, not its sleep
    assert took["test_sleeps_past_its_limit"] < 5, took
