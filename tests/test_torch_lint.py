"""graftlint's concurrency rules over the port: ``lock-order``,
``ref-drop-under-lock``, ``blocking-under-lock`` and ``thread-hygiene``
run over ``ray_tpu_torch/`` with no baseline, and any finding fails.

The linter scopes its file rules to ``ray_tpu/**/*.py``; this test widens
the four rules' scope to the port's files for its own pass (an in-memory
copy of each rule, nothing under ``ray_tpu/`` changes), and first shows on
a planted file that the widened rules do fire."""

import dataclasses
import signal
import textwrap

import pytest

import ray_tpu.devtools.lint.rules  # noqa: F401 - the rules register on import
from ray_tpu.devtools.lint import core
from ray_tpu.devtools.lint.runner import run_pass

RULES = ("lock-order", "ref-drop-under-lock", "blocking-under-lock", "thread-hygiene")
DEADLINE_S = 60


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, DEADLINE_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.fixture
def port_scoped(monkeypatch):
    for name in RULES:
        monkeypatch.setitem(core.RULES, name, dataclasses.replace(
            core.RULES[name], scope=("ray_tpu_torch/**/*.py",)))


def test_widened_rules_fire_on_a_planted_file(port_scoped, tmp_path):
    pkg = tmp_path / "ray_tpu_torch"
    pkg.mkdir()
    (pkg / "bad.py").write_text(textwrap.dedent("""
        import threading
        import time

        class Bad:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = {}

            def drop(self, key):
                with self._lock:
                    self._items.pop(key)

            def nap(self):
                with self._lock:
                    time.sleep(1)

        def start():
            threading.Thread(target=print).start()
    """))
    report = run_pass(root=str(tmp_path), rule_names=list(RULES), use_baseline=False,
                      subdirs=("ray_tpu_torch",))
    assert {f.rule for f in report.findings} == {"ref-drop-under-lock",
                                                 "blocking-under-lock", "thread-hygiene"}


def test_concurrency_rules_find_nothing_in_the_port(port_scoped):
    report = run_pass(rule_names=list(RULES), use_baseline=False, subdirs=("ray_tpu_torch",))
    assert report.files_scanned >= 30 and report.rules_run == len(RULES)
    assert not report.findings, "\n".join(f.render() for f in report.findings)
    assert report.suppressed == 0
