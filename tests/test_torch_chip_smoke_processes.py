"""chip_smoke.py stops every process it starts: after each phase,
`stop_descendants` names and ends what a phase left below it, orphans in a
session of their own among them (the script is their subreaper), and one
that ignores SIGTERM too, while what was below the script before its
first phase (a shell's `tee`) is left be. Each case runs in a process of
its own, so that the test's process never becomes a subreaper."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLEEPERS = {
    "plain": "import time; time.sleep(300)",
    "ignores_sigterm": "import signal, time; "
                       "signal.signal(signal.SIGTERM, signal.SIG_IGN); "
                       "time.sleep(300)",
}

# A child that leaves the sleeper behind in a new session and ends, as
# torch.distributed.run's workers would if their agent ended first.
DRIVER = """
import json, subprocess, sys, time
sys.path.insert(0, {root!r})
import chip_smoke
chip_smoke._become_subreaper()
subprocess.run([sys.executable, "-c",
                "import subprocess, sys; subprocess.Popen([sys.executable, "
                "'-c', {sleeper!r}], start_new_session=True, "
                "stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)"],
               check=True)
time.sleep(0.5)
before = chip_smoke._descendants()
stopped = chip_smoke.stop_descendants("the test", grace=0.5)
print(json.dumps({{"before": before, "stopped": stopped,
                   "after": chip_smoke._descendants(),
                   "again": chip_smoke.stop_descendants("the test")}}))
"""


@pytest.mark.parametrize("sleeper", sorted(SLEEPERS))
def test_stop_descendants_ends_an_orphan(sleeper):
    out = subprocess.run(
        [sys.executable, "-c", DRIVER.format(root=ROOT,
                                             sleeper=SLEEPERS[sleeper])],
        capture_output=True, text=True, timeout=60, check=True).stdout
    lines = out.strip().splitlines()
    result = json.loads(lines[-1])
    assert len(result["before"]) == 1
    pid = result["before"][0][0]
    assert "time.sleep(300)" in result["before"][0][2]
    assert result["stopped"] == 1
    assert result["after"] == [] and result["again"] == 0
    assert lines[0].startswith(
        "processes: after the test pid {} ".format(pid))
    assert not os.path.exists("/proc/{}".format(pid))


# A child started before the first phase, as a shell's process
# substitution starts `tee` below the script, then one a phase leaves.
KEEP_DRIVER = """
import json, os, subprocess, sys
sys.path.insert(0, {root!r})
import chip_smoke
tee = subprocess.Popen(["sleep", "300"])
chip_smoke._become_subreaper()
phase = subprocess.Popen(["sleep", "301"])
stopped = chip_smoke.stop_descendants("the test", grace=0.5)
alive = tee.poll() is None
tee.kill()
tee.wait()
print(json.dumps({{"tee": tee.pid, "phase": phase.pid, "stopped": stopped,
                   "tee_alive": alive,
                   "phase_ended": not os.path.exists(
                       "/proc/{{}}".format(phase.pid))}}))
"""


def test_stop_descendants_keeps_what_was_there_before():
    out = subprocess.run(
        [sys.executable, "-c", KEEP_DRIVER.format(root=ROOT)],
        capture_output=True, text=True, timeout=60, check=True).stdout
    lines = out.strip().splitlines()
    result = json.loads(lines[-1])
    assert result["stopped"] == 1 and result["tee_alive"]
    assert result["phase_ended"]
    assert lines[0].startswith(
        "processes: after the test pid {} ".format(result["phase"]))
    assert "sleep 301" in lines[0]
