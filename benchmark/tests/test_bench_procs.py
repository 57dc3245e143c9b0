"""A run is one process and leaves nothing behind: the harness's child
helpers end what they start, its teardown finds and reaps what is left,
and the entry without a card fails as the contract says and leaves no
descendant."""
import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import manifest, procs


def test_run_child_is_waited_for():
    res = procs.run_child([sys.executable, "-c", "print('ok')"], 60)
    assert res.returncode == 0 and res.stdout.strip() == "ok"
    assert procs.descendants() == []


def test_run_child_kills_its_tree_at_the_limit():
    """A child and its own child, both sleeping: at the limit both go."""
    code = ("import subprocess, sys, time; "
            "subprocess.Popen([sys.executable, '-c', "
            "'import time; time.sleep(600)']); time.sleep(600)")
    t0 = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired):
        procs.run_child([sys.executable, "-c", code], 3)
    assert time.monotonic() - t0 < 60
    # the grandchild was killed too; an unreaped one would still be listed
    deadline = time.monotonic() + 10
    while procs.descendants() and time.monotonic() < deadline:
        time.sleep(0.1)
    assert procs.descendants() == []


def test_teardown_kills_and_reaps_what_is_left():
    """A child started and forgotten is found below this process, killed
    and reaped by the teardown, which reports it."""
    p = subprocess.Popen([sys.executable, "-c", "import time; "
                          "time.sleep(600)"])
    assert p.pid in procs.descendants()
    found = procs.teardown()
    assert p.pid in found
    assert procs.descendants() == []


def test_call_with_limit_ends_the_build_tools():
    """A build function that starts a tool without a limit (as the
    program's nvcc and make calls do) is cut at the harness's limit, and
    its tool is killed."""
    def build():
        subprocess.run([sys.executable, "-c", "import time; "
                        "time.sleep(600)"])
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        procs.call_with_limit(build, 3, "a build")
    assert time.monotonic() - t0 < 60
    assert procs.descendants() == []
    assert procs.call_with_limit(lambda: 7, 10, "a quick one") == 7


SUBREAPED = r"""
import ctypes, json, os, subprocess, sys
# this wrapper adopts whatever the entry leaves behind (PR_SET_CHILD_SUBREAPER)
ctypes.CDLL(None).prctl(36, 1, 0, 0, 0)
from benchmark import procs
res = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                      sys.argv[1], "--seed", "4294967311", "--seconds", "1",
                      "--trace", "0"], capture_output=True, text=True)
left = procs.teardown()
print(json.dumps({"rc": res.returncode, "stdout": res.stdout,
                  "stderr": res.stderr[-2000:], "left": left}))
"""


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.manifest()["workloads"]])
def test_entry_without_a_card_fails_and_leaves_nothing(cell):
    """Without a card the entry exits non-zero with no result line, makes
    no measurement on the CPU, and leaves no process behind (its orphans
    would be adopted by the wrapper and found)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", SUBREAPED, cell],
                         capture_output=True, text=True, cwd=manifest.ROOT,
                         env=env, timeout=600)
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["rc"] != 0
    assert not any(line.lstrip().startswith("{")
                   for line in out["stdout"].splitlines())
    assert "no CUDA device" in out["stderr"]
    assert out["left"] == []
