"""Child processes of a run: started, waited for with a limit, and none
left behind.

A run is one process.  Whatever it starts (a compiler, ``make``, one
``nvidia-smi`` query) goes through :func:`run_child` or
:func:`call_with_limit`, which end the child's whole tree when the limit
passes, and :func:`teardown` at the end of every run, on the error path
too, reads what is left below the run from ``/proc`` and kills and reaps
it.  A run that finds anything left reports that it failed.
"""
from __future__ import annotations

import os
import signal
import subprocess
import threading
import time
from typing import Callable, List


def children(pid: int) -> List[int]:
    """The direct children of ``pid``, from every one of its threads
    (``/proc/<pid>/task/*/children``); [] where it is gone."""
    out = []
    try:
        tasks = os.listdir(f"/proc/{pid}/task")
    except OSError:
        return out
    for tid in tasks:
        try:
            with open(f"/proc/{pid}/task/{tid}/children") as f:
                out.extend(int(x) for x in f.read().split())
        except OSError:
            continue
    return sorted(set(out))


def descendants(pid: int = None) -> List[int]:
    """Every living or unreaped process below ``pid`` (this process by
    default), parents before their children."""
    pid = os.getpid() if pid is None else pid
    found, todo = [], children(pid)
    while todo:
        p = todo.pop(0)
        if p in found:
            continue
        found.append(p)
        todo.extend(children(p))
    return found


def kill_tree(pid: int) -> None:
    """SIGKILL ``pid`` and everything below it, children first found."""
    for p in [pid] + descendants(pid):
        try:
            os.kill(p, signal.SIGKILL)
        except ProcessLookupError:
            pass


def _reap(pids) -> None:
    """Wait for those of ``pids`` that are this process's own children."""
    for p in pids:
        try:
            os.waitpid(p, 0)
        except ChildProcessError:
            pass


def run_child(cmd, timeout: float, **kw) -> subprocess.CompletedProcess:
    """``cmd`` to its end, its output captured; at ``timeout`` seconds its
    whole tree is killed and reaped and ``subprocess.TimeoutExpired``
    raised."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, **kw)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        kill_tree(proc.pid)
        proc.communicate()
        raise
    finally:
        if proc.poll() is None:
            kill_tree(proc.pid)
            proc.wait()
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def call_with_limit(fn: Callable, timeout: float, what: str):
    """``fn()`` in a thread of this process; where it has not returned
    after ``timeout`` seconds, every process below this one is killed and
    reaped (``fn``'s compiler or ``make``) and ``TimeoutError`` raised.
    For the program's own build functions, which start their tools
    without a limit."""
    box = {}

    def body():
        try:
            box["value"] = fn()
        except BaseException as e:       # handed to the caller below
            box["error"] = e

    th = threading.Thread(target=body, name=f"limit:{what}", daemon=True)
    th.start()
    th.join(timeout)
    if th.is_alive():
        teardown()
        th.join(10.0)
        raise TimeoutError(f"{what} did not finish in {timeout:.0f} s; its "
                           f"processes were killed")
    if "error" in box:
        raise box["error"]
    return box.get("value")


def teardown(grace: float = 2.0) -> List[int]:
    """Kill and reap every process below this one.  Returns the ones
    found (none, in a sound run).  Processes that outlive their kill past
    ``grace`` seconds are listed again by :func:`descendants`."""
    found = descendants()
    for p in found:
        try:
            os.kill(p, signal.SIGKILL)
        except ProcessLookupError:
            pass
    _reap(found)
    end = time.monotonic() + grace
    while descendants() and time.monotonic() < end:
        _reap(descendants())
        time.sleep(0.05)
    return found
