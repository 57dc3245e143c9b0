"""SASS instruction counts of a built kernel library (``cuobjdump -sass``).

``chip_smoke.py`` prints them beside ptxas's registers and spills for every
instantiation of the whole-scan kernel: the whole body, the time loop and
the boundary-layer loop, with the special-function, divide-check, call and
branch instructions counted on their own.
"""
from __future__ import annotations

import re
import subprocess
from collections import Counter
from pathlib import Path

from ..ops import build

#: SASS instructions per kernel that ``sass_stats`` counts on their own: the
#: special-function unit (log2, rcp, rsq, ex2), the divide range check, the
#: calls to the divide / sqrt slow paths, and the branches
SASS_WATCH = ("MUFU", "FCHK", "CALL", "BRA")


def sass_stats(text: str) -> dict:
    """Per-kernel instruction counts from ``cuobjdump -sass`` output:
    ``{mangled name: {"instructions", "opcodes", "loops"}}``.  NOPs are left
    out.  ``opcodes`` counts the SASS_WATCH families (MUFU by function,
    e.g. ``MUFU.RSQ``).  ``loops`` lists every backward branch as
    ``{"start", "end", "instructions", "opcodes"}`` over the instructions
    from its target to it, innermost (shortest) first: the whole-scan
    kernel's boundary-layer loop is the innermost one that holds a
    ``MUFU.RSQ`` (its sqrtf), its time loop the longest."""
    out, name, ins, labels = {}, None, [], {}

    def close():
        if name is None:
            return
        addr = [a for a, _, _ in ins]

        def count(rows):
            c = Counter()
            for _, op, _ in rows:
                fam = op.split(".")[0]
                if fam == "MUFU":
                    c[op] += 1
                if fam in SASS_WATCH:
                    c[fam] += 1
            return dict(sorted(c.items()))
        loops = []
        for a, op, target in ins:
            if target is None:
                continue
            t = labels.get(target, target)
            if isinstance(t, int) and t < a:
                rows = [r for r in ins if t <= r[0] <= a]
                loops.append({"start": t, "end": a,
                              "instructions": len(rows),
                              "opcodes": count(rows)})
        loops.sort(key=lambda lp: lp["instructions"])
        out[name] = {"instructions": len(addr), "opcodes": count(ins),
                     "loops": loops}

    pending = []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            name, ins, labels, pending = m.group(1), [], {}, []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)(.*)", line)
        if not m or name is None:
            continue
        a, op, rest = int(m.group(1), 16), m.group(2), m.group(3)
        for lab in pending:
            labels[lab] = a
        pending = []
        if op == "NOP":
            continue
        target = None
        if op.split(".")[0] == "BRA":
            t = re.search(r"(\.L_x_\d+)|\b0x([0-9a-f]+)\b", rest)
            if t:
                target = t.group(1) or int(t.group(2), 16)
        ins.append((a, op, target))
    close()
    return out


def library_sass(path) -> dict:
    """``sass_stats`` of a built library (the toolkit's cuobjdump, beside
    its nvcc)."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    res = subprocess.run([str(cuobjdump), "-sass", str(path)],
                         capture_output=True, text=True, check=True)
    return sass_stats(res.stdout)
