"""SASS instruction counts of a built kernel library (``cuobjdump -sass``).

``chip_smoke.py`` prints them beside ptxas's registers and spills for every
instantiation of the whole-scan kernel: the whole body, the time loop and
the boundary-layer loop, with the special-function, divide-check, call and
branch instructions counted on their own.  ``loop_lines`` splits a time
loop's instructions by the source line each was compiled from (a library
built with ``-lineinfo``, disassembled by ``nvdisasm -g``), which
``part_split`` sums over the parts of the source a caller names.
"""
from __future__ import annotations

import re
import subprocess
import tempfile
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


_INS = re.compile(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                  r"([A-Z][A-Z0-9_.]*)(.*)")


def line_listing(text: str) -> dict:
    """``{mangled name: [(address, opcode, branch target, source
    lines)]}`` from ``nvdisasm -g`` or ``-gi`` output (NOPs left out):
    each instruction carries the (file name, line) pairs of the last
    ``//## File ..., line N`` comment before it, innermost first (an
    inlined function's own line, then each ``inlined at`` line), () before
    any."""
    out, name, ins, labels, pending, line = {}, None, [], {}, [], ()

    def close():
        if name is not None:
            out[name] = [(a, op, labels.get(t, t), ln)
                         for a, op, t, ln in ins]
    for row in text.splitlines():
        m = re.match(r"\s*\.text\.(\S+):", row)
        if m:
            close()
            name, ins, labels, pending, line = m.group(1), [], {}, [], ()
            continue
        if "//## File" in row:
            line = tuple((Path(f).name, int(n)) for f, n in re.findall(
                r'"([^"]+)", line (\d+)', row))
            continue
        m = re.match(r"\s*(\.L_x_\d+):", row)
        if m:
            pending.append(m.group(1))
            continue
        m = _INS.match(row)
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
        ins.append((a, op, target, line))
    close()
    return out


def loop_lines(rows) -> Counter:
    """The source lines of a kernel's longest loop (its time loop: from
    the target of its longest backward branch to that branch), as a
    Counter of instructions a chain of lines, from ``line_listing``
    rows."""
    best = None
    for a, _, t, _ in rows:
        if isinstance(t, int) and t < a and (best is None
                                             or a - t > best[1] - best[0]):
            best = (t, a)
    if best is None:
        return Counter()
    return Counter(ln for a, _, _, ln in rows if best[0] <= a <= best[1])


def part_split(lines: Counter, parts, source: str) -> dict:
    """Instructions by part: ``parts`` is [(name, first line, last
    line)] of the file named ``source``; an instruction goes to the part
    of the first line of its chain (innermost first) that a part holds,
    the first such part; else to the name of its innermost line's file
    where that is another file (a header's intrinsic, such as __ldg),
    else to "other"."""
    out = Counter()
    for chain, n in lines.items():
        name = next((p for f, ln in chain if f == source
                     for p, lo, hi in parts if lo <= ln <= hi), None)
        if name is None:
            name = (chain[0][0] if chain and chain[0][0] != source
                    else "other")
        out[name] += n
    return dict(out)


def library_listing(path) -> str:
    """``nvdisasm -g`` of every cubin in a built library (the toolkit's
    cuobjdump and nvdisasm, beside its nvcc)."""
    nvcc = Path(build.nvcc_path())
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([str(nvcc.with_name("cuobjdump")), "-xelf", "all",
                        str(Path(path).resolve())], cwd=tmp, check=True,
                       capture_output=True)
        texts = [subprocess.run([str(nvcc.with_name("nvdisasm")), "-g",
                                 str(c)], capture_output=True, text=True,
                                check=True).stdout
                 for c in sorted(Path(tmp).glob("*.cubin"))]
    return "\n".join(texts)
