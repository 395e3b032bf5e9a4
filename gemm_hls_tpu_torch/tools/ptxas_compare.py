"""Compare the ptxas reports of two kernel-library builds.

``_build.build()`` writes each source's ``nvcc -Xptxas -v`` output into the
log beside the library (``libgemm_hls_kernels_<hash>.log``).  This reads two
such logs (say, a parent commit's build and this tree's) and holds every
function of the first against the second: its stack frame, spill stores and
loads, and, for an entry function, its registers, barriers and shared
memory.  A function is paired by its (mangled) name in the same source;
one whose name changed (a template parameter added with a default) is
paired with an unpaired function of the same source with the same report.
The exit code is 0 when every function of the first log has an equal
report in the second.

    python -m gemm_hls_tpu_torch.tools.ptxas_compare parent.log change.log
"""

from __future__ import annotations

import argparse
import collections
import sys


def parse(text: str):
    """{source: {function: report}}; a report is the stack / spill line and,
    for an entry function, its "Used ..." line less nothing else."""
    out = collections.defaultdict(dict)
    src, cur = None, None
    for ln in text.splitlines():
        if ln.startswith("== ") and " s, rc " in ln:
            src = ln[3:].split(": ", 1)[0]
        elif "Function properties for " in ln:
            cur = ln.split("Function properties for ", 1)[1].strip()
            out[src][cur] = []
        elif cur is not None and "bytes stack frame" in ln:
            out[src][cur].append(ln.strip())
        elif cur is not None and ln.lstrip().startswith("ptxas info    : Used "):
            out[src][cur].append(ln.split(": ", 1)[1].strip())
    return {s: {f: tuple(r) for f, r in fns.items()} for s, fns in out.items()}


def compare(parent: dict, change: dict):
    """(lines of the report, number of functions of ``parent`` without an
    equal report in ``change``)."""
    lines, bad = [], 0
    for src in sorted(parent):
        old, new = parent[src], change.get(src, {})
        same = [f for f in old if f in new and old[f] == new[f]]
        differ = [f for f in old if f in new and old[f] != new[f]]
        left = collections.Counter(old[f] for f in old if f not in new)
        right = collections.Counter(new[f] for f in new if f not in old)
        renamed = sum((left & right).values())
        lost = left - right
        bad += len(differ) + sum(lost.values())
        lines.append(f"{src}: {len(same)} equal by name, {renamed} renamed with equal reports, "
                     f"{len(differ)} differ, {sum(lost.values())} without a match; "
                     f"{len(new) - len(old)} more functions in the change")
        for f in differ:
            lines.append(f"  differs: {f}: {old[f]} -> {new[f]}")
        for rep, n in lost.items():
            lines.append(f"  no match for {n} function(s) reporting {rep}")
    return lines, bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("parent", help="the first build log (the reference)")
    p.add_argument("change", help="the second build log")
    args = p.parse_args(argv)
    with open(args.parent) as f1, open(args.change) as f2:
        lines, bad = compare(parse(f1.read()), parse(f2.read()))
    print("\n".join(lines))
    print(f"ptxas reports: {'unchanged' if not bad else f'{bad} function(s) changed'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
