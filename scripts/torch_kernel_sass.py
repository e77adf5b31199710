"""Instruction counts of a built kernel of the PyTorch port, from its SASS.

    python3 scripts/torch_kernel_sass.py [--kernel window_min_kernel]

Builds the port's kernel library (``ch_shrinkwrap_torch/ops/_build.py``)
when it is not built yet, disassembles it with ``cuobjdump -sass`` and
``cuobjdump -res-usage``, and prints, for each function whose name
contains ``--kernel``: its resource usage line (registers, stack, shared
and local memory), its instruction count, and its hottest loop, the
backward branch whose body holds the most FFMA, with that body's
instruction count and opcode histogram.  For K1 (``window_min_kernel``)
every point-candidate pair costs two FFMA, so the body's instructions
per point-candidate pair are its count over half its FFMA.  Prints one
JSON line per function.  Needs the CUDA toolkit; no GPU.
"""

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSN = re.compile(r'/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)'
                  r'([^;]*);')
BRA = re.compile(r'BRA\s+(?:`?\(?)?(0x[0-9a-f]+)')


def cuobjdump():
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and os.path.exists(os.path.join(root, 'bin', 'cuobjdump')):
            return os.path.join(root, 'bin', 'cuobjdump')
    p = shutil.which('cuobjdump')
    if p is None:
        raise SystemExit('cuobjdump not found')
    return p


def functions(sass):
    """{mangled name: [(address, opcode, operands)]} of a SASS listing."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r'Function\s*:\s*(\S+)', line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def hottest_loop(insns):
    """The innermost loop (a backward branch whose body holds no other
    backward branch) with the most FFMA."""
    loops = []
    for addr, op, args in insns:
        m = BRA.search(op + ' ' + args) if op.startswith('BRA') else None
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(lo, hi) for lo, hi in loops
             if not any(lo <= lo2 and hi2 <= hi and (lo2, hi2) != (lo, hi)
                        for lo2, hi2 in loops)]
    best = None
    for lo, hi in inner:
        body = [o for a, o, _ in insns if lo <= a <= hi]
        n_ffma = sum(o.startswith('FFMA') for o in body)
        if best is None or n_ffma > best[0]:
            best = (n_ffma, lo, hi, body)
    if best is None:
        return None
    n_ffma, lo, hi, body = best
    hist = collections.Counter(o.split('.')[0] for o in body)
    return dict(start=hex(lo), end=hex(hi), n_instr=len(body),
                n_ffma=n_ffma,
                instr_per_point_candidate=(len(body) / (n_ffma / 2)
                                           if n_ffma else None),
                opcodes=dict(hist.most_common()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--kernel', default='window_min_kernel')
    a = ap.parse_args()
    sys.path.insert(0, HERE)
    from ch_shrinkwrap_torch.ops import _build
    path, _ = _build.build()
    tool = cuobjdump()
    sass = subprocess.run([tool, '-sass', path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    res = subprocess.run([tool, '-res-usage', path], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    res_lines = res.splitlines()
    for name, insns in functions(sass).items():
        if a.kernel not in name:
            continue
        usage = next((res_lines[i + 1].strip()
                      for i, line in enumerate(res_lines[:-1])
                      if name in line), None)
        print(json.dumps({'function': name, 'resources': usage,
                          'n_instr': len(insns),
                          'hottest_loop': hottest_loop(insns)}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
