"""Compares the ``-Xptxas=-v`` lines (registers, barriers, stack and
spills) of every kernel that this checkout and another one both build,
source by source: builds the sources in both trees at once (the other one
through its own ``ops/_build.py``, in a process of its own) and prints
``ptxas SOURCE: equal`` or the lines that differ. Kernels are matched by
name with the anonymous namespace's tag taken out
(``52_GLOBAL__N__e321f4a7_19_ffn_block_tf32x3_cu_3b2fb43b``, whose hashes
nvcc derives from the source's path, so that two trees never share them).
Exits 1 if a source differs. It needs nvcc, not a card::

    python -m allrank_tpu_torch.tools.ptxas_compare OTHER_CHECKOUT [SOURCE ...]

With no SOURCE it takes every ``csrc/*.cu`` that both trees hold. Run
against the parent commit unpacked into a git-ignored directory, it shows
that a change left the kernels it did not touch as ptxas built them.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys

# the anonymous namespace's part of a mangled kernel name
_NAMESPACE_TAG = re.compile(
    r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?)_cu_[0-9a-f]{8}")

_OTHER_BUILD = """
import json, sys
from allrank_tpu_torch.ops import _build
_build.build(sys.argv[1:])
print(json.dumps({n: _build.log_path(n) for n in sys.argv[1:]}))
"""


def kernel_key(name: str) -> str:
    """``name`` with its anonymous namespace's path hashes taken out."""
    return _NAMESPACE_TAG.sub(r"_GLOBAL__N_\1", name)


def table(source: str, log: str) -> list:
    """The sorted (kernel key, line) pairs of ``source``'s build log."""
    from allrank_tpu_torch.tools.time_attention import ptxas_lines

    return sorted((kernel_key(n), line) for n, line in ptxas_lines(source,
                                                                   log))


def differences(here: list, other: list) -> list:
    """The lines of one table that the other lacks, marked ``+`` (here)
    and ``-`` (the other tree)."""
    a, b = set(here), set(other)
    return ([f"- {n}: {line}" for n, line in sorted(b - a)]
            + [f"+ {n}: {line}" for n, line in sorted(a - b)])


def _sources(root: str) -> set:
    return {os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(root, "allrank_tpu_torch", "csrc", "*.cu"))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", help="the other checkout's root")
    parser.add_argument("sources", nargs="*")
    args = parser.parse_args(argv)
    from allrank_tpu_torch.ops import _build

    here_root = os.path.dirname(_build.PACKAGE_DIR)
    other = os.path.abspath(args.other)
    names = sorted(args.sources or (_sources(here_root)
                                    & _sources(other)))
    env = dict(os.environ, PYTHONPATH=other)
    proc = subprocess.Popen([sys.executable, "-c", _OTHER_BUILD, *names],
                            cwd=other, env=env, stdout=subprocess.PIPE,
                            text=True)
    try:
        _build.build(names)
    finally:
        out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"the build in {other} failed")
    other_logs = json.loads(out.strip().splitlines()[-1])
    differ = 0
    for name in names:
        here = table(name, _build.log_path(name))
        lines = differences(here, table(name, other_logs[name]))
        print(f"ptxas {name}: {'equal' if not lines else 'DIFFERS'} "
              f"({len(here)} lines)")
        for line in lines:
            print("   ", line)
        differ += bool(lines)
    print(f"ptxas: {len(names) - differ} of {len(names)} sources equal")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
