"""Compare the SASS of the anomaly kernels built from two source trees.

    python -m clawker_tpu_torch.kernels.sass_diff OTHER_CSRC [SOURCE ...]

builds each named source (default ``UNCHANGED``: K1's, K2's, K3's and
K5's) from this package's ``csrc/`` and from the directory OTHER_CSRC
(say, another commit's ``clawker_tpu_torch/kernels/csrc`` unpacked with
``git archive``) with ``build.NVCC_FLAGS``, one ``nvcc`` per library, all
started together; disassembles both with ``cuobjdump -sass`` and prints,
for each source, whether the two trees give the same instructions, and
kernel by kernel which are the same, which differ, and which only this
tree has.  Exits 1 if a kernel of the other tree is missing here or
differs.  A change to a shared header that must leave those kernels as
they were is held to it here; a source that gains a kernel is held to
its old ones.  Needs the CUDA
toolkit (``nvcc``, ``cuobjdump``), so it runs on the machine with the
card; nothing runs at import.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from . import build

UNCHANGED = ("anomaly_score", "anomaly_fit_step", "anomaly_fit",
             "anomaly_fit_shard")


def sass(csrc: Path, source: str, out: Path) -> str:
    """``cuobjdump -sass`` of ``csrc/<source>.cu`` built into ``out``,
    without the lines that name the file."""
    lib = out / f"lib{source}.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(csrc / f"{source}.cu")], check=True,
                   capture_output=True)
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    return "\n".join(line for line in text.splitlines()
                     if not line.startswith("Fatbin") and "file" not in line)


def kernels(text: str) -> dict[str, str]:
    """``cuobjdump -sass`` text -> each kernel's (mangled name's) SASS,
    each line's runs of blanks made one (cuobjdump pads its columns to
    the widest line of the whole library)."""
    parts = re.split(r"\n\s*Function : (\S+)\n", "\n" + text)
    return {name: "\n".join(" ".join(line.split())
                            for line in body.strip().splitlines())
            for name, body in zip(parts[1::2], parts[2::2])}


def main(argv: list[str]) -> int:
    if not argv:
        print("usage: python -m clawker_tpu_torch.kernels.sass_diff "
              "OTHER_CSRC [SOURCE ...]", file=sys.stderr)
        return 2
    other, sources = Path(argv[0]), tuple(argv[1:]) or UNCHANGED
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(tree, s, Path(tmp) / str(i)) for i, (tree, s) in
                enumerate((tree, s) for tree in (build.CSRC, other)
                          for s in sources)]
        for _, _, out in jobs:
            out.mkdir()
        with ThreadPoolExecutor(len(jobs)) as pool:
            got = list(pool.map(lambda job: sass(*job), jobs))
    same = True
    for k, source in enumerate(sources):
        mine, theirs = kernels(got[k]), kernels(got[len(sources) + k])
        differ = sorted(n for n in theirs if mine.get(n) != theirs[n])
        new = sorted(set(mine) - set(theirs))
        same &= not differ
        print(f"SASS {source}: {len(mine)} kernels, "
              f"{len(got[k].splitlines())} lines; of {other}'s "
              f"{len(theirs)}, {len(theirs) - len(differ)} the same"
              + "".join(f"\n  NOT the same (or missing): {n}"
                        for n in differ)
              + "".join(f"\n  new: {n}" for n in new))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
