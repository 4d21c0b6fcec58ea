"""Compare the SASS of two builds of the kernel library, function by
function: which compiled functions of the old library are unchanged in
the new one, which changed, which are gone and which are new.  It shows
that a change which adds instantiations leaves the existing kernels'
machine code as it was.

    python -m repro_torch.kernels.sass_compare OLD.so NEW.so

Needs the CUDA toolkit's `cuobjdump` (beside `nvcc`); it runs on the
machine with the card, where the libraries are built.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

from repro_torch.kernels.build import nvcc_path


def functions(lib: str) -> Dict[str, str]:
    """{function name: its SASS instructions} of one library.  The name's
    anonymous namespace hashes the source's path, so that hash is
    dropped."""
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    res = {}
    for part in re.split(r"\n\s*Function : ", out)[1:]:
        name, body = part.split("\n", 1)
        name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", name.strip())
        res[name] = "\n".join(ln for ln in body.splitlines()
                              if ln.strip().startswith("/*"))
    return res


def main(argv: List[str]) -> int:
    old, new = functions(argv[0]), functions(argv[1])
    changed = [n for n in old if n in new and old[n] != new[n]]
    gone = [n for n in old if n not in new]
    added = [n for n in new if n not in old]
    print(f"[sass] old functions {len(old)}: identical in the new library "
          f"{len(old) - len(changed) - len(gone)}, different {len(changed)},"
          f" missing {len(gone)}; new {len(added)}")
    for tag, names in (("DIFF", changed), ("GONE", gone), ("NEW", added)):
        for n in names:
            print(f"  {tag} {n}")
    return int(bool(changed or gone))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
