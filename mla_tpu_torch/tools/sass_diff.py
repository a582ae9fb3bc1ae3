"""Another checkout's kernel libraries against this one's, instruction for
instruction, on the machine with the card:

    python3 mla_tpu_torch/tools/sass_diff.py PARENT_DIR [NAME ...]

Builds each ``csrc/<NAME>.cu`` (default: the attention, conv and int8
libraries) from both checkouts, each with its own ``_build`` into its own
build directory, and compares the cuobjdump -sass of every kernel function
(the per-file hash in anonymous-namespace names set aside). Prints one JSON
line per library and writes ``chiprun_out/sass_diff.json``; a library
whose functions all match is unchanged by the checkouts' difference.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NAMES = ("flat_attention", "flat_attention_bwd", "conv3x3", "q8_matmul",
         "q8_mlp")


def build(checkout: str, name: str) -> str:
    """The library ``name`` built by ``checkout``'s own ``_build``."""
    env = dict(os.environ, MLA_TPU_TORCH_BUILD_DIR=str(
        ROOT / "build" / f"sass_{Path(checkout).resolve().name}"))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from mla_tpu_torch.ops import _build; "
            "print(_build.build(sys.argv[2]))")
    out = subprocess.run([sys.executable, "-c", code, checkout, name],
                         env=env, capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def functions(lib: str) -> dict:
    """Each kernel function's SASS lines, by its (normalised) name."""
    sys.path.insert(0, str(ROOT))
    from mla_tpu_torch.ops import _build
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        line = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+",
                      "_GLOBAL__N_", line)
        if "Function : " in line:
            cur = out.setdefault(line.split("Function : ")[1].strip(), [])
        elif cur is not None and "/*" in line:
            cur.append(line.strip())
    return out


def main(parent: str, names):
    sides = (parent, str(ROOT))
    with ThreadPoolExecutor(2 * len(names)) as pool:
        libs = {(s, n): pool.submit(build, s, n) for s in sides for n in names}
    res = {}
    for n in names:
        a = functions(libs[(sides[0], n)].result())
        b = functions(libs[(sides[1], n)].result())
        res[n] = {"functions": len(b), "same_names": sorted(a) == sorted(b),
                  "differ": sorted(f for f in b if a.get(f) != b[f])}
        print(f"[sass] {n}: " + json.dumps(res[n]), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "sass_diff.json").write_text(
        json.dumps(res, indent=1))


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    main(sys.argv[1], tuple(sys.argv[2:]) or NAMES)
