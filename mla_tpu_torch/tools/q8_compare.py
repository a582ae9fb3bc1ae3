"""Parent against change on one card: ``chip_smoke.py``'s int8 kernel rows
(phase 3) and int8 serving (phase 8) on the ``mla_tpu_torch`` of another
checkout and of this one, in four processes: parent, change, change, parent.

    python3 mla_tpu_torch/tools/q8_compare.py PARENT_DIR

PARENT_DIR is another checkout's root, e.g. ``git archive`` of the parent
commit unpacked into ``build/parent`` (gitignored). Each process imports its
side's ``mla_tpu_torch``, which builds its kernels from its own sources into
its own build directory, and measures them with this checkout's
``chip_smoke.py``, so both sides are timed by the same code. Each side's
results go to ``chiprun_out/q8_<label>.json``; the rows of all four runs go
to ``chiprun_out/q8_compare.json`` and are printed.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "chiprun_out"


def side(label: str, package: str):
    """One side: phases 3 (int8 rows) and 8 with ``mla_tpu_torch`` imported
    from the checkout at ``package``."""
    sys.path.insert(0, str(Path(package).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: torch.cuda.is_available() is false")
    import mla_tpu_torch
    from mla_tpu_torch.device import set_matmul_precision
    pkg = str(Path(mla_tpu_torch.__file__).parent)
    smi = cs.nvidia_smi()
    print(f"[q8 {label}] {smi}; package {pkg}", flush=True)
    set_matmul_precision()
    gemm, mlp = cs.phase_q8_kernels()
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="q8_compare_", dir=ROOT / "build"))
    try:
        int8 = cs.phase_int8_serving(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"q8_{label}.json").write_text(json.dumps({
        "device": smi, "package": pkg, "q8_kernel_cases": gemm,
        "q8_mlp_cases": mlp, "int8_serving": int8}, indent=1))


def compare(parent: str):
    runs = [("parent_1", parent), ("change_1", str(ROOT)),
            ("change_2", str(ROOT)), ("parent_2", parent)]
    for label, pkg in runs:
        rc = subprocess.run([sys.executable, __file__, "--side", label,
                             str(Path(pkg).resolve())], cwd=ROOT).returncode
        if rc != 0:
            sys.exit(f"the int8 run {label} failed (exit {rc})")
    res = {label: json.loads((OUT_DIR / f"q8_{label}.json").read_text())
           for label, _ in runs}

    def key(r):
        kernel = ("B5" if r["stacked"] else "B4") if "site" in r else "B6"
        return f"{kernel} {r.get('site', 'mlp')} {r['rows']} " + (
            "W8A8" if r["a8"] else "weight-only")
    kernels = {}
    for label, r_ in res.items():
        for r in r_["q8_kernel_cases"] + r_["q8_mlp_cases"]:
            kernels.setdefault(key(r), {})[label] = {
                f: r.get(f) for f in ("ms", "ms_median", "device_ms",
                                      "quantize_ms")}
    serving = {}
    for label, r_ in res.items():
        for kind, r in r_["int8_serving"].items():
            if kind == "bfloat16_rungs":
                serving.setdefault("bfloat16", {})[label] = {
                    "median_ms": {n: v["median_ms"] for n, v in r.items()}}
            elif kind != "fp32_bytes":
                prof = r["profiles"]["64"]        # JSON keys are strings
                serving.setdefault(kind, {})[label] = {
                    "median_ms": {n: v["median_ms"]
                                  for n, v in r["rungs"].items()},
                    "n64_device_ms": prof["device_ms"],
                    "n64_top": prof["top"][:6]}
    print(f"[q8 compare] {res['change_1']['device']}; runs "
          + ", ".join(label for label, _ in runs))
    for k, v in {**kernels, **serving}.items():
        print(f"[q8 compare] {k}: {json.dumps(v)}")
    (OUT_DIR / "q8_compare.json").write_text(json.dumps(
        {"device": res["change_1"]["device"], "kernels": kernels,
         "serving": serving}, indent=1))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--side"]:
        side(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 2:
        compare(sys.argv[1])
    else:
        sys.exit(__doc__)
