"""Parent against change on one card: a group of ``chip_smoke.py``'s phases
on the ``mla_tpu_torch`` of another checkout and of this one, in four
processes: parent, change, change, parent.

    python3 mla_tpu_torch/tools/compare.py q8|conv PARENT_DIR

Groups: ``q8``, the int8 kernel rows (phase 3) and int8 serving (phase 8);
``conv``, the 3x3 conv rows (phase 3), AV serving (phase 6) and AV training
(phase 7). PARENT_DIR is another checkout's root, e.g. ``git archive`` of
the parent commit unpacked into ``build/parent`` (gitignored). Each process
imports its side's ``mla_tpu_torch``, which builds its kernels from its own
sources into its own build directory, and measures them with this
checkout's ``chip_smoke.py``, so both sides are timed by the same code.
Each side's results go to ``chiprun_out/<group>_<label>.json``; the rows of
all four runs go to ``chiprun_out/<group>_compare.json`` and are printed.
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


def side(group: str, label: str, package: str):
    """One side: the group's phases with ``mla_tpu_torch`` imported from the
    checkout at ``package``."""
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
    print(f"[{group} {label}] {smi}; package {pkg}", flush=True)
    set_matmul_precision()
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="compare_", dir=ROOT / "build"))
    try:
        if group == "q8":
            gemm, mlp = cs.phase_q8_kernels()
            res = {"q8_kernel_cases": gemm, "q8_mlp_cases": mlp,
                   "int8_serving": cs.phase_int8_serving(work)}
        else:
            rows, dx_rows = cs.phase_conv_kernels()
            res = {"conv_kernel_cases": rows, "conv_dx_cases": dx_rows,
                   "av_serving": cs.phase_av_serving(work),
                   "av_training": cs.phase_av_training()}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"{group}_{label}.json").write_text(json.dumps(
        {"device": smi, "package": pkg, **res}, indent=1))


def q8_summary(res):
    """The int8 rows and int8 serving of each run, by kernel and kind."""
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
    return {"kernels": kernels, "serving": serving}


def conv_summary(res):
    """The conv rows, AV serving and AV training of each run."""
    kernels, av = {}, {}
    for label, r_ in res.items():
        for r in r_["conv_kernel_cases"]:
            kernels.setdefault(f"B3 {r['name']} {r['dtype']}", {})[label] = {
                f: r.get(f) for f in ("ms", "device_ms", "library_ms",
                                      "library_device_ms", "tflops")}
        srv, tr = r_["av_serving"], r_["av_training"]
        av.setdefault("serving", {})[label] = {
            "median_ms": {n: v["median_ms"] for n, v in srv["rungs"].items()},
            "n64_device_ms": srv["profile"]["device_ms"],
            "n64_b3_ms": srv["profile"]["match_ms"],
            "n64_top": srv["profile"]["top"][:6]}
        av.setdefault("training", {})[label] = {
            f: tr[f] for f in ("median_step_ms", "off_median_step_ms",
                               "step_ms", "off_step_ms")} | {
            "device_ms": tr["profile"]["device_ms"],
            "b3_ms": tr["profile"]["match_ms"],
            "top": tr["profile"]["top"][:6]}
    return {"kernels": kernels, "av": av}


def compare(group: str, parent: str):
    runs = [("parent_1", parent), ("change_1", str(ROOT)),
            ("change_2", str(ROOT)), ("parent_2", parent)]
    for label, pkg in runs:
        rc = subprocess.run([sys.executable, __file__, "--side", group,
                             label, str(Path(pkg).resolve())],
                            cwd=ROOT).returncode
        if rc != 0:
            sys.exit(f"the {group} run {label} failed (exit {rc})")
    res = {label: json.loads((OUT_DIR / f"{group}_{label}.json").read_text())
           for label, _ in runs}
    summary = (q8_summary if group == "q8" else conv_summary)(res)
    print(f"[{group} compare] {res['change_1']['device']}; runs "
          + ", ".join(label for label, _ in runs))
    for part in summary.values():
        for k, v in part.items():
            print(f"[{group} compare] {k}: {json.dumps(v)}")
    (OUT_DIR / f"{group}_compare.json").write_text(json.dumps(
        {"device": res["change_1"]["device"], **summary}, indent=1))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--side"]:
        side(*sys.argv[2:5])
    elif len(sys.argv) == 3 and sys.argv[1] in ("q8", "conv"):
        compare(sys.argv[1], sys.argv[2])
    else:
        sys.exit(__doc__)
