"""One-command real-data accuracy parity: the reference's eval against the
port's (port of ``mla_tpu/runtime/parity.py``).

Given dataset artifact roots and a trained reference checkpoint (e.g. the
released Zenodo .pth files, reference README.md:29), run both evals and
diff top-1.

    python -m mla_tpu_torch.runtime.parity --dataset CREMAD --lorb base \\
        --gs_flag -dynamic --data_root ROOT --ckpt_path model.pth \\
        [--reference DIR] [--tolerance 0.3] [--out report.json] \\
        [--device cuda|cpu]

Takes the full training-CLI flag surface (core/config.py); extra flags:
  --reference DIR   the PyTorch reference checkout to run the reference
                    side from; without it (or with --reference "") only
                    the port's accuracy is printed
  --tolerance PCT   pass/fail band on |top-1 diff| in percentage points
                    (default 0.3)
  --out FILE        also write the JSON verdict to FILE
  --device          where the port's eval runs, as ``runtime/cli.py``
                    parses it: the card (the default) or the CPU

The port's side is the driver's eval-only branch, which loads the .pth
through ``convert.load_reference_checkpoint`` (strict key mapping). The
reference side is its own ``valid()`` from main.py (CUDA shimmed to CPU
inside ``reference_harness.reference_env``, which restores everything on
exit) on its own model classes with the same .pth (main.py:946-953), fed
the port's test stream from the port's loader on the CPU. A failed band
exits with code 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def reference_accs(cfg, reference_root: str, test_batches, ckpt_path: str):
    """The reference's own valid() on its own model + the same .pth and the
    same test batches -> {'acc','acc_a','acc_v'[,'acc_t']}."""
    from mla_tpu_torch.runtime import reference_harness as rh

    with rh.reference_env(reference_root):
        return _reference_valid(rh, rh.load_reference(reference_root), cfg,
                                test_batches, ckpt_path)


def _reference_valid(rh, ref, cfg, test_batches, ckpt_path):
    import torch
    import torch.nn as nn

    args = rh.ref_namespace(cfg, cfg.av_alpha)

    if cfg.lorb in ("m3ae", "large"):
        # the ctors torch.load hardcoded '/path/to/*.pth' pretrained files
        # (basic_model.py:108-117,166-174,234-242); {} + strict=False keeps
        # random init — the real weights come from ckpt_path below
        _load = torch.load
        torch.load = lambda *a, **k: {}
        try:
            model = (ref.CAVClassifier(args) if cfg.lorb == "large"
                     else ref.Modal3Classifier(args) if cfg.modal3
                     else ref.M3AEClassifier(args))
        finally:
            torch.load = _load
    elif cfg.clip:
        model = ref.CLIPClassifier(args)
    else:
        model = ref.AVClassifier(args)
    model = nn.DataParallel(model)  # Zenodo ckpts carry 'module.' keys
    loaded = torch.load(ckpt_path, map_location="cpu")
    sd = loaded.get("model", loaded) if isinstance(loaded, dict) else loaded
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if missing or unexpected:
        print(f"reference load_state_dict: missing={list(missing)[:4]} "
              f"unexpected={list(unexpected)[:4]}", file=sys.stderr)
    model.eval()

    conv = (rh.to_torch_modal3 if cfg.modal3
            else rh.to_torch_m3ae if cfg.lorb == "m3ae"
            else rh.to_torch_large if cfg.lorb == "large"
            else rh.to_torch_clip if cfg.clip
            else rh.to_torch_base)
    test_t = [conv(b) for b in test_batches]
    kw = dict(a_alpha=cfg.a_alpha, v_alpha=cfg.v_alpha,
              t_alpha=cfg.t_alpha) if cfg.modal3 else {}
    ret = ref.valid(args, model, torch.device("cpu"), test_t,
                    gs_flag=cfg.gs_flag, av_alpha=cfg.av_alpha, **kw)
    keys = ("acc", "acc_a", "acc_v") + (("acc_t",) if cfg.modal3 else ())
    return {k: float(v) for k, v in zip(keys, ret)}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--reference", default="")
    extra.add_argument("--tolerance", default=0.3, type=float,
                       help="pass band on |top-1 diff|, percentage points")
    extra.add_argument("--out", default=None)
    extra.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    mine, rest = extra.parse_known_args(argv)

    from mla_tpu_torch.core.config import config_from_args
    from mla_tpu_torch.device import resolve_device
    cfg = config_from_args(rest)
    if cfg.train:
        raise SystemExit("parity is an eval-only protocol; drop --train")
    if not cfg.ckpt_path or not os.path.exists(cfg.ckpt_path):
        raise SystemExit("--ckpt_path must point to the trained checkpoint "
                         f"(got {cfg.ckpt_path!r})")
    device = resolve_device(mine.device)

    from mla_tpu_torch.runtime.driver import run
    _, ours = run(cfg, device=device)
    ours = {k: float(v) for k, v in ours.items()}

    report = {"config": {"dataset": cfg.dataset, "lorb": cfg.lorb,
                         "modal3": cfg.modal3, "clip": cfg.clip,
                         "gs_flag": cfg.gs_flag, "dynamic": cfg.dynamic,
                         "modulation": cfg.modulation,
                         "ckpt": cfg.ckpt_path},
              "ours": ours}
    if mine.reference:
        from mla_tpu_torch.runtime.reference_harness import test_batches
        ref_accs = reference_accs(cfg, mine.reference, test_batches(cfg),
                                  cfg.ckpt_path)
        diffs = {k: round((ours[k] - ref_accs[k]) * 100.0, 4)
                 for k in ref_accs if k in ours}
        report["reference"] = ref_accs
        report["diff_pct_points"] = diffs
        report["tolerance_pct_points"] = mine.tolerance
        report["pass"] = bool(abs(diffs.get("acc", 0.0)) <= mine.tolerance)
    else:
        report["reference"] = None

    line = json.dumps(report)
    print(line)
    if mine.out:
        with open(mine.out, "w") as f:
            f.write(line + "\n")
    if mine.reference and not report["pass"]:
        raise SystemExit(2)
    return report


if __name__ == "__main__":
    main()
