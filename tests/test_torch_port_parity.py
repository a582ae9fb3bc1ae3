"""The port's accuracy-parity eval (``mla_tpu_torch/runtime/parity.py``)
against the JAX package's (``mla_tpu/runtime/parity.py``), on the CPU: on
a seeded CREMA-D tree at the JAX recipe's sizes
(``tests/test_eval_paths.py::TestParityRecipe``: 8 + 8 clips, (64, 80)
spectrograms, 32x32 frames, the full ResNet-18, fp32, batch 4) and one
reference-layout ``.pth``, both parities with ``--reference ""`` report the
same ``ours``; the port's test stream for the reference side equals the
one JAX's parity captures; the same refusals; and the reference side,
run from a stand-in checkout the test writes (the original
implementation's is not in the repository), inside its CPU shims, which
are all undone afterwards.
"""

import json
import sys

import numpy as np
import pytest

from mla_tpu.runtime import parity as jparity



def _argv(root, pth, *extra):
    return ["--dataset", "CREMAD", "--lorb", "base", "--gs_flag",
            "--data_root", root, "--ckpt_path", pth, "--batch_size", "4",
            "--image_size", "32", "--compute_dtype", "float32", *extra]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    import torch
    from mla_tpu.data import synthetic
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.data.datasets import build_adapter
    from mla_tpu_torch.data.pipeline import Loader
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.models.torch_export import save_torch_checkpoint

    d = tmp_path_factory.mktemp("parity")
    root = str(d / "cre")
    synthetic.make_cremad(root, n_train=8, n_test=8, spec_shape=(64, 80))
    cfg = MLAConfig(dataset="CREMAD", lorb="base", gs_flag=True,
                    image_size=32, compute_dtype="float32", batch_size=4,
                    data_root=root).validate()
    model = build_classifier(cfg, seed=3)
    # BatchNorm statistics of the test clips, so that the answers spread
    # over the classes (a fresh ResNet's running statistics give one class)
    loader = Loader(build_adapter(cfg, "test"), 4, shuffle=False,
                    num_workers=1, device="cpu")
    model.train()
    with torch.no_grad():
        for _ in range(10):
            for batch in loader.epoch(0):
                model(batch)
    pth = str(d / "model.pth")
    save_torch_checkpoint(pth, model, cfg)
    return root, pth, d


@pytest.mark.parametrize("dynamic", [False, True], ids=["fixed", "dynamic"])
def test_ours_equals_jax_parity(tree, dynamic):
    from mla_tpu_torch.runtime import parity

    root, pth, d = tree
    extra = ["-dynamic"] if dynamic else []
    out = str(d / f"port_{dynamic}.json")
    want = jparity.main(["--reference", ""] + _argv(root, pth, *extra))
    got = parity.main(["--reference", "", "--out", out, "--device", "cpu"]
                      + _argv(root, pth, *extra))
    assert got["reference"] is None and want["reference"] is None
    assert got["config"] == want["config"]
    assert set(got["ours"]) == {"acc", "acc_a", "acc_v"}
    assert got["ours"] == want["ours"]
    assert json.loads(open(out).read()) == got


def test_reference_side_stream_equals_jax_capture(tree):
    """The batches the reference's valid() would get from the port equal
    those JAX's parity captures (spectrograms bit for bit; frames within
    the resample's fp32 tolerance), and convert to the same tuples."""
    import ab_harness
    from mla_tpu.core.config import config_from_args as jconfig
    from mla_tpu_torch.core.config import config_from_args
    from mla_tpu_torch.runtime import reference_harness as rh

    root, pth, _ = tree
    argv = _argv(root, pth)
    got = rh.test_batches(config_from_args(argv))
    _, want, _ = ab_harness.capture_batches(jconfig(argv), epochs=0)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("spec", "label", "idx", "valid"):
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
        np.testing.assert_allclose(g["image"], np.asarray(w["image"]),
                                   atol=1e-5, rtol=0)
        tg, tw = rh.to_torch_base(g), ab_harness.to_torch_base(w)
        assert [t.shape for t in tg] == [t.shape for t in tw]
        assert [t.dtype for t in tg] == [t.dtype for t in tw]


def test_refusals(tmp_path):
    from mla_tpu_torch.runtime import parity
    with pytest.raises(SystemExit, match="eval-only"):
        parity.main(["--train", "--dataset", "CREMAD", "--lorb", "base",
                     "--ckpt_path", "x.pth", "--device", "cpu"])
    with pytest.raises(SystemExit, match="ckpt_path"):
        parity.main(["--dataset", "CREMAD", "--lorb", "base", "--ckpt_path",
                     str(tmp_path / "missing.pth"), "--device", "cpu"])


FAKE_REFERENCE = """
import json, os
import torch
import torch.nn as nn
import timm
from timm.models.vision_transformer import Attention

HERE = os.path.dirname(os.path.abspath(__file__))


class AVClassifier(nn.Module):
    def __init__(self, args):
        super().__init__()
        self.fc = nn.Linear(2, 6)


def valid(args, model, device, dataloader, gs_flag=False, av_alpha=0.5):
    model = model.cuda()
    labels, shapes = [], []
    for spec, image, label, idx in dataloader:
        spec = spec.cuda().to(torch.device("cuda:0"))
        image = image.to("cuda")
        assert spec.device.type == image.device.type == "cpu"
        labels += label.tolist()
        shapes.append([list(spec.shape), list(image.shape), list(idx.shape)])
    json.dump({"timm": timm.__version__, "attention": Attention.__name__,
               "mkldnn": torch.backends.mkldnn.enabled, "device": str(device),
               "dataset": args.dataset, "gs_flag": gs_flag,
               "training": model.training, "labels": labels,
               "shapes": shapes}, open(os.path.join(HERE, "seen.json"), "w"))
    acc = sum(lab == 0 for lab in labels) / len(labels)
    return acc, acc / 2, acc / 4
"""


@pytest.mark.parametrize("tolerance", [100.0, -1.0], ids=["pass", "fail"])
def test_reference_side_runs_inside_its_shims(tree, tmp_path, tolerance):
    """An explicit --reference runs that checkout's valid() on the port's
    test stream, with .cuda() / .to("cuda") kept on the CPU, oneDNN off and
    timm stubbed, and puts every patched attribute, module and path back
    afterwards; the report carries the diff, and a failed band exits 2."""
    import torch
    import torch.nn as nn
    from mla_tpu_torch.core.config import config_from_args
    from mla_tpu_torch.runtime import parity
    from mla_tpu_torch.runtime import reference_harness as rh

    root, pth, _ = tree
    ref = tmp_path / "ref"
    ref.mkdir()
    (ref / "main.py").write_text(FAKE_REFERENCE)
    before = (torch.Tensor.cuda, torch.Tensor.to, nn.Module.cuda,
              torch.backends.mkldnn.enabled, sys.modules.get("timm"),
              list(sys.path))
    argv = ["--device", "cpu", "--reference", str(ref), "--tolerance",
            str(tolerance), "--out", str(tmp_path / "r.json"),
            *_argv(root, pth)]
    if tolerance < 0:
        with pytest.raises(SystemExit) as e:
            parity.main(argv)
        assert e.value.code == 2
        report = json.loads((tmp_path / "r.json").read_text())
    else:
        report = parity.main(argv)
    assert (torch.Tensor.cuda, torch.Tensor.to, nn.Module.cuda,
            torch.backends.mkldnn.enabled, sys.modules.get("timm"),
            list(sys.path)) == before

    seen = json.loads((ref / "seen.json").read_text())
    batches = rh.test_batches(config_from_args(_argv(root, pth)))
    labels = [int(v) for b in batches
              for v in b["label"][:int(b["valid"].sum())]]
    assert seen == {"timm": "0.4.5", "attention": "_Attention",
                    "mkldnn": False, "device": "cpu", "dataset": "CREMAD",
                    "gs_flag": True, "training": False, "labels": labels,
                    "shapes": [[[4, 64, 80], [4, 3, 3, 32, 32], [4, 1]]] * 2}
    acc = sum(lab == 0 for lab in labels) / len(labels)
    assert report["reference"] == {"acc": acc, "acc_a": acc / 2,
                                   "acc_v": acc / 4}
    assert report["diff_pct_points"] == {
        k: round((report["ours"][k] - report["reference"][k]) * 100.0, 4)
        for k in ("acc", "acc_a", "acc_v")}
    assert report["tolerance_pct_points"] == tolerance
    assert report["pass"] is (tolerance > 0)
