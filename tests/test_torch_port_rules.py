"""Rules of the PyTorch port that hold on any machine:

- nothing in mla_tpu_torch/ or chip_smoke.py imports jax, flax or mla_tpu;
- entry points run on the card unless the CPU is asked for, and raise when
  no card is present (no fallback);
- a CPU tensor reaches the plain attention and a CUDA tensor never does.
"""

import ast
import os
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "mla_tpu")


def _port_files():
    files = sorted((ROOT / "mla_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_imports_no_jax_and_nothing_of_mla_tpu():
    files = _port_files()
    assert len(files) > 15 and all(f.exists() for f in files)
    # the walk reaches the ETL package and the parity eval
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"mla_tpu_torch/data/etl/cli.py", "mla_tpu_torch/ops/stft.py",
            "mla_tpu_torch/runtime/parity.py",
            "mla_tpu_torch/runtime/reference_harness.py"} <= names
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_resolve_device_never_falls_back(monkeypatch):
    import torch
    from mla_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()                    # cuda is the default
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    import torch
    from mla_tpu_torch.core.config import MLAConfig, config_from_args
    from mla_tpu_torch.data.etl import cli as etl
    from mla_tpu_torch.runtime import cli, driver, export, parity, serve

    # the device knob belongs to the entry points (serve --device; export
    # --device, for int8_a8's calibration forward); the config has none
    assert not hasattr(MLAConfig(), "device")
    with pytest.raises(SystemExit):
        config_from_args(["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "meta.json").write_text("{}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.load_serving(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.calibrate_a8(MLAConfig(), {}, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--artifact", str(tmp_path), "--input", "x.npz"])
    # the training CLI and the driver: --device / device= default to cuda
    assert cli.parse_args(["--train"])[1] == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--train", "--data_root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.run(MLAConfig(train=True, data_root=str(tmp_path)))
    # the ETL CLI's audio subcommands (--device) and the parity eval; the
    # subcommands that touch no device run without one
    for cmd in etl.DEVICE_COMMANDS:
        inputs = 3 if cmd == "preprocess-iemo" else 1
        with pytest.raises(RuntimeError, match="no CUDA device"):
            etl.main([cmd, *[str(tmp_path)] * inputs, str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
    assert etl.parse_args(["extract-spec", "i", "o", "--device", "cpu"]
                          ).device == torch.device("cpu")
    (tmp_path / "all.txt").write_text("a.flv x\nb.flv y\n")
    etl.main(["gen-txt", str(tmp_path / "all.txt"), str(tmp_path / "my")])
    assert (tmp_path / "my_train.txt").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity.main(["--reference", "", "--ckpt_path",
                     str(tmp_path / "meta.json")])


def test_cpu_tensor_takes_plain_version_cuda_tensor_never(monkeypatch):
    import torch
    from mla_tpu_torch.ops import attention

    calls = []
    real_plain = attention.flat_attention_reference
    monkeypatch.setattr(attention, "flat_attention_reference",
                        lambda *a: calls.append("plain") or real_plain(*a))
    monkeypatch.setattr(attention, "flash_attention_flat",
                        lambda *a: calls.append("kernel") or "kernel-out")
    qkv = torch.zeros(1, 3, 3 * 2 * 16)
    attention.fused_attention_qkv(qkv, None, 2)
    assert calls == ["plain"]

    calls.clear()
    fake_cuda = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert attention.fused_attention_qkv(fake_cuda, None, 2) == "kernel-out"
    assert calls == ["kernel"]


def test_kernel_wrapper_rejects_what_it_cannot_launch():
    import torch
    from mla_tpu_torch.ops.attention import flash_attention_flat

    before = flash_attention_flat.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_flat(torch.zeros(1, 3, 96), None, 2)
    assert flash_attention_flat.launches == before


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """The build happens at first use and raises without nvcc; nothing is
    compiled when a module is imported."""
    from mla_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nocuda"))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has a CUDA toolkit at the default path")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    src = (_build.CSRC / "flat_attention.cu").read_text()
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert 'extern "C" int mla_flat_attention_fwd' in src
    assert _build.build_dir() == ROOT / "build" / "mla_tpu_torch"
    assert _build.library_path("flat_attention").parent == _build.build_dir()
    monkeypatch.setenv("MLA_TPU_TORCH_BUILD_DIR", str(tmp_path / "b"))
    assert _build.library_path("flat_attention").parent == tmp_path / "b"
