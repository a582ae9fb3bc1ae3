"""The port's weight bridge (mla_tpu_torch/models/convert.py) against the JAX
package's exporter: state_dict_from_jax equals
mla_tpu.models.torch_export.export_classifier key for key and value for
value, and a .pth written by save_torch_checkpoint loads through
load_reference_checkpoint into the port with strict=True and exports a
serving artifact (mla_tpu_torch.runtime.export.main)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.core.config import MLAConfig as JConfig
from mla_tpu.models import torch_export
from mla_tpu.models.classifiers import M3AEClassifier as JClassifier

VOCAB = 256


def _init(gs, scan_blocks=False, qmf=False, seed=0):
    model = JClassifier(n_classes=101, gs_flag=gs, qmf=qmf,
                        model_type="debug", text_vocab_size=VOCAB,
                        scan_blocks=scan_blocks, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    batch = {"token": jnp.asarray(rng.integers(0, VOCAB, (2, 8)), jnp.int32),
             "padding_mask": jnp.zeros((2, 8), jnp.float32),
             "image": jnp.asarray(rng.standard_normal((2, 3, 32, 32)),
                                  jnp.float32)}
    params = model.init(jax.random.key(seed), batch, train=False)["params"]
    cfg = JConfig(dataset="Food101", lorb="m3ae", gs_flag=gs,
                  modulation="QMF" if qmf else "Normal", m3ae_size="debug",
                  scan_blocks=scan_blocks, train=True).validate()
    return jax.tree.map(np.asarray, params), cfg


@pytest.mark.parametrize("gs,scan_blocks,qmf", [
    (True, False, False), (True, True, False), (False, False, False),
    (False, False, True)])
def test_state_dict_from_jax_equals_export_classifier(gs, scan_blocks, qmf):
    from mla_tpu_torch.models.convert import state_dict_from_jax

    params, cfg = _init(gs, scan_blocks, qmf)
    want = torch_export.export_classifier(params, {}, cfg)
    got = state_dict_from_jax(params, cfg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype.is_floating_point
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_reference_pth_loads_strict_and_exports(tmp_path):
    import torch
    from mla_tpu_torch.models.classifiers import M3AEClassifier
    from mla_tpu_torch.models.convert import (load_reference_checkpoint,
                                              state_dict_from_jax)
    from mla_tpu_torch.runtime import export

    params, cfg = _init(True, seed=1)
    path = str(tmp_path / "ref.pth")
    torch_export.save_torch_checkpoint(path, (params, {}), cfg)
    sd = load_reference_checkpoint(path)
    assert not any(k.startswith("module.") for k in sd)
    direct = state_dict_from_jax(params, cfg)
    assert sorted(sd) == sorted(direct)
    assert all(torch.equal(sd[k], direct[k]) for k in sd)
    with torch.device("meta"):
        model = M3AEClassifier(n_classes=101, gs_flag=True,
                               model_type="debug", text_vocab_size=VOCAB)
    model.load_state_dict(sd, strict=True, assign=True)

    art = str(tmp_path / "art")
    export.main(["--checkpoint", path, "--dataset", "Food101", "--lorb",
                 "m3ae", "--gs_flag", "-dynamic", "--m3ae_size", "debug",
                 "--image_size", "32", "--export_dir", art,
                 "--export_dtype", "bfloat16", "--export_batch_sizes", "1,4"])
    srv = export.load_serving(art, device="cpu", compute_dtype="float32")
    assert srv.meta["weights_dtype"] == "bfloat16"
    assert srv.batch_sizes == [1, 4]
    assert srv.meta["feature_specs"]["image"]["shape"] == [3, 32, 32]
    assert srv.meta["feature_specs"]["token"]["shape"] == [256]
    w = dict(srv.model.state_dict())["fusion_module.fc_out.weight"]
    np.testing.assert_array_equal(
        w.numpy(), sd["fusion_module.fc_out.weight"].to(torch.bfloat16)
        .float().numpy())


def test_other_families_raise():
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.models.convert import state_dict_from_jax

    for kw in (dict(dataset="CREMAD", lorb="large"),
               dict(dataset="Food101", clip=True),
               dict(dataset="IEMOCAP", lorb="m3ae", modal3=True)):
        cfg = MLAConfig(**kw).validate()
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_classifier(cfg)
    with pytest.raises(NotImplementedError):
        state_dict_from_jax({}, MLAConfig(dataset="CREMAD",
                                          lorb="large").validate())
