"""int8 and W8A8 serving of the port (runtime/export.py int8 artifacts, the
int8 sites of models/, ops/q8_matmul.py) against the JAX package's int8
serving function (mla_tpu/runtime/export.py:make_serving_fn with dequant)
on the CPU, for the three M3AE artifact kinds (int8 unrolled, int8
--scan_blocks, int8_a8 --scan_blocks) and the AV family's int8 artifact.

Debug M3AE (2 blocks, 1024 wide, 256-token vocabulary, 8 tokens, 32x32
images; --gs_flag -dynamic), fp32 compute on both sides. The JAX weights go
through JAX's ``_quantize_int8``; the port exports its own artifact from the
same float weights (equal to the bridged int8 tree, checked here).

Two JAX references:
(a) as JAX runs on the CPU: its q8 entry points take the reference laws
    (the weight dequantized in bf16, then a bf16 dot; the MLP site by site).
    The port follows the kernel laws, so the two differ by bf16 rounding:
    relative L2 <= 2e-2 of the logits.
(b) with the JAX q8 entry points switched to Pallas interpret mode here (the
    kernel laws; nothing in mla_tpu/ changes): the remaining differences are
    LayerNorm's variance formula and sums in other orders (fp32, ~1e-6),
    each of which can move a bf16 rounding of a GEMM output by one ulp, and
    erf against the TPU kernel's polynomial in the fused MLP: atol 2e-3 on
    logits of magnitude ~1. W8A8: 5e-3, since such a difference also moves
    an activation lying that close to a quantization boundary one int8 step
    over (one step moves a GEMM output by |W s| xs, ~3e-3 here).

Calibration: the same site names, errors within 1e-4, the same skip set at
a threshold between two of the sites' errors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.core.config import MLAConfig as JConfig
from mla_tpu.models.classifiers import M3AEClassifier as JClassifier
from mla_tpu.parallel.pp import to_scan_layout
from mla_tpu.runtime.export import (_quantize_int8, calibrate_a8,
                                    make_serving_fn)

VOCAB, L, IMG, NB = 256, 8, 32, 4
TIGHT = {"int8": 2e-3, "int8_a8": 5e-3}
REL_REF = 2e-2
KINDS = {"int8": ("int8", False), "int8_scan": ("int8", True),
         "int8_a8_scan": ("int8_a8", True)}


def _feats(seed=0, n=NB):
    rng = np.random.default_rng(seed)
    pm = np.zeros((n, L), np.float32)
    pm[0, 6:] = 1.0
    pm[1, 2:] = 1.0
    return {"token": rng.integers(0, VOCAB, (n, L)).astype(np.int32),
            "padding_mask": pm,
            "image": rng.standard_normal((n, 3, IMG, IMG)).astype(np.float32)}


def _jcfg(scan):
    return JConfig(dataset="Food101", lorb="m3ae", gs_flag=True, dynamic=True,
                   m3ae_size="debug", image_size=IMG, compute_dtype="float32",
                   scan_blocks=scan).validate()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX models and params (both layouts, one set of weights), the port's
    float model from them, and the port's int8 artifacts of each kind with
    their JAX counterparts' ingredients."""
    import torch
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import M3AEClassifier
    from mla_tpu_torch.models.convert import state_dict_from_jax
    from mla_tpu_torch.runtime.export import export_serving

    torch.set_num_threads(1)
    jm = {scan: JClassifier(n_classes=101, gs_flag=True, model_type="debug",
                            text_vocab_size=VOCAB, dtype=jnp.float32,
                            scan_blocks=scan) for scan in (False, True)}
    f = {k: jnp.asarray(v) for k, v in _feats().items()}
    params = jax.tree.map(np.asarray, jm[False].init(
        jax.random.key(0), f, train=False)["params"])
    jparams = {False: params, True: to_scan_layout(params)}
    with torch.device("meta"):
        model = M3AEClassifier(n_classes=101, gs_flag=True,
                               model_type="debug", text_vocab_size=VOCAB)
    model.load_state_dict(state_dict_from_jax(params, _jcfg(False)),
                          strict=True, assign=True)
    root = tmp_path_factory.mktemp("int8")
    arts = {}
    for kind, (dtype, scan) in KINDS.items():
        cfg = MLAConfig(dataset="Food101", lorb="m3ae", gs_flag=True,
                        dynamic=True, m3ae_size="debug", image_size=IMG,
                        compute_dtype="float32", scan_blocks=scan).validate()
        arts[kind] = export_serving(cfg, model, str(root / kind),
                                    batch_sizes=(2, 4), weights_dtype=dtype,
                                    example_batch=_feats(), device="cpu")
    return jm, jparams, arts


def _jax_serve(jm, jparams, kind, feats, skip=(), interpret=False):
    dtype, scan = KINDS[kind]
    serve = make_serving_fn(jm[scan], _jcfg(scan), dequant=True,
                            a8=dtype == "int8_a8", a8_skip=frozenset(skip))
    q = _quantize_int8(jparams[scan])
    batch = {k: jnp.asarray(v) for k, v in feats.items()}
    batch["valid"] = jnp.ones(len(feats["token"]), jnp.float32)
    if not interpret:
        out = serve(q, {}, batch)
    else:
        from mla_tpu.models import layers as jl
        from mla_tpu.models import m3ae as jm3
        from mla_tpu.ops import q8_matmul as jq
        mp = pytest.MonkeyPatch()
        try:
            mp.setattr(jl, "q8_matmul",
                       functools.partial(jq.q8_matmul, interpret=True))
            mp.setattr(jl, "q8_matmul_stacked", functools.partial(
                jq.q8_matmul_stacked, interpret=True))
            mp.setattr(jm3, "q8_matmul",
                       functools.partial(jq.q8_matmul, interpret=True))
            mp.setattr(jq, "q8_mlp_stacked", functools.partial(
                jq.q8_mlp_stacked, interpret=True))
            out = serve(q, {}, batch)
        finally:
            mp.undo()
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


@pytest.mark.parametrize("kind", list(KINDS))
def test_int8_serving_matches_jax(setup, kind):
    """Each artifact kind on the port (CPU, plain versions of B4/B5/B6)
    against JAX with the kernel laws (tight) and with its CPU reference
    laws (bf16 tolerance), and the routes the port took."""
    from mla_tpu_torch.models.layers import Mlp, Q8Linear
    from mla_tpu_torch.runtime.export import load_serving

    jm, jparams, arts = setup
    srv = load_serving(arts[kind], device="cpu")
    dtype, scan = KINDS[kind]
    assert srv.meta["weights_dtype"] == dtype
    assert srv.meta["config"]["scan_blocks"] == scan
    sites = [m for m in srv.model.modules() if isinstance(m, Q8Linear)]
    mlps = [m for m in srv.model.modules() if isinstance(m, Mlp)]
    assert len(sites) == 2 * (4 * 2 + 1)           # block sites + image
    skip = srv.meta["a8_skip"]
    fused = scan and (dtype == "int8" or not {"mlp/fc1", "mlp/fc2"} & set(
        skip))
    assert all(m.fused == fused for m in mlps)
    assert all(m.a8 == (dtype == "int8_a8" and bool(m.site)
                        and m.site not in skip) for m in sites)
    feats = _feats(1)
    got = srv(feats)
    tight = _jax_serve(jm, jparams, kind, feats, skip, interpret=True)
    ref = _jax_serve(jm, jparams, kind, feats, skip)
    for k in tight:
        assert got[k].shape == (NB, 101)
        np.testing.assert_allclose(got[k], tight[k], atol=TIGHT[dtype],
                                   rtol=0, err_msg=k)
        rel = np.linalg.norm(got[k] - ref[k]) / np.linalg.norm(ref[k])
        assert rel <= REL_REF, (k, rel)
    # padding never changes a real row's per-modality logits
    three = srv({k: v[:3] for k, v in feats.items()})
    for m in ("a", "v"):
        np.testing.assert_array_equal(three[f"logits_{m}"],
                                      got[f"logits_{m}"][:3])


def test_calibration_matches_jax(setup):
    """calibrate_a8 on both sides: the same shared scan-layout site names
    (every layer of both encoders under one name), errors within 1e-4, and
    the same skip set at a threshold between two sites' errors; the
    unrolled layout names every block's site."""
    import torch
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.runtime import export as pexport

    jm, jparams, arts = setup
    feats = _feats(2)
    jfeats = dict(feats, valid=np.ones(NB, np.float32))
    jerrs, _ = calibrate_a8(jm[True], _jcfg(True), _quantize_int8(
        jparams[True]), {}, jfeats)
    assert set(jerrs) == {"attn/qkv", "attn/proj", "mlp/fc1", "mlp/fc2"}
    sd = torch.load(f"{arts['int8_a8_scan']}/weights.pt", weights_only=True)
    cfg = {scan: MLAConfig(dataset="Food101", lorb="m3ae", gs_flag=True,
                           dynamic=True, m3ae_size="debug", image_size=IMG,
                           compute_dtype="float32", scan_blocks=scan
                           ).validate() for scan in (False, True)}
    errs, _ = pexport.calibrate_a8(cfg[True], sd, feats, device="cpu")
    assert set(errs) == set(jerrs)
    for s in jerrs:
        assert abs(errs[s] - jerrs[s]) <= 1e-4, (s, errs[s], jerrs[s])
    vals = sorted(jerrs.values())
    gap = max(range(len(vals) - 1), key=lambda i: vals[i + 1] - vals[i])
    thr = 0.5 * (vals[gap] + vals[gap + 1])
    _, jskip = calibrate_a8(jm[True], _jcfg(True), _quantize_int8(
        jparams[True]), {}, jfeats, threshold=thr)
    _, skip = pexport.calibrate_a8(cfg[True], sd, feats, "cpu",
                                    threshold=thr)
    assert skip == jskip and 0 < len(skip) < 4
    jerrs_u, _ = calibrate_a8(jm[False], _jcfg(False), _quantize_int8(
        jparams[False]), {}, jfeats)
    errs_u, _ = pexport.calibrate_a8(cfg[False], sd, feats, "cpu")
    assert set(errs_u) == set(jerrs_u)
    assert "mae_a/block_0/attn/qkv" in errs_u and len(errs_u) == 16
    for s in jerrs_u:
        assert abs(errs_u[s] - jerrs_u[s]) <= 1e-4, s


def test_a8_skip_routes_the_mlp_site_by_site(setup, tmp_path):
    """An int8_a8 artifact whose skip set holds one MLP site runs that
    site weight-only and the Mlp site by site (no fused MLP), and matches
    JAX with the same skip set (kernel laws)."""
    import json
    import shutil

    from mla_tpu_torch.models.layers import Mlp, Q8Linear
    from mla_tpu_torch.runtime.export import load_serving

    jm, jparams, arts = setup
    art = str(tmp_path / "skip")
    shutil.copytree(arts["int8_a8_scan"], art)
    meta = json.load(open(f"{art}/meta.json"))
    meta["a8_skip"] = ["mlp/fc2"]
    json.dump(meta, open(f"{art}/meta.json", "w"))
    srv = load_serving(art, device="cpu")
    assert not any(m.fused for m in srv.model.modules()
                   if isinstance(m, Mlp))
    fc2 = [m for m in srv.model.modules()
           if isinstance(m, Q8Linear) and m.site == "mlp/fc2"]
    assert len(fc2) == 4 and not any(m.a8 for m in fc2)
    feats = _feats(3)
    got = srv(feats)
    want = _jax_serve(jm, jparams, "int8_a8_scan", feats, ["mlp/fc2"],
                      interpret=True)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TIGHT["int8_a8"],
                                   rtol=0, err_msg=k)


def test_export_round_trip_equals_the_bridged_jax_tree(setup, tmp_path):
    """The port's own int8 artifact (quantize_int8 -> weights.pt) holds
    what convert.py makes of JAX's _quantize_int8 tree, in both JAX
    layouts; a ServingModel loaded from the bridged tree answers exactly
    as the port's artifact does."""
    import shutil

    import torch
    from mla_tpu_torch.models.convert import state_dict_from_jax
    from mla_tpu_torch.runtime.export import load_serving

    jm, jparams, arts = setup
    sd = torch.load(f"{arts['int8_scan']}/weights.pt", weights_only=True)
    for scan in (False, True):
        bridged = state_dict_from_jax(_quantize_int8(jparams[scan]),
                                      _jcfg(scan))
        assert set(bridged) == set(sd)
        for k, t in sd.items():
            b = bridged[k]
            assert t.dtype in (torch.int8, torch.float32, torch.bfloat16), k
            assert (b.dtype == torch.int8) == (t.dtype == torch.int8), k
            assert tuple(b.shape) == tuple(t.shape), k
            np.testing.assert_array_equal(b.float().numpy(),
                                          t.float().numpy(), err_msg=k)
    art = str(tmp_path / "bridged")
    shutil.copytree(arts["int8_scan"], art)
    torch.save(state_dict_from_jax(_quantize_int8(jparams[True]),
                                   _jcfg(True)), f"{art}/weights.pt")
    feats = _feats(4)
    a = load_serving(art, device="cpu")(feats)
    b = load_serving(arts["int8_scan"], device="cpu")(feats)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    sizes = {k: sum(t.numel() * t.element_size() for t in torch.load(
        f"{arts[k]}/weights.pt", weights_only=True).values()) for k in arts}
    assert len(set(sizes.values())) == 1


def test_av_int8_artifact_matches_jax(tmp_path):
    """The AV family's int8 artifact (every weight dequantized at load as
    q8.bf16 * scale.bf16, BatchNorm statistics float32) against JAX's
    int8 serving function on the same weights and statistics: fp32
    compute, atol 2e-4 (the float AV serving test's)."""
    import torch
    from mla_tpu.models.classifiers import build_classifier
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import make_classifier
    from mla_tpu_torch.models.convert import state_dict_from_jax
    from mla_tpu_torch.runtime.export import export_serving, load_serving

    stages, t = (1, 1, 1, 1), 2
    jcfg = JConfig(dataset="CREMAD", lorb="base", compute_dtype="float32",
                   resnet_stages=stages, gs_flag=True, dynamic=True,
                   train=True).validate()
    rng = np.random.default_rng(5)
    b = {"spec": rng.standard_normal((3, 1, 33, 40)).astype(np.float32),
         "image": rng.standard_normal((3, 3, t, IMG, IMG)).astype(np.float32)}
    jmodel = build_classifier(jcfg)
    var = jax.tree.map(np.asarray, jmodel.init(
        jax.random.key(0), {k: jnp.asarray(v) for k, v in b.items()},
        train=True))
    params, stats = var["params"], var["batch_stats"]
    stats = jax.tree.map(lambda a: a + 0.1 * np.abs(rng.standard_normal(
        a.shape)).astype(np.float32), stats)
    serve = make_serving_fn(jmodel, jcfg, dequant=True)
    want = serve(_quantize_int8(params), stats,
                 {**{k: jnp.asarray(v) for k, v in b.items()},
                  "valid": jnp.ones(3, jnp.float32)})
    tcfg = MLAConfig(dataset="CREMAD", lorb="base", gs_flag=True,
                     dynamic=True, resnet_stages=stages,
                     compute_dtype="float32").validate()
    model = make_classifier(tcfg)
    model.load_state_dict(state_dict_from_jax(params, tcfg, stats),
                          strict=True, assign=True)
    art = export_serving(tcfg, model, str(tmp_path / "av8"),
                         batch_sizes=(4,), weights_dtype="int8",
                         example_batch=b)
    sd = torch.load(f"{art}/weights.pt", weights_only=True)
    assert sd["visual_net.layer1.0.conv1.weight"].dtype == torch.int8
    assert sd["visual_net.bn1.running_mean"].dtype == torch.float32
    srv = load_serving(art, device="cpu")
    conv = srv.model.visual_net.layer1[0].conv1.weight
    assert conv.dtype == torch.float32          # dequantized, in fp32 compute
    np.testing.assert_array_equal(
        conv.detach().numpy(),
        (sd["visual_net.layer1.0.conv1.weight"].to(torch.bfloat16)
         * sd["visual_net.layer1.0.conv1.weight_scale"].to(torch.bfloat16)
         ).float().numpy())
    got = srv(b)
    for k in ("fused", "logits_a", "logits_v"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=2e-4,
                                   rtol=2e-4, err_msg=k)


def test_export_cli_int8_a8(setup, tmp_path):
    """``python -m mla_tpu_torch.runtime.export --export_dtype int8_a8
    --scan_blocks --calibration NPZ`` from a reference-layout checkpoint
    writes the artifact the API writes from the same weights and batch;
    without --calibration it refuses."""
    import torch
    from mla_tpu_torch.models.convert import state_dict_from_jax
    from mla_tpu_torch.runtime import export

    jm, jparams, arts = setup
    ckpt, cal = str(tmp_path / "m.pth"), str(tmp_path / "cal.npz")
    torch.save(state_dict_from_jax(jparams[False], _jcfg(False)), ckpt)
    np.savez(cal, **_feats())
    args = ["--checkpoint", ckpt, "--dataset", "Food101", "--lorb", "m3ae",
            "--gs_flag", "-dynamic", "--m3ae_size", "debug", "--image_size",
            str(IMG), "--compute_dtype", "float32", "--export_batch_sizes",
            "2,4", "--scan_blocks", "--export_dtype", "int8_a8", "--device",
            "cpu"]
    with pytest.raises(SystemExit, match="calibration"):
        export.main(args + ["--export_dir", str(tmp_path / "x")])
    art = str(tmp_path / "cli")
    export.main(args + ["--export_dir", art, "--calibration", cal])
    srv = export.load_serving(art, device="cpu")
    ref = export.load_serving(arts["int8_a8_scan"], device="cpu")
    assert srv.meta["weights_dtype"] == "int8_a8"
    assert srv.meta["config"]["scan_blocks"] is True
    assert srv.meta["a8_site_rel_err"] == ref.meta["a8_site_rel_err"]
    assert srv.meta["feature_specs"] == ref.meta["feature_specs"]
    feats = _feats(6)
    a, b = srv(feats), ref(feats)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
