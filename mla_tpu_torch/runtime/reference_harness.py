"""The reference side of ``runtime/parity.py``: import the original
PyTorch implementation's ``main.py`` from a checkout on disk, with CPU shims
and stubs for the third-party packages its unused import paths pull in,
build its argparse namespace from the port's config, and turn the port's
test batches into the tuples its ``valid()`` unpacks.

The port's own copy of the helpers the JAX package's parity reads from
``tests/ab_harness.py`` (the port imports nothing of ``tests/``).

CPU shims: the reference is CUDA-only research code — ``.cuda()`` calls are
made identity, tensors sent to a CUDA device (a ``torch.device`` or a
string) stay on the CPU, and oneDNN is turned off for the direct conv
algorithm. The heavy third-party deps (torchvision/torchaudio/timm) are
stubbed; timm's Attention and Mlp as their 0.4.5 math, since the
reference's CAV-MAE blocks compose them. All of it holds only inside
``reference_env``, which restores the originals on exit, so the process's
own ``.cuda()`` and ``.to("cuda")`` keep reaching the card and installed
packages of those names stay as they were.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.machinery
import importlib.util
import sys
import types
from typing import Dict

import numpy as np

_REF: Dict[str, types.ModuleType] = {}
_STUBS = ("torchvision", "torchvision.transforms", "torchaudio", "timm",
          "timm.data", "timm.models", "timm.models.layers",
          "timm.models.vision_transformer")


def _stub_module(name: str) -> types.ModuleType:
    m = types.ModuleType(name)
    # transformers probes importlib.util.find_spec("timm"); a spec-less
    # sys.modules entry makes that raise instead of returning the stub
    m.__spec__ = importlib.machinery.ModuleSpec(name, loader=None)
    sys.modules[name] = m
    return m


def _is_cuda(d) -> bool:
    import torch
    return (isinstance(d, torch.device) and d.type == "cuda") or (
        isinstance(d, str) and d.split(":")[0] == "cuda")


@contextlib.contextmanager
def reference_env(root: str):
    """The reference's import and calls run inside this: the CPU shims, the
    dependency stubs and ``root`` on ``sys.path``; every patched attribute,
    stubbed module and the path are restored on exit."""
    import torch
    import torch.nn as nn

    saved = {(torch.Tensor, "cuda"): torch.Tensor.cuda,
             (nn.Module, "cuda"): nn.Module.cuda,
             (torch.Tensor, "to"): torch.Tensor.to}
    mkldnn = torch.backends.mkldnn.enabled
    shadowed = {n: sys.modules.get(n) for n in _STUBS}
    on_path = root in sys.path
    _tensor_to = torch.Tensor.to

    def _to_cpu(self, *a, **k):
        # m3ae.py hardcodes .to(torch.device('cuda:0')) inside its forward
        # (m3ae.py:61,115,343-361) — coerce cuda targets to cpu
        a = tuple(torch.device("cpu") if _is_cuda(d) else d for d in a)
        if _is_cuda(k.get("device")):
            k["device"] = torch.device("cpu")
        return _tensor_to(self, *a, **k)

    try:
        # CUDA-written research code on the CPU
        torch.Tensor.cuda = lambda self, *a, **k: self
        nn.Module.cuda = lambda self, *a, **k: self
        torch.Tensor.to = _to_cpu
        # oneDNN picks Winograd-style 3x3 conv backwards whose fp32 numerics
        # sit ~1e-3 relative off the direct algorithm (measured: visual_net
        # grad errors collapse from 1e-1 to 1e-6 relative with it off). The
        # A/B compares algorithmic trajectories, so run torch on the direct
        # path.
        torch.backends.mkldnn.enabled = False
        _install_stubs(nn)
        if not on_path:
            sys.path.insert(0, root)
        yield
    finally:
        for (owner, name), fn in saved.items():
            setattr(owner, name, fn)
        torch.backends.mkldnn.enabled = mkldnn
        for n, m in shadowed.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m
        if not on_path and root in sys.path:
            sys.path.remove(root)


def _install_stubs(nn):
    """torchvision / torchaudio / timm stand-ins in ``sys.modules``
    (``reference_env`` puts back whatever stood there before)."""
    tv = _stub_module("torchvision")
    tr = _stub_module("torchvision.transforms")
    tv.transforms = tr
    for cls in ("Compose", "RandomResizedCrop", "RandomHorizontalFlip",
                "ToTensor", "Normalize", "Resize", "CenterCrop"):
        setattr(tr, cls, type(cls, (), {"__init__": lambda self, *a, **k: None}))
    _stub_module("torchaudio")
    timm = _stub_module("timm")
    timm.__version__ = "0.4.5"
    td = _stub_module("timm.data")
    td.create_transform = lambda *a, **k: None
    timm.data = td
    tmodels = _stub_module("timm.models")
    tlayers = _stub_module("timm.models.layers")
    tlayers.to_2tuple = lambda x: x if isinstance(x, tuple) else (x, x)
    tlayers.trunc_normal_ = lambda *a, **k: None

    class _DropPath(nn.Module):
        def __init__(self, *a, **k):
            super().__init__()

        def forward(self, x):
            return x

    tlayers.DropPath = _DropPath
    tvit = _stub_module("timm.models.vision_transformer")

    # cav_mae.py's Block composes timm's Attention/Mlp (cav_mae.py:93,101)
    # while replacing timm's PatchEmbed/Block with its own (cav_mae.py:120-124)
    # — so those two stubs must be REAL timm-0.4.5 math, the rest shells.
    class _Attention(nn.Module):
        def __init__(self, dim, num_heads=8, qkv_bias=False, qk_scale=None,
                     attn_drop=0., proj_drop=0.):
            super().__init__()
            self.num_heads = num_heads
            self.scale = qk_scale or (dim // num_heads) ** -0.5
            self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
            self.attn_drop = nn.Dropout(attn_drop)
            self.proj = nn.Linear(dim, dim)
            self.proj_drop = nn.Dropout(proj_drop)

        def forward(self, x):
            B, N, C = x.shape
            qkv = (self.qkv(x)
                   .reshape(B, N, 3, self.num_heads, C // self.num_heads)
                   .permute(2, 0, 3, 1, 4))
            q, k, v = qkv[0], qkv[1], qkv[2]
            attn = ((q @ k.transpose(-2, -1)) * self.scale).softmax(dim=-1)
            x = (self.attn_drop(attn) @ v).transpose(1, 2).reshape(B, N, C)
            return self.proj_drop(self.proj(x))

    class _Mlp(nn.Module):
        def __init__(self, in_features, hidden_features=None,
                     out_features=None, act_layer=nn.GELU, drop=0.):
            super().__init__()
            self.fc1 = nn.Linear(in_features, hidden_features or in_features)
            self.act = act_layer()
            self.fc2 = nn.Linear(hidden_features or in_features,
                                 out_features or in_features)
            self.drop = nn.Dropout(drop)

        def forward(self, x):
            return self.drop(self.fc2(self.drop(self.act(self.fc1(x)))))

    tvit.Attention = _Attention
    tvit.Mlp = _Mlp
    for cls in ("PatchEmbed", "Block"):
        setattr(tvit, cls, type(cls, (nn.Module,), {
            "__init__": lambda self, *a, **k: nn.Module.__init__(self)}))
    tmodels.layers = tlayers
    tmodels.vision_transformer = tvit
    timm.models = tmodels


def load_reference(root: str):
    """Import ``root``/main.py (once a process for each root); call it
    inside ``reference_env(root)``."""
    if root in _REF:
        return _REF[root]
    spec = importlib.util.spec_from_file_location("ref_main",
                                                  root + "/main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _REF[root] = mod
    return mod


def ref_namespace(cfg, av_alpha: float) -> argparse.Namespace:
    """The argparse namespace the reference threads everywhere
    (main.py:18-63), populated from our config."""
    return argparse.Namespace(
        dataset=cfg.dataset, modulation=cfg.modulation,
        fusion_method=cfg.fusion_method, lorb=cfg.lorb, clip=cfg.clip,
        modal3=cfg.modal3, gs_flag=cfg.gs_flag, dynamic=cfg.dynamic,
        alpha=cfg.alpha, modulation_starts=cfg.modulation_starts,
        modulation_ends=cfg.modulation_ends, av_alpha=av_alpha,
        a_alpha=cfg.a_alpha, v_alpha=cfg.v_alpha, t_alpha=cfg.t_alpha,
        use_video_frames=cfg.use_video_frames, batch_size=cfg.batch_size,
        use_tensorboard=False,
        learning_rate=cfg.learning_rate, lr_decay_step=cfg.lr_decay_step,
        lr_decay_ratio=cfg.lr_decay_ratio, random_seed=cfg.random_seed,
        mask_percent=cfg.mask_percent, mask_m=cfg.mask_m)


def test_batches(cfg):
    """The port's test stream on the host, as the driver's eval-only branch
    reads it (its loader, unshuffled, transforms on the CPU): each batch a
    dict of numpy arrays, floating features in float32 (bf16 upcast, which
    is exact)."""
    import torch
    from mla_tpu_torch.data.datasets import build_adapter
    from mla_tpu_torch.data.pipeline import Loader

    loader = Loader(build_adapter(cfg, "test"), cfg.batch_size,
                    shuffle=False, seed=cfg.random_seed,
                    num_workers=cfg.num_workers, device="cpu")
    return [{k: (v.float() if v.is_floating_point() else v).numpy()
             for k, v in b.items()} for b in loader.epoch(0)]


def _to_torch(batch: Dict[str, np.ndarray], *fields):
    """Shared converter core: padded rows dropped (valid mask) — the
    reference takes ragged final batches; trailing (label, idx) appended,
    idx as a column vector (History indexing). fields = (key, kind) with
    kind 'f' float / 'l' long / 'f0' float taking channel 0."""
    import torch
    n = int(batch["valid"].sum())
    out = []
    for key, kind in fields + (("label", "l"), ("idx", "l")):
        a = batch[key][:n, 0] if kind == "f0" else batch[key][:n]
        t = torch.from_numpy(a)
        out.append(t.long() if kind == "l" else t.float())
    out[-1] = out[-1].reshape(-1, 1)
    return tuple(out)


def to_torch_base(batch):
    """-> (spec, image, label, idx), the non-m3ae unpack (main.py:159-162)."""
    return _to_torch(batch, ("spec", "f0"), ("image", "f"))


def to_torch_m3ae(batch):
    """-> (token, padding_mask, image, label, idx), the m3ae unpack
    (main.py:153-157)."""
    return _to_torch(batch, ("token", "l"), ("padding_mask", "f"),
                     ("image", "f"))


def to_torch_large(batch):
    """-> (spec=fbank, image, label, idx) for lorb=large
    (main.py:159-162,166-168)."""
    return _to_torch(batch, ("fbank", "f"), ("image", "f"))


def to_torch_clip(batch):
    """-> (spec=token_feat, image=image_feat, label, idx) for the clip
    branch (main.py:159-162,270-273)."""
    return _to_torch(batch, ("token_feat", "f"), ("image_feat", "f"))


def to_torch_modal3(batch):
    """-> (token, padding_mask, image, spec=fbank, label, idx), the modal3
    unpack (main.py:145-151)."""
    return _to_torch(batch, ("token", "l"), ("padding_mask", "f"),
                     ("image", "f"), ("fbank", "f"))


