"""Training algorithms as step functions (port of ``mla_tpu/train/steps.py``).

Covers the reference regimes (reference: main.py:127-484):
  - MLA alternating unimodal adaptation (gs_flag branch, main.py:419-476):
    K sequential (encoder_m + shared-head) sub-updates per batch. Each
    sub-step recomputes its own modality's features with the then-current
    head (grad-equivalent to the reference's forward-once-then-K-backwards).
  - Joint fusion 'Normal' + OGM / OGM_GE gradient modulation (main.py:165-418)
  - QMF quality-aware fusion with History + margin-rank loss (main.py:108-125,
    170-268)

Every step is ``step(state, batch, lr, batch_index, epoch=0) -> (state,
metrics)``: ``lr`` comes from the epoch schedule (``optim.lr_for_epoch``),
``batch`` holds the model's inputs plus ``label`` (B,) int, ``valid`` (B,)
float (0 = padded row) and, for QMF, ``idx`` (B,) int (n_data for a padded
row). The state is updated in place and returned; the metrics are 0-d
tensors on the state's device (reading one synchronises).

Every step puts the model in training mode, the JAX package's
``train=True``: BatchNorm normalises with the batch statistics and updates
its running ones in place, in the order the JAX step threads
``batch_stats`` (the MLA step's audio sub-step updates audio_net's, the
visual sub-step visual_net's; under --grad_accum one microbatch after the
other). Under --masked_bn the encoders read ``valid``.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from mla_tpu_torch.models.classifiers import modalities_of
from mla_tpu_torch.train import optim
from mla_tpu_torch.train.gs import gs_before_update
from mla_tpu_torch.train.optim import HEAD_WEIGHT
from mla_tpu_torch.train.state import QMFState, TrainState, modality_of_path

# ---------------------------------------------------------------------------
# losses / helpers
# ---------------------------------------------------------------------------


def ce_per_sample(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0]


def masked_ce(logits, labels, valid):
    nll = ce_per_sample(logits, labels)
    return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1.0)


def _microbatches(batch, k: int) -> List[dict]:
    """Contiguous split of every leaf (b, ...) into k microbatches
    (--grad_accum). The split preserves row order, so concatenating the
    per-microbatch outputs reproduces the full-batch tensors — what lets GS
    (full-batch feature mean) and OGM (full-batch score coefficients) run on
    the reassembled tensors with unchanged semantics."""
    for x in batch.values():
        if x.shape[0] % k:
            raise ValueError(f"--grad_accum {k} does not divide the batch "
                             f"dimension {x.shape[0]}")
    parts = {n: torch.chunk(x, k, dim=0) for n, x in batch.items()}
    return [{n: p[i] for n, p in parts.items()} for i in range(k)]


def _grads(loss_of, mbs, names, params, n_total, accum_dtype):
    """Gradients of the loss over ``names``, summed over the microbatches
    (one pass when there is one). ``loss_of(mb, norm)`` -> (loss, aux); with
    microbatches each loss is normalised by the FULL batch's valid count, so
    the sum is the full-batch gradient up to fp order. Accumulated sums round
    to ``accum_dtype`` (--accum_dtype) after every add, as the JAX package's
    scan carry does. Returns ({name: grad or None}, loss, [aux per mb])."""
    want = [params[n] for n in names]
    acc, total, auxes = None, None, []
    for mb in mbs:
        loss, aux = loss_of(mb, None if len(mbs) == 1 else n_total)
        g = torch.autograd.grad(loss, want, allow_unused=True)
        if len(mbs) > 1:
            g = [None if x is None else
                 (x.to(accum_dtype) if acc is None else
                  (a.to(x.dtype) + x).to(accum_dtype))
                 for x, a in zip(g, acc or [None] * len(g))]
        acc = g
        total = loss.detach() if total is None else total + loss.detach()
        auxes.append(aux)
    return dict(zip(names, acc)), total, auxes


def _mb_loss(logits, mb, norm):
    if norm is None:
        return masked_ce(logits, mb["label"], mb["valid"])
    return torch.sum(ce_per_sample(logits, mb["label"]) * mb["valid"]) / norm


def sliced_modality_logits(feats: Dict[str, torch.Tensor], fusion_module,
                           fusion_method: str, modal3: bool,
                           bias_div: bool):
    """Per-modality logits reconstructed from the fused head by column-slicing
    its weight (reference: main.py:274-302 train, 593-620 eval). Types
    follow the JAX package, which multiplies the features by the raw
    parameters (bf16 features and fp32 weights give fp32 logits).

    bias_div: the reference divides the bias by K at eval but NOT at train for
    'sum' fusion (main.py:277-283 vs 596-600); concat always divides.
    """
    def head(x, w, b, div):
        dt = torch.promote_types(x.dtype, w.dtype)
        return F.linear(x.to(dt), w.to(dt)) + b.to(dt) / div

    if fusion_method == "sum":
        div = 2.0 if bias_div else 1.0
        fx, fy = fusion_module.fc_x, fusion_module.fc_y
        return {"a": head(feats["a"], fx.weight, fx.bias, div),
                "v": head(feats["v"], fy.weight, fy.bias, div)}
    w, b = fusion_module.fc_out.weight, fusion_module.fc_out.bias  # (C, K*D)
    k = 3 if modal3 else 2
    d = w.shape[1] // k
    return {m: head(feats[m], w[:, i * d:(i + 1) * d], b, k)
            for i, m in enumerate(("a", "v", "t")[:k])}


# ---------------------------------------------------------------------------
# MLA alternating step (gs branch, main.py:419-476)
# ---------------------------------------------------------------------------

def make_mla_train_step(model, cfg, spec: optim.OptimizerSpec, len_dl: int):
    modalities = modalities_of(cfg)
    k = cfg.grad_accum
    accum_dtype = getattr(torch, cfg.accum_dtype)
    params = dict(model.named_parameters())
    modes = {m: optim.modality_mode_tree(params, modality_of_path, m,
                                         modalities[:i], cfg.ghost_updates)
             for i, m in enumerate(modalities)}
    # only REAL leaves use a gradient: ask autograd for those alone
    real = {m: [n for n, md in modes[m].items() if md == optim.REAL]
            for m in modalities}

    def step(state: TrainState, batch, lr, batch_index, epoch=0):
        del epoch
        model.train()
        valid = batch["valid"]
        n_total = torch.clamp(torch.sum(valid), min=1.0)
        mbs = _microbatches(batch, k) if k > 1 else [batch]
        losses = {}
        gs = state.gs
        for m in modalities:
            def loss_of(mb, norm, m=m):
                feat = model.encode(mb, m)
                return _mb_loss(model.head(feat), mb, norm), feat.detach()

            grads, loss, feats = _grads(loss_of, mbs, real[m], params,
                                        n_total, accum_dtype)
            # GS plugin on the shared-head weight grad (main.py:437,449,461)
            gs, grads[HEAD_WEIGHT] = gs_before_update(
                gs, torch.cat(feats), grads[HEAD_WEIGHT], batch_index,
                len_dl, cfg.gs_rls)
            optim.apply_updates(spec, params, grads, state.opt_state, lr,
                                modes[m])
            losses[m] = loss
        state.gs = gs
        state.step += 1
        # av_alpha-weighted epoch loss (main.py:472)
        total = losses["a"] * cfg.av_alpha + losses["v"] * (1 - cfg.av_alpha)
        return state, {"loss": total,
                       **{f"loss_{m}": l for m, l in losses.items()}}

    return step


# ---------------------------------------------------------------------------
# Joint step: Normal / OGM / OGM_GE (main.py:165-418)
# ---------------------------------------------------------------------------

def _ogm_coeffs(out_m: Dict[str, torch.Tensor], label, valid, alpha, modal3):
    """Discriminative-score ratios -> per-modality grad coefficients
    (main.py:345-368 2-modal, main.py:315-338 3-modal)."""
    def score(o):
        p = torch.softmax(o.float(), dim=1)
        return torch.sum(p.gather(1, label.long()[:, None])[:, 0] * valid)

    s = {m: score(o) for m, o in out_m.items()}

    def damp(r):
        return 1.0 - torch.tanh(alpha * torch.relu(r))

    one = torch.ones((), dtype=torch.float32, device=valid.device)
    if modal3:
        ratio_v = s["v"] / (s["a"] + s["t"])
        ratio_a = s["a"] / (s["v"] + s["t"])
        ratio_t = s["t"] / (s["v"] + s["a"])
        # if ratio_v>1: damp v; elif ratio_t>1: damp t; else damp a
        cv = torch.where(ratio_v > 1, damp(ratio_v), one)
        ct = torch.where((ratio_v <= 1) & (ratio_t > 1), damp(ratio_t), one)
        ca = torch.where((ratio_v <= 1) & (ratio_t <= 1), damp(ratio_a), one)
        return {"a": ca, "v": cv, "t": ct}, ratio_v
    ratio_v = s["v"] / s["a"]
    cv = torch.where(ratio_v > 1, damp(ratio_v), one)
    ca = torch.where(ratio_v > 1, one, damp(1.0 / ratio_v))
    return {"a": ca, "v": cv}, ratio_v


def _ogm_grad_label(top: str, modal3: bool):
    """Which coefficient (if any) scales parameters under this top-level
    module. Name-substring parity with the reference: the 3-modal branch
    matches 'mae_a'/'mae_v'/'mae_t' (main.py:352-368), but the 2-modal branch
    only matches 'audio'/'visual' (main.py:396-407) — so for lorb=m3ae/large
    (modules named mae_*) 2-modal OGM modulates NOTHING in the reference,
    and neither does the port; for lorb=base it scales the conv weights of
    audio_net and visual_net."""
    if modal3:
        return {"mae_a": "a", "mae_v": "v", "mae_t": "t"}.get(top)
    if "audio" in top:
        return "a"
    if "visual" in top:
        return "v"
    return None


@torch.no_grad()
def _modulate_grads(grads, coeffs, rng, use_ge: bool, active: bool,
                    modal3: bool):
    """Scale 4-D (conv) grads of each modality's encoder by its coefficient;
    OGM_GE adds N(0, grad.std()) noise from ``rng`` (main.py:346-369,
    396-407). ``active``: modulation_starts <= epoch <= modulation_ends."""
    if not active:
        return grads
    out = {}
    for name, g in grads.items():
        lbl = _ogm_grad_label(name.split(".")[0], modal3)
        if g is not None and lbl in coeffs and g.dim() == 4:
            mod = g * coeffs[lbl]
            if use_ge:
                noise = torch.randn(g.shape, generator=rng, device=g.device,
                                    dtype=g.dtype)
                mod = mod + noise * (torch.std(g, unbiased=False) + 1e-8)
            g = mod
        out[name] = g
    return out


def make_joint_train_step(model, cfg, spec: optim.OptimizerSpec):
    use_ogm = cfg.modulation in ("OGM", "OGM_GE")
    use_ge = cfg.modulation == "OGM_GE"
    k = cfg.grad_accum
    accum_dtype = getattr(torch, cfg.accum_dtype)
    params = dict(model.named_parameters())
    names = list(params)

    def step(state: TrainState, batch, lr, batch_index, epoch=0):
        del batch_index
        model.train()
        valid, label = batch["valid"], batch["label"]
        n_total = torch.clamp(torch.sum(valid), min=1.0)

        def loss_of(mb, norm):
            out = model(mb)
            feats = {m: out[m].detach() for m in out if m in ("a", "v", "t")}
            with torch.no_grad():
                out_m = sliced_modality_logits(
                    feats, model.fusion_module, cfg.fusion_method,
                    cfg.modal3, bias_div=cfg.fusion_method != "sum")
            return _mb_loss(out["out"], mb, norm), out_m

        mbs = _microbatches(batch, k) if k > 1 else [batch]
        grads, loss, outs = _grads(loss_of, mbs, names, params, n_total,
                                   accum_dtype)
        out_m = {m: torch.cat([o[m] for o in outs]) for m in outs[0]}
        metrics = {"loss": loss}
        if use_ogm:
            coeffs, ratio_v = _ogm_coeffs(out_m, label, valid, cfg.alpha,
                                          cfg.modal3)
            active = cfg.modulation_starts <= epoch <= cfg.modulation_ends
            grads = _modulate_grads(grads, coeffs, state.rng, use_ge, active,
                                    cfg.modal3)
            # per-iteration TB scalars 'data/ratio v' + 'data/coefficient *'
            # (main.py:339-344, 386-390)
            metrics.update({"ratio_v": ratio_v,
                            **{f"coeff_{m}": c for m, c in coeffs.items()}})
        optim.apply_updates(spec, params, grads, state.opt_state, lr)
        for m, o in out_m.items():
            metrics[f"loss_{m}"] = masked_ce(o, label, valid)
        state.step += 1
        return state, metrics

    return step


# ---------------------------------------------------------------------------
# QMF step (main.py:108-125 rank loss; 170-268 per-path losses)
# ---------------------------------------------------------------------------

def _energy_conf(logits):
    """confidence = logsumexp(logits)/10 per sample (main.py:173-181), as the
    reference writes it (log of a sum of exps)."""
    e = torch.log(torch.sum(torch.exp(logits.float()), dim=1))
    return e / 10.0


def _rank_loss(conf, idx, correctness, valid, n_valid):
    """Margin-rank loss over rolled batch pairs (main.py:108-125), with the
    roll confined to valid rows (padding is a suffix)."""
    b = conf.shape[0]
    pos = torch.arange(b, device=conf.device)
    nxt = torch.where(pos + 1 >= n_valid, torch.zeros_like(pos), pos + 1)
    idx2 = idx[nxt]
    c1, c2 = correctness[idx], correctness[idx2]
    # the reference normalizes by the min/max of the whole history array
    gmin, gmax = torch.min(correctness[:-1]), torch.max(correctness[:-1])
    rng = torch.clamp(gmax - gmin, min=1e-12)
    n1, n2 = (c1 - gmin) / rng, (c2 - gmin) / rng
    target = torch.sign(n1 - n2)
    margin = torch.abs(n1 - n2)
    target_nz = torch.where(target == 0, torch.ones_like(target), target)
    x1 = conf
    x2 = conf[nxt] + margin / target_nz
    per = torch.relu(target * (x1 - x2))
    return torch.sum(per * valid) / torch.clamp(n_valid, min=1.0)


def make_qmf_train_step(model, cfg, spec: optim.OptimizerSpec):
    modalities = modalities_of(cfg)
    # base path: loss = cml + clf + 0.1*crl (main.py:264-268);
    # m3ae paths: loss = mean(clf + crl), fused CE not in the loss
    # (main.py:203-207, 230-235)
    base_path = cfg.lorb == "base"
    params = dict(model.named_parameters())
    names = list(params)

    def step(state: TrainState, batch, lr, batch_index, epoch=0):
        del batch_index, epoch
        model.train()
        valid, label = batch["valid"], batch["label"]
        idx = batch["idx"].long()
        n_valid = torch.sum(valid)
        qmf = state.qmf
        out_m = model(batch)
        confs = {m: _energy_conf(out_m[m]) for m in modalities}
        clf = sum(masked_ce(out_m[m], label, valid) for m in modalities)
        # rank loss against the POST-update history (main.py:194-199)
        new_corr, new_conf, crl = {}, {}, 0.0
        for m in modalities:
            per_loss = (ce_per_sample(out_m[m], label) * valid).detach()
            corr = qmf.correctness[m].index_add(0, idx, per_loss)
            cfd = qmf.confidence[m].index_put(
                (idx,), confs[m].detach() * valid)
            new_corr[m], new_conf[m] = corr, cfd
            crl = crl + _rank_loss(confs[m], idx, corr, valid, n_valid)
        if base_path:
            fused = sum(out_m[m] * confs[m].detach()[:, None]
                        for m in modalities)
            loss = masked_ce(fused, label, valid) + clf + 0.1 * crl
        else:
            loss = clf + crl
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[n] for n in names], allow_unused=True)))
        optim.apply_updates(spec, params, grads, state.opt_state, lr)
        metrics = {"loss": loss.detach()}
        for m in modalities:
            metrics[f"loss_{m}"] = masked_ce(out_m[m].detach(), label, valid)
        state.qmf = QMFState(correctness=new_corr, confidence=new_conf)
        state.step += 1
        return state, metrics

    return step


def make_train_step(model, cfg, spec, len_dl):
    """Regime dispatch on cfg.regime (core/config.py), mirroring
    train_epoch's branches (main.py:164,419)."""
    if cfg.regime == "mla":
        return make_mla_train_step(model, cfg, spec, len_dl)
    if cfg.regime == "qmf":
        return make_qmf_train_step(model, cfg, spec)
    if cfg.modulation == "QMF":
        # reference branch order: `if lorb == "large"` precedes the QMF
        # check (main.py:166-170), so CAV runs the joint path
        print("NOTE: --modulation QMF is inert for --lorb large "
              "(reference main.py:166-170 runs the joint path)")
    return make_joint_train_step(model, cfg, spec)
