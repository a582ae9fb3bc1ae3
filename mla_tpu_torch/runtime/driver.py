"""Epoch orchestration: the main() / train_epoch() / valid() driver (port of
``mla_tpu/runtime/driver.py``).

Reference: main.py:697-968. Same control flow as the JAX driver on one
device: seed -> model -> loaders -> one sample batch -> train state ->
optional warm start -> train and eval steps -> eval-only branch or resume ->
epoch loop (lr schedule, per-epoch metric means, eval, best checkpoint on
accuracy, rolling ``last`` checkpoint) -> serving / reference exports, with
TensorBoard scalars under the reference's names (main.py:865-893) and the
same printed lines.

The device is the caller's choice (``run(cfg, device=...)``: the card
unless 'cpu' is asked for), never a config flag. Flags that need more than
one device raise ``NotImplementedError`` naming their ROADMAP item; none is
ignored silently.
"""

from __future__ import annotations

import datetime
import math
import os
import time
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from mla_tpu_torch.core.config import MLAConfig
from mla_tpu_torch.data.datasets import build_adapter
from mla_tpu_torch.data.pipeline import Loader
from mla_tpu_torch.device import resolve_device, set_matmul_precision
from mla_tpu_torch.evals.metrics import make_eval_step, summarize_counts
from mla_tpu_torch.models.classifiers import build_classifier
from mla_tpu_torch.runtime import checkpoint as ckpt_lib
from mla_tpu_torch.train import optim
from mla_tpu_torch.train.state import create_train_state
from mla_tpu_torch.train.steps import make_train_step
from mla_tpu_torch.utils.seed import setup_seed

# (flag is set, what to say, ROADMAP item): the multi-device flags
_NOT_PORTED = (
    (lambda c: c.mesh_shape is not None and math.prod(c.mesh_shape) > 1,
     "--mesh_shape with more than one device", "9"),
    (lambda c: c.fsdp, "--fsdp", "9"),
    (lambda c: c.seq_parallel, "--seq_parallel", "9"),
    (lambda c: c.pp_microbatches, "--pp_microbatches", "9"),
    (lambda c: c.pp_remat, "--pp_remat", "9"),
    (lambda c: c.dist_coordinator or c.dist_num_processes != 1
     or c.dist_process_id != 0, "--dist_*", "9"),
)
# flags that name JAX mechanisms: accepted, and said to be ignored
_JAX_ONLY = (("scan_unroll", 1), ("compile_cache", ""))


def check_flags(cfg: MLAConfig) -> None:
    """Raise for a flag the port cannot honour yet; say which flags it
    ignores because they name JAX mechanisms."""
    for is_set, flag, item in _NOT_PORTED:
        if is_set(cfg):
            raise NotImplementedError(
                f"{flag} is not ported yet: ROADMAP queue A, item {item}")
    for name, default in _JAX_ONLY:
        if getattr(cfg, name) != default:
            print(f"NOTE: --{name} names a JAX mechanism; the PyTorch port "
                  "ignores it")
    if cfg.lorb == "base" and (cfg.pretrained_a or cfg.pretrained_v
                               or cfg.pretrained_t):
        print("NOTE: --pretrained_a/v/t has no encoder to load for --lorb "
              "base (the JAX package loads none either)")


def _writer(cfg: MLAConfig):
    if not cfg.use_tensorboard:
        return None
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    tag = "GS" if cfg.gs_flag else cfg.modulation
    log_name = "{}_{}_{}".format(
        cfg.fusion_method, tag,
        datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"))
    path = os.path.join(cfg.tensorboard_path, cfg.dataset, log_name)
    os.makedirs(path, exist_ok=True)
    return SummaryWriter(path)


def scalar_groups(cfg: MLAConfig, epoch_metrics: Dict[str, float],
                  accs: Dict[str, float]):
    """TensorBoard scalar groups, exactly the reference's names
    (main.py:865-893)."""
    loss_scalars = {"Total Loss": epoch_metrics.get("loss", 0.0),
                    "Audio Loss": epoch_metrics.get("loss_a", 0.0),
                    "Visual Loss": epoch_metrics.get("loss_v", 0.0)}
    eval_scalars = {"Total Accuracy": accs.get("acc", 0.0),
                    "Audio Accuracy": accs.get("acc_a", 0.0),
                    "Visual Accuracy": accs.get("acc_v", 0.0)}
    if cfg.modal3:
        loss_scalars["Text Loss"] = epoch_metrics.get("loss_t", 0.0)
        eval_scalars["Text Accuracy"] = accs.get("acc_t", 0.0)
    return loss_scalars, eval_scalars


def _export_torch(cfg: MLAConfig, state, epoch: int, acc: float) -> None:
    """--export_torch: a reference-loadable .pth from the live state."""
    from mla_tpu_torch.models.torch_export import save_torch_checkpoint
    save_torch_checkpoint(cfg.export_torch, state.model, cfg, epoch=epoch,
                          acc=acc)
    print(f"Exported torch checkpoint to {cfg.export_torch}")


def _export_serving(cfg: MLAConfig, state, sample: Dict) -> str:
    """--export_dir: the serving artifact of the current weights, its
    feature shapes from the sample batch."""
    from mla_tpu_torch.ops import attention as attn_lib
    from mla_tpu_torch.runtime.export import export_serving, feature_keys
    attn_lib.set_flat_attention(True)
    sizes = tuple(cfg.export_batch_sizes) if cfg.export_batch_sizes else \
        (1, 8, cfg.batch_size)
    # floating features at the boundary's float32 (a bf16 image included);
    # the others (M3AE's int32 tokens) keep their type, as in the JAX
    # package's export_from_driver
    example = {k: (sample[k].float() if sample[k].is_floating_point()
                   else sample[k]).cpu().numpy()
               for k in feature_keys(state.model)}
    path = export_serving(cfg, state.model, cfg.export_dir,
                          batch_sizes=sizes, weights_dtype=cfg.export_dtype,
                          example_batch=example,
                          device=next(state.model.parameters()).device)
    print(f"Serving artifact exported to {path} "
          f"(batch sizes {sorted(set(int(b) for b in sizes))}, "
          f"weights {cfg.export_dtype})")
    return path


def evaluate(cfg, state, loader, eval_step) -> Dict[str, float]:
    totals = None
    for batch in loader.epoch(0):
        counts = eval_step(batch)
        totals = counts if totals is None else \
            {k: totals[k] + v for k, v in counts.items()}
    if totals is None:
        return {}
    return summarize_counts(totals)


def run(cfg: MLAConfig, max_steps_per_epoch: Optional[int] = None,
        device=None):
    """Train (cfg.train) or evaluate a checkpoint (not cfg.train) on
    ``device`` (the card unless 'cpu' is asked for; raises without one).
    Returns (state, {'best_acc', 'history'}), or (state, accs) for
    eval-only."""
    from mla_tpu_torch.ops import attention as attn_lib
    dev = resolve_device(device)
    check_flags(cfg)
    attn_lib.set_flat_attention(True)
    try:
        return _run(cfg, max_steps_per_epoch, dev)
    finally:
        attn_lib.set_flat_attention(True)


def _run(cfg: MLAConfig, max_steps_per_epoch: Optional[int],
         dev: torch.device):
    setup_seed(cfg.random_seed)              # setup_seed (utils.py:98-103)
    set_matmul_precision()
    train_adapter = build_adapter(cfg, "train")
    test_adapter = build_adapter(cfg, "test")
    model = build_classifier(cfg, seed=cfg.random_seed)
    train_loader = Loader(train_adapter, cfg.batch_size, shuffle=True,
                          seed=cfg.random_seed, num_workers=cfg.num_workers,
                          device=dev)
    test_loader = Loader(test_adapter, cfg.batch_size, shuffle=False,
                         seed=cfg.random_seed, num_workers=cfg.num_workers,
                         device=dev)

    sample_gen = train_loader.epoch(0)
    sample = next(sample_gen)
    sample_gen.close()  # stop the prefetch producer deterministically
    spec = optim.make_spec(cfg)
    state = create_train_state(model, cfg, spec, n_data=len(train_adapter),
                               seed=cfg.random_seed, device=dev)
    # cav_opti lr groups need the parameter names (main.py:739-746)
    spec = optim.make_spec(cfg, state.params)
    if cfg.pretrained_a or cfg.pretrained_v or cfg.pretrained_t:
        from mla_tpu_torch.models.torch_import import load_pretrained_encoders
        load_pretrained_encoders(cfg, state.model)
    if cfg.ckpt_load_path_train:
        ckpt_lib.warm_start_params(cfg.ckpt_load_path_train, state.model)
        print("Trained model loaded!")

    len_dl = len(train_loader)
    train_step = make_train_step(state.model, cfg, spec, len_dl)
    eval_step = make_eval_step(state.model, cfg)

    if not cfg.train:
        # eval-only: cfg.ckpt_path is the checkpoint to load
        # (main.py:946-953); .pth/.pt/.pkl files are reference checkpoints
        if cfg.ckpt_path.endswith((".pth", ".pt", ".pkl")):
            from mla_tpu_torch.models.convert import load_reference_checkpoint
            state.model.load_state_dict(
                load_reference_checkpoint(cfg.ckpt_path), strict=True)
        else:
            ckpt_lib.restore_checkpoint(cfg.ckpt_path, state)
        accs = evaluate(cfg, state, test_loader, eval_step)
        print("Accuracy:", accs)
        if cfg.export_dir:
            _export_serving(cfg, state, sample)
        if cfg.export_torch:
            _export_torch(cfg, state, epoch=0, acc=accs.get("acc", 0.0))
        return state, accs

    start_epoch = 0
    best_acc = 0.0
    if cfg.resume:
        # mid-run resume: the full train state plus epoch/best-acc come
        # back, so an interrupted run equals an uninterrupted one
        ckpt_lib.restore_checkpoint(cfg.resume, state)
        meta = ckpt_lib.load_meta(cfg.resume)
        if "saved_epoch" not in meta:
            raise ValueError(
                f"cannot resume from {cfg.resume}: metadata has no "
                "saved_epoch (meta.json missing and the name encodes none)")
        start_epoch = int(meta["saved_epoch"]) + 1
        best_acc = float(meta.get("best_acc", meta.get("acc", 0.0)))
        print(f"Resumed from {cfg.resume}: epoch {start_epoch}, "
              f"best acc {best_acc:.3f}")

    writer = _writer(cfg)
    history = []
    for epoch in range(start_epoch, cfg.epochs):
        print(f"Epoch: {epoch}: ")
        lr = optim.lr_for_epoch(cfg, epoch)
        t0 = time.time()
        with record_function("mla.train"):
            msum = None  # device-side accumulation: no per-step host sync
            n_batches = 0
            prof = None
            for bi, batch in enumerate(train_loader.epoch(epoch)):
                if max_steps_per_epoch and bi >= max_steps_per_epoch:
                    break
                if cfg.profile_dir and epoch == 0 and bi == 2:
                    prof = _start_profile(dev)
                with record_function("mla.step"):
                    state, metrics = train_step(state, batch, lr, bi, epoch)
                if prof is not None and bi == 6:
                    _stop_profile(prof, cfg.profile_dir)
                    prof = None
                ogm = {k: metrics.pop(k) for k in
                       ("ratio_v", "coeff_a", "coeff_v", "coeff_t")
                       if k in metrics}
                if writer is not None and ogm:
                    # per-iteration modulation scalars (main.py:339-344,
                    # 386-390); each float() is a host sync
                    it = epoch * len_dl + bi
                    writer.add_scalar("data/ratio v",
                                      float(ogm["ratio_v"]), it)
                    for m in ("v", "a", "t"):
                        if f"coeff_{m}" in ogm:
                            writer.add_scalar(f"data/coefficient {m}",
                                              float(ogm[f"coeff_{m}"]), it)
                msum = metrics if msum is None else \
                    {k: msum[k] + v for k, v in metrics.items()}
                n_batches += 1
                if (bi + 1) % cfg.log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    print(f"  step {bi + 1}/{len_dl} "
                          + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
            if prof is not None:
                # the epoch ended before step 6 (short dataset / step cap)
                _stop_profile(prof, cfg.profile_dir)
            # epoch means, as train_epoch returns _loss/len(dataloader)
            # (main.py:482-484)
            epoch_metrics = {k: float(v) / max(n_batches, 1)
                             for k, v in msum.items()}
        train_s = time.time() - t0
        with record_function("mla.evaluate"):
            accs = evaluate(cfg, state, test_loader, eval_step)
        dt = time.time() - t0
        acc = accs.get("acc", 0.0)
        history.append({"epoch": epoch, "acc": acc, **epoch_metrics,
                        "train_s": train_s, "wall_s": dt})
        if writer is not None:
            loss_scalars, eval_scalars = scalar_groups(cfg, epoch_metrics,
                                                       accs)
            writer.add_scalars("Loss", loss_scalars, epoch)
            writer.add_scalars("Evaluation", eval_scalars, epoch)

        if acc > best_acc:
            best_acc = acc
            name = ("best_model_of_dataset_{}_{}_alpha_{}_optimizer_{}_"
                    "modulate_starts_{}_ends_{}_epoch_{}_acc_{}").format(
                cfg.dataset, cfg.modulation, cfg.alpha, cfg.optimizer,
                cfg.modulation_starts, cfg.modulation_ends, epoch, acc)
            path = ckpt_lib.save_checkpoint_async(
                cfg.ckpt_path, state,
                {"saved_epoch": epoch, "modulation": cfg.modulation,
                 "alpha": cfg.alpha, "fusion": cfg.fusion_method, "acc": acc},
                name=name)
            print(f"The best model has been saved at {path}.")
            print("Loss: {:.3f}, Acc: {:.3f}".format(
                epoch_metrics.get("loss", 0.0), acc))
        else:
            print("Loss: {:.3f}, Acc: {:.3f}, Best Acc: {:.3f}".format(
                epoch_metrics.get("loss", 0.0), acc, best_acc))
        if cfg.modal3:
            # main.py:934-941 prints all three per-modality accuracies
            print("Audio Acc: {:.3f}, Visual Acc: {:.3f}, Text Acc: {:.3f} "
                  .format(accs.get("acc_a", 0.0), accs.get("acc_v", 0.0),
                          accs.get("acc_t", 0.0)))
        else:
            print("Audio Acc: {:.3f}, Visual Acc: {:.3f} ".format(
                accs.get("acc_a", 0.0), accs.get("acc_v", 0.0)))
        if cfg.save_last:
            # rolling restart point for --resume
            ckpt_lib.save_checkpoint_async(
                cfg.ckpt_path, state,
                {"saved_epoch": epoch, "best_acc": best_acc, "acc": acc,
                 "modulation": cfg.modulation, "alpha": cfg.alpha,
                 "fusion": cfg.fusion_method},
                name="last")
    if writer is not None:
        writer.close()
    if cfg.export_dir:
        # the final state's weights (for the best epoch's, run eval-only
        # with --export_dir on the saved best checkpoint)
        _export_serving(cfg, state, sample)
    if cfg.export_torch:
        _export_torch(cfg, state, epoch=cfg.epochs - 1, acc=best_acc)
    ckpt_lib.wait_for_async_saves()  # commit any in-flight checkpoint write
    return state, {"best_acc": best_acc, "history": history}


def _start_profile(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, out_dir: str) -> None:
    """End the trace of steps 2-6 of epoch 0 and write it to ``out_dir`` as
    a Chrome trace."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "train_steps.json"))
    print(f"Profile of training steps 2-6 written to {out_dir}")
