"""Typed configuration with the same CLI surface as the reference.

The PyTorch port's own copy of ``mla_tpu/core/config.py``: the port imports
nothing from the JAX package, so it carries this file whole to keep every CLI
flag identical. The device is not a config flag: the entry points that touch
one take it themselves (``load_serving(device=)``, ``serve.py --device``).
Flags whose comments name JAX mechanisms
(scan, remat, meshes) are accepted here so command lines stay portable; the
port's modules say which ones they implement.

The reference threads a single argparse namespace through every layer
(reference: main.py:18-63). Here the same flag surface is parsed into a frozen
dataclass, with validation, plus flags the reference *uses* but never defines
(--mask_percent / --mask_m / --ewc_flag — reference dataset/dataset.py:98,118,156
and main.py:958 crash without them) and TPU-specific additions.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Dataset name -> number of classes (reference: main.py:491-509, basic_model.py).
N_CLASSES = {
    "CREMAD": 6,
    "MVSA": 3,
    "Food101": 101,
    "IEMOCAP": 4,
}

MODULATIONS = ("Normal", "OGM", "OGM_GE", "QMF")
FUSION_METHODS = ("sum", "concat", "gated", "film")
LORBS = ("large", "base", "m3ae")
OPTIMIZERS = ("sgd", "adam")


@dataclass(frozen=True)
class MLAConfig:
    """Full experiment configuration.

    Field names mirror the reference argparse flags (reference: main.py:18-63)
    so every README command line maps 1:1.
    """

    # --- data / task ---
    dataset: str = "CREMAD"
    fps: int = 1
    use_video_frames: int = 3
    batch_size: int = 64
    epochs: int = 100
    data_root: str = "data"          # root for datalists + preprocessed artifacts

    # --- training regime ---
    modulation: str = "Normal"       # Normal | OGM | OGM_GE | QMF
    fusion_method: str = "concat"    # sum | concat | gated | film
    gs_flag: bool = False            # MLA alternating unimodal adaptation
    dynamic: bool = False            # entropy-gated fusion at eval
    modal3: bool = False             # 3-modality (IEMOCAP)
    clip: bool = False               # precomputed CLIP features
    lorb: str = "base"               # large (CAV-MAE) | base (ResNet-18) | m3ae

    # --- optimization ---
    optimizer: str = "sgd"
    learning_rate: float = 1e-3
    lr_decay_step: int = 70
    lr_decay_ratio: float = 0.1
    modulation_starts: int = 0
    modulation_ends: int = 50
    alpha: float = 0.3               # OGM-GE alpha

    # --- fusion alphas ---
    av_alpha: float = 0.5            # 2-modal fixed fusion weight (driver uses 0.55: main.py:968)
    a_alpha: float = 0.35
    v_alpha: float = 0.25
    t_alpha: float = 0.4

    # --- CAV-MAE specific ---
    cav_opti: bool = False           # Adam w/ split lr groups (main.py:735-747)
    cav_lrs: bool = False            # MultiStepLR(2,1000,1)x0.5 (main.py:752-757)
    cav_augnois: bool = False        # SpecAug + noise/roll (dataset.py:281-294,319-321)

    # --- checkpointing / logging ---
    ckpt_path: str = "ckpt"
    ckpt_load_path_train: Optional[str] = None
    resume: Optional[str] = None     # checkpoint dir to resume training from:
                                     # restores the FULL TrainState (params,
                                     # optimizer, BN stats, GS/QMF stores, RNG)
                                     # + epoch/best-acc, then continues the
                                     # epoch loop. Beyond the reference, which
                                     # has no mid-run resume (main.py:916-953).
    save_last: bool = True           # write a rolling 'last' checkpoint each
                                     # epoch (async) so --resume always has a
                                     # recent restart point
    train: bool = False
    use_tensorboard: bool = True
    tensorboard_path: str = "ckpt/"
    random_seed: int = 0

    # --- flags used but never defined by the reference CLI ---
    mask_percent: float = 0.0        # QMF / missing-modality masking fraction
    mask_m: str = "none"             # which modality to mask ("audio"/"visual"/"none")
    ewc_flag: bool = False

    # --- TPU-native additions (no reference equivalent) ---
    gs_rls: bool = False             # run the *intended* RLS orthogonal projection.
                                     # The shipped reference guard `n == "module.weight"`
                                     # never matches (utils/utils.py:32), so the default
                                     # (False) reproduces shipped behavior: plain
                                     # alternating unimodal updates.
    ghost_updates: bool = True       # torch-1.8.1 parity: optimizer.zero_grad() zeroes
                                     # (not deletes) grads, so later MLA sub-steps apply
                                     # momentum+weight-decay-only updates to encoders
                                     # stepped earlier in the same batch (main.py:440,452).
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    num_workers: int = 8             # host-side loader threads
    mesh_shape: Optional[Tuple[int, ...]] = None   # default: 1-D (n_devices,) data mesh
    seq_parallel: bool = False       # Megatron-SP: token-shard the residual
                                     # stream over the model axis between
                                     # transformer blocks (parallel/sp.py);
                                     # needs mesh_shape (d, m) with m > 1
    m3ae_size: str = "base"          # M3AE encoder config small/base/large/
                                     # huge/debug (emb/depth/heads table,
                                     # models/m3ae.py M3AE_CONFIGS; reference
                                     # m3ae.py:226-268 defines the sizes but
                                     # only ever constructs base — here
                                     # large/huge are trainable via
                                     # --scan_blocks + --pp_microbatches)
    scan_blocks: bool = False        # lax.scan the M3AE block stack: ~depth-x
                                     # smaller HLO -> 9 s cold step compile vs
                                     # minutes unrolled, at +46% step time
                                     # (331 vs 227 ms measured) — a dev/CI
                                     # iteration knob, off in production;
                                     # checkpoints use the stacked 'blocks'
                                     # layout (pp.to_scan_layout converts)
    remat_blocks: bool = False       # jax.checkpoint each scanned M3AE
                                     # block: backward recomputes block
                                     # activations instead of storing all
                                     # depth residual sets — single-chip
                                     # memory lever for --m3ae_size
                                     # large/huge; needs --scan_blocks
    remat_policy: str = "full"       # what --remat_blocks saves across the
                                     # block boundary: 'full' recomputes the
                                     # whole block (max memory savings);
                                     # 'dots' saves the GEMM outputs
                                     # (jax dots_with_no_batch_dims_saveable)
                                     # so the backward recomputes only
                                     # LN/gelu/attention — most of the remat
                                     # FLOP tax back for ~10x the residual
                                     # footprint of 'full'
    scan_unroll: int = 1             # lax.scan unroll factor for
                                     # --scan_blocks. Measured on v5e:
                                     # STRICTLY WORSE than 1 (374 ms at 2 vs
                                     # 253; OOM at 4 — BASELINE.md); kept so
                                     # other hardware can re-evaluate
    compile_cache: str = ""          # persistent XLA compilation cache dir
                                     # (jax_compilation_cache_dir): makes the
                                     # unrolled large/huge stacks a ONE-TIME
                                     # compile cost (minutes cold, seconds
                                     # warm), so production runs can take the
                                     # unrolled layout's +53% step-time win
                                     # over --scan_blocks (BASELINE.md)
    pp_microbatches: int = 0         # GPipe pipeline parallelism over the
                                     # M3AE block stack (parallel/pp.py):
                                     # stages = the mesh 'model' axis, this
                                     # many microbatches per data slice.
                                     # Needs --scan_blocks (stacked layout)
                                     # and --mesh_shape d,m with m > 1; the
                                     # scaling path for the 'large'/'huge'
                                     # encoder configs (m3ae.py:226-268).
    pp_remat: bool = False           # rematerialize each block in the PP
                                     # backward (GPipe memory/FLOP trade)
    fsdp: bool = False               # ZeRO-3: shard params + optimizer
                                     # moments over the mesh 'data' axis
                                     # (parallel/fsdp.py); each chip stores
                                     # 1/d of the state, XLA all-gathers
                                     # weights per use and reduce-scatters
                                     # grads. Composes with a TP model axis;
                                     # incompatible with --pp_microbatches
    grad_accum: int = 1              # gradient accumulation: split each batch
                                     # into this many sequential microbatches
                                     # inside the jitted step (lax.scan),
                                     # accumulate grads, ONE optimizer update.
                                     # Activation memory drops ~k-fold — the
                                     # single-chip batch lever for the large/
                                     # huge M3AE configs. Exactly equivalent
                                     # to the full-batch step for LN-only
                                     # families (m3ae/large/modal3/clip,
                                     # tested); BN families get torch-style
                                     # sequential microbatch statistics.
                                     # Incompatible with QMF's pairwise
                                     # batch-wide rank loss.
    opt_dtype: str = "float32"       # optimizer moment-buffer precision (SGD
                                     # momentum; Adam m/v): 'bfloat16' halves
                                     # the moment HBM (huge SGD: 5.4 -> 2.7
                                     # GB). Moments round to bf16 at store
                                     # and the rounded value drives the param
                                     # update, so ckpt-resume stays exact.
    accum_dtype: str = "float32"     # --grad_accum carry precision:
                                     # 'bfloat16' halves the param-sized
                                     # gradient accumulator the scan carries
                                     # (huge: 5.4 -> 2.7 GB) at the cost of
                                     # rounding each partial sum. Together
                                     # with --opt_dtype bfloat16 this is the
                                     # state lever that fits huge+grad_accum
                                     # on one 16 GB chip.
    export_torch: str = ""           # write a reference-loadable torch .pth
                                     # (saved_dict layout of main.py:915-927,
                                     # DataParallel 'module.' prefix) from the
                                     # final train state / eval-only restore —
                                     # the inverse of the .pth import shim,
                                     # so TPU-trained weights go back to the
                                     # reference verbatim
    log_every: int = 50
    masked_bn: bool = False          # exact partial-batch BN statistics
                                     # (MaskedBatchNorm); ~10% step-time cost,
                                     # affects one batch per epoch — off by
                                     # default (README parity note 6)
    pretrained_a: Optional[str] = None  # per-encoder pretrained .pth paths;
    pretrained_v: Optional[str] = None  # replaces the reference's hardcoded
    pretrained_t: Optional[str] = None  # ckpts (basic_model.py:109-110,160-168)
    profile_dir: Optional[str] = None  # dump a jax.profiler trace of a few
                                       # training steps (SURVEY.md §5.1)
    image_size: Optional[int] = None  # override the per-dataset crop size
                                      # (224 base/large, 256 m3ae); used by
                                      # tests/CI for reduced-resolution runs
    pallas_conv: str = "auto"         # Pallas width-window 3x3 conv for the
                                      # ResNet body (ops/conv3x3.py): 'auto'
                                      # == 'off' (measured slower than XLA's
                                      # conv on-chip, BASELINE round-5) |
                                      # 'on' (single-chip experiment). Off-
                                      # TPU the op is a lax.conv either way.
    resnet_stages: Tuple[int, ...] = (2, 2, 2, 2)
                                      # blocks per ResNet stage for the `base`
                                      # backbones (reference parity: ResNet-18
                                      # = 2,2,2,2 — backbone.py:110). 1,1,1,1
                                      # gives a ResNet-10 (same 512-d feature)
                                      # for reduced-depth CI/deployments.
    audio_length: int = 1024          # CAV-MAE fbank time dim (large/modal3);
                                      # reference hardcodes 1024 (cav_mae.py:117,
                                      # basic_model.py:231). CI knob: patches_a
                                      # = audio_length*128/256, so must be a
                                      # multiple of 16 (8-row sin-cos grid).
    cav_blocks: Tuple[int, int] = (11, 12)
                                      # CAV-MAE (modality_specific_depth, depth)
                                      # — reference: 11 specific + 1 joint
                                      # (cav_mae.py:117-139). CI knob for
                                      # reduced-depth runs, like resnet_stages.

    export_dir: Optional[str] = None  # serialize the eval forward + weights
                                      # to a jax.export serving artifact
                                      # (runtime/export.py) after params are
                                      # built/restored; beyond-reference —
                                      # the reference can only re-run its
                                      # Python model code (main.py:946-953)
    export_batch_sizes: Tuple[int, ...] = ()
                                      # batch-size ladder for the artifact;
                                      # default (1, 8, batch_size)
    export_dtype: str = "float32"     # artifact weight precision: 'bfloat16'
                                      # halves params.msgpack + device-resident
                                      # weight HBM (huge: 5.4 -> 2.7 GB); the
                                      # compute path is bf16 either way, so
                                      # only the one-time weight rounding
                                      # differs. BN batch_stats stay fp32.
                                      # 'int8': weight-only per-channel
                                      # quantization of the big kernels/
                                      # embeddings (4x vs fp32), dequantized
                                      # inside the exported graph; rest bf16.

    # --- multi-host distributed data parallelism (SURVEY §5.8) ---
    # One process per TPU host. dist_coordinator ("host0:port") enables
    # jax.distributed.initialize(); the mesh then spans all hosts' chips and
    # each host loads only its rows of every global batch.
    dist_coordinator: Optional[str] = None
    dist_num_processes: int = 1
    dist_process_id: int = 0

    # ------------------------------------------------------------------
    @property
    def n_classes(self) -> int:
        if self.dataset not in N_CLASSES:
            raise NotImplementedError(f"Incorrect dataset name {self.dataset}")
        return N_CLASSES[self.dataset]

    @property
    def n_modalities(self) -> int:
        return 3 if self.modal3 else 2

    @property
    def feature_dim(self) -> int:
        """Per-modality feature width entering the fusion head.

        Reference: basic_model.py:31-34 (base/clip: 512), 94-97 (large: 768),
        148-155 (m3ae: 768), 216-223 (modal3: 768).
        """
        if self.lorb == "base" or self.clip:
            return 512
        return 768

    @property
    def head_input_dim(self) -> int:
        """Input width of the shared fusion head.

        In MLA (gs_flag) mode the shared head takes a single modality's features
        (half/third width); in joint mode it takes the concat.
        """
        if self.fusion_method == "sum":
            return self.feature_dim
        if self.gs_flag:
            return self.feature_dim
        return self.feature_dim * self.n_modalities

    def validate(self) -> "MLAConfig":
        if self.modulation not in MODULATIONS:
            raise ValueError(f"modulation must be one of {MODULATIONS}, got {self.modulation}")
        if self.fusion_method not in FUSION_METHODS:
            raise ValueError(f"fusion_method must be one of {FUSION_METHODS}")
        if self.lorb not in LORBS:
            raise ValueError(f"lorb must be one of {LORBS}")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer must be one of {OPTIMIZERS}")
        if self.clip and self.modulation == "QMF" and not self.gs_flag:
            # the reference crashes here (3-tuple unpack, main.py:594 —
            # CLIPClassifier has no QMF heads); reject instead of silently
            # training 512-d features as logits
            raise ValueError("--clip has no QMF heads (the reference "
                             "crashes on this combination); use Normal/OGM "
                             "modulation or --gs_flag with clip")
        if self.gs_flag and self.fusion_method == "sum":
            # MLA's shared head needs the fc_out-style projection the
            # concat families build; SumFusion (fc_x/fc_y) has no fc_out and
            # would crash deep in train-state setup (state.py GS Pl sizing)
            raise ValueError("--gs_flag requires a concat fusion head "
                             "(fusion_method=concat); sum has no shared "
                             "fc_out for the alternating updates")
        if self.fusion_method in ("gated", "film"):
            # Defined but never constructed in the reference
            # (basic_model.py:35-38) — under gs_flag too (_make_fusion would
            # raise during model setup; fail at config instead)
            raise NotImplementedError(
                f"fusion_method={self.fusion_method} is declared but not wired in the "
                "reference classifier composition; use sum or concat")
        _ = self.n_classes
        if self.modal3 and self.dataset != "IEMOCAP":
            raise ValueError("--modal3 is only supported with IEMOCAP")
        if self.modal3 and self.lorb != "m3ae":
            # build_classifier honors modal3 only on the m3ae branch
            # (classifiers.py); base/large would pair a 2-modal model with
            # the 3-modal adapter and KeyError deep in state init
            raise ValueError("--modal3 requires --lorb m3ae "
                             "(basic_model.py:202-275 Modal3 composition)")
        if self.m3ae_size not in ("small", "base", "base1", "large", "huge",
                                  "debug"):
            raise ValueError("--m3ae_size must be one of small/base/base1/"
                             f"large/huge/debug, got {self.m3ae_size}")
        if self.scan_unroll < 1:
            raise ValueError("--scan_unroll must be >= 1")
        if self.scan_unroll > 1 and not self.scan_blocks:
            raise ValueError("--scan_unroll needs --scan_blocks")
        if self.remat_blocks and not self.scan_blocks:
            raise ValueError("--remat_blocks needs --scan_blocks")
        if self.pallas_conv not in ("auto", "on", "off"):
            raise ValueError(f"--pallas_conv must be auto, on or off, got "
                             f"{self.pallas_conv!r}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"--remat_policy must be full or dots, got "
                             f"{self.remat_policy!r}")
        if self.remat_policy != "full" and not self.remat_blocks:
            raise ValueError("--remat_policy applies under --remat_blocks")
        if self.remat_blocks and self.pp_microbatches:
            raise ValueError(
                "--remat_blocks does not apply under --pp_microbatches (the "
                "pipeline path bypasses the scanned stack); use --pp_remat")
        if self.export_batch_sizes and not self.export_dir:
            raise ValueError("--export_batch_sizes needs --export_dir")
        if any(b < 1 for b in self.export_batch_sizes):
            raise ValueError("--export_batch_sizes must be positive, got "
                             f"{self.export_batch_sizes}")
        if self.export_dtype not in ("float32", "bfloat16", "int8",
                                     "int8_a8"):
            raise ValueError("--export_dtype must be float32, bfloat16, "
                             f"int8 or int8_a8, got {self.export_dtype!r}")
        if self.export_dtype != "float32" and not self.export_dir:
            raise ValueError("--export_dtype needs --export_dir")
        if self.pp_microbatches and not self.scan_blocks:
            raise ValueError("--pp_microbatches requires --scan_blocks "
                             "(the stacked block layout pp stages consume)")
        if self.pp_microbatches < 0:
            raise ValueError("--pp_microbatches must be >= 0")
        if self.audio_length < 16 or self.audio_length % 16:
            # patches_a = audio_length*128/256 laid out on an 8-row sin-cos
            # grid (cav_mae.py:129,161) -> audio_length must be 16-aligned
            raise ValueError("--audio_length must be a positive multiple of "
                             f"16, got {self.audio_length}")
        if (len(self.cav_blocks) != 2 or self.cav_blocks[0] < 0
                or self.cav_blocks[1] < self.cav_blocks[0]):
            raise ValueError("--cav_blocks must be msd,depth with "
                             f"0 <= msd <= depth, got {self.cav_blocks}")
        if self.pp_microbatches and self.seq_parallel:
            # sp.constrain's with_sharding_constraint cannot apply inside
            # pp's fully-manual shard_map — it raises at trace time
            raise ValueError("--seq_parallel is incompatible with "
                             "--pp_microbatches (the pipeline schedule is a "
                             "manual shard_map; use one or the other on the "
                             "model axis)")
        if self.fsdp and self.pp_microbatches:
            # pp.shard_state_train owns the stacked-block layout (stage
            # sharding over 'model'); FSDP re-sharding the same leaves over
            # 'data' would fight the manual pipeline shard_map
            raise ValueError("--fsdp is incompatible with --pp_microbatches "
                             "(the pipeline stage-shards the block stacks "
                             "itself; use FSDP or PP for the big configs, "
                             "not both)")
        if self.grad_accum < 1:
            raise ValueError("--grad_accum must be >= 1, got "
                             f"{self.grad_accum}")
        if self.grad_accum > 1:
            if self.batch_size % self.grad_accum:
                raise ValueError("--grad_accum must divide --batch_size "
                                 f"({self.batch_size} % {self.grad_accum} "
                                 "!= 0)")
            if self.regime == "qmf":
                # the QMF margin-rank loss compares confidence PAIRS across
                # the whole batch (main.py:108-125) — its gradient does not
                # decompose over microbatches, so accumulation would silently
                # change the objective
                raise ValueError("--grad_accum is incompatible with the QMF "
                                 "regime (batch-wide pairwise rank loss); "
                                 "use it with Normal/OGM/MLA")
        for knob in ("opt_dtype", "accum_dtype"):
            v = getattr(self, knob)
            if v not in ("float32", "bfloat16"):
                raise ValueError(f"--{knob} must be float32 or bfloat16, "
                                 f"got {v!r}")
        if self.accum_dtype != "float32" and self.grad_accum <= 1:
            raise ValueError("--accum_dtype bfloat16 only applies with "
                             "--grad_accum > 1 (it is the accumulator "
                             "carry's precision)")
        return self

    @property
    def regime(self) -> str:
        """Which train step this config routes to: 'mla' | 'qmf' | 'joint'.

        THE routing source of truth — steps.make_train_step dispatches on it
        and validate() derives flag-compat rules from it, so they cannot
        desync. Mirrors the reference train_epoch's branch order
        (main.py:164-170,419): gs_flag takes the MLA path regardless of
        modulation; `--lorb large` precedes the QMF check, so CAV runs the
        joint path no matter the modulation flag (CAVClassifier has no QMF
        heads)."""
        if self.gs_flag:
            return "mla"
        if self.modulation == "QMF" and self.lorb != "large":
            return "qmf"
        return "joint"

    def replace(self, **kw) -> "MLAConfig":
        return dataclasses.replace(self, **kw).validate()


def build_parser() -> argparse.ArgumentParser:
    """Argparse surface mirroring reference main.py:18-63 (plus missing flags)."""
    p = argparse.ArgumentParser(description="MLA-TPU trainer")
    d = MLAConfig()
    p.add_argument("--dataset", default=d.dataset, type=str)
    p.add_argument("--modulation", default=d.modulation, type=str, choices=list(MODULATIONS))
    p.add_argument("--fusion_method", default=d.fusion_method, type=str, choices=list(FUSION_METHODS))
    p.add_argument("--fps", default=d.fps, type=int)
    p.add_argument("--use_video_frames", default=d.use_video_frames, type=int)
    p.add_argument("--batch_size", default=d.batch_size, type=int)
    p.add_argument("--epochs", default=d.epochs, type=int)
    p.add_argument("--optimizer", default=d.optimizer, type=str, choices=list(OPTIMIZERS))
    p.add_argument("--learning_rate", default=d.learning_rate, type=float)
    p.add_argument("--lr_decay_step", default=d.lr_decay_step, type=int)
    p.add_argument("--lr_decay_ratio", default=d.lr_decay_ratio, type=float)
    p.add_argument("--modulation_starts", default=d.modulation_starts, type=int)
    p.add_argument("--modulation_ends", default=d.modulation_ends, type=int)
    p.add_argument("--alpha", default=d.alpha, type=float)
    p.add_argument("--ckpt_path", default=d.ckpt_path, type=str)
    p.add_argument("--train", action="store_true")
    p.add_argument("--use_tensorboard", default=d.use_tensorboard,
                   action=argparse.BooleanOptionalAction,
                   help="reference main.py:43 used type=bool (any non-empty "
                        "string == True, so it could never be disabled); "
                        "here --no-use_tensorboard works")
    p.add_argument("--tensorboard_path", default=d.tensorboard_path, type=str)
    p.add_argument("--random_seed", default=d.random_seed, type=int)
    p.add_argument("--gpu_ids", default="", type=str,
                   help="ignored; devices come from the JAX mesh")
    p.add_argument("--lorb", default=d.lorb, type=str, choices=list(LORBS))
    p.add_argument("--gs_flag", action="store_true")
    p.add_argument("--av_alpha", default=None, type=float,
                   help="2-modal fusion weight; when omitted the CLI uses "
                        "0.55 (__main__ calls main(av_alpha=0.55), "
                        "main.py:968) over the dataclass default 0.5")
    p.add_argument("--cav_opti", action="store_true")
    p.add_argument("--cav_lrs", action="store_true")
    p.add_argument("--cav_augnois", action="store_true")
    p.add_argument("--modal3", action="store_true")
    # README.md:66,76,81 writes `-dynamic` (single dash); accept both
    p.add_argument("--dynamic", "-dynamic", action="store_true")
    p.add_argument("--a_alpha", default=d.a_alpha, type=float)
    p.add_argument("--v_alpha", default=d.v_alpha, type=float)
    p.add_argument("--t_alpha", default=d.t_alpha, type=float)
    p.add_argument("--clip", action="store_true")
    p.add_argument("--ckpt_load_path_train", default=None, type=str)
    p.add_argument("--resume", default=None, type=str,
                   help="checkpoint dir (e.g. <ckpt_path>/last) to resume "
                        "training from: full TrainState + epoch + best-acc")
    p.add_argument("--no_save_last", action="store_true",
                   help="skip the rolling per-epoch 'last' checkpoint")
    # Flags the reference uses but forgot to define:
    p.add_argument("--mask_percent", default=d.mask_percent, type=float)
    p.add_argument("--mask_m", default=d.mask_m, type=str)
    p.add_argument("--ewc_flag", action="store_true")
    # TPU-native additions:
    p.add_argument("--data_root", default=d.data_root, type=str)
    p.add_argument("--gs_rls", action="store_true",
                   help="enable the intended RLS orthogonal gradient projection "
                        "(the shipped reference's projection is dead code)")
    p.add_argument("--no_ghost_updates", action="store_true",
                   help="disable torch-1.8.1 ghost momentum/wd updates in MLA sub-steps")
    p.add_argument("--param_dtype", default=d.param_dtype, type=str)
    p.add_argument("--compute_dtype", default=d.compute_dtype, type=str)
    p.add_argument("--num_workers", default=d.num_workers, type=int)
    p.add_argument("--log_every", default=d.log_every, type=int)
    p.add_argument("--image_size", default=None, type=int)
    p.add_argument("--profile_dir", default=None, type=str)
    p.add_argument("--masked_bn", action="store_true")
    p.add_argument("--pretrained_a", default=None, type=str)
    p.add_argument("--pretrained_v", default=None, type=str)
    p.add_argument("--pretrained_t", default=None, type=str)
    p.add_argument("--mesh_shape", default=None, type=str,
                   help="comma-separated (data, model) mesh, e.g. '8,1'")
    p.add_argument("--seq_parallel", action="store_true",
                   help="sequence parallelism over the model axis "
                        "(requires --mesh_shape d,m with m>1)")
    p.add_argument("--m3ae_size", default=d.m3ae_size, type=str,
                   choices=["small", "base", "base1", "large", "huge",
                            "debug"],
                   help="M3AE encoder size config (m3ae.py:226-268; base1 = "
                        "base width at depth 1, a CI knob); large/huge pair "
                        "with --scan_blocks/--pp_microbatches")
    p.add_argument("--scan_blocks", action="store_true",
                   help="lax.scan the M3AE transformer blocks: ~20x faster "
                        "cold compiles at ~1.5x step time (dev/CI knob; "
                        "stacked param layout)")
    p.add_argument("--remat_blocks", action="store_true",
                   help="jax.checkpoint each scanned M3AE block (memory "
                        "for recompute; needs --scan_blocks)")
    p.add_argument("--pallas_conv", default=d.pallas_conv, type=str,
                   choices=["auto", "on", "off"],
                   help="Pallas 3x3 conv for the ResNet body (auto = on for "
                        "single-chip TPU; off-TPU always lax.conv)")
    p.add_argument("--remat_policy", default=d.remat_policy, type=str,
                   choices=["full", "dots"],
                   help="remat granularity: full = recompute whole blocks; "
                        "dots = save GEMM outputs, recompute only "
                        "LN/gelu/attention in the backward")
    p.add_argument("--compile_cache", default=d.compile_cache, type=str,
                   metavar="DIR",
                   help="persistent XLA compilation cache: unrolled "
                        "large/huge stacks compile once, then load in "
                        "seconds on every later run")
    p.add_argument("--scan_unroll", default=d.scan_unroll, type=int,
                   help="unroll factor for --scan_blocks (compile/runtime "
                        "trade; 1 = pure scan)")
    p.add_argument("--pp_microbatches", default=d.pp_microbatches, type=int,
                   help="GPipe pipeline parallelism over the M3AE blocks: "
                        "microbatches per data slice; stages = the mesh "
                        "model axis (needs --scan_blocks + --mesh_shape d,m)")
    p.add_argument("--pp_remat", action="store_true",
                   help="rematerialize each block in the PP backward")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3: shard params + optimizer state over the "
                        "mesh data axis (1/d state per chip; XLA gathers "
                        "weights per use, reduce-scatters grads)")
    p.add_argument("--grad_accum", default=d.grad_accum, type=int,
                   help="accumulate gradients over this many sequential "
                        "microbatches per step (one optimizer update; "
                        "~k-fold activation-memory saving for large/huge)")
    p.add_argument("--opt_dtype", default=d.opt_dtype, type=str,
                   choices=("float32", "bfloat16"),
                   help="optimizer moment-buffer dtype; bfloat16 halves "
                        "moment HBM (state lever for --m3ae_size huge)")
    p.add_argument("--accum_dtype", default=d.accum_dtype, type=str,
                   choices=("float32", "bfloat16"),
                   help="--grad_accum carry dtype; bfloat16 halves the "
                        "param-sized gradient accumulator")
    p.add_argument("--resnet_stages", default=None, type=str,
                   help="comma-separated blocks per ResNet stage "
                        "(default 2,2,2,2 = ResNet-18)")
    p.add_argument("--audio_length", default=d.audio_length, type=int,
                   help="CAV-MAE fbank time dim for large/modal3 "
                        "(default 1024 = reference; CI knob)")
    p.add_argument("--cav_blocks", default=None, type=str,
                   help="CAV-MAE msd,depth blocks (default 11,12 = "
                        "reference; CI knob like --resnet_stages)")
    p.add_argument("--dist_coordinator", default=None, type=str,
                   help="coordinator host:port; enables multi-host DP via "
                        "jax.distributed.initialize()")
    p.add_argument("--dist_num_processes", default=d.dist_num_processes,
                   type=int)
    p.add_argument("--dist_process_id", default=d.dist_process_id, type=int)
    p.add_argument("--export_dir", default=None, type=str,
                   help="write a jax.export serving artifact (StableHLO + "
                        "weights) here after params are built/restored")
    p.add_argument("--export_batch_sizes", default=None, type=str,
                   help="comma-separated batch-size ladder for --export_dir "
                        "(default 1,8,<batch_size>)")
    p.add_argument("--export_torch", default=d.export_torch, type=str,
                   help="write a reference-loadable torch .pth (main.py "
                        "saved_dict layout) from the final/restored state")
    p.add_argument("--export_dtype", default=d.export_dtype, type=str,
                   choices=("float32", "bfloat16", "int8", "int8_a8"),
                   help="--export_dir artifact weight precision; bfloat16 "
                        "halves weight bytes (storage + device HBM), int8 "
                        "quarters the big kernels (weight-only, fused "
                        "Pallas dequant), int8_a8 also quantizes "
                        "activations per-row (W8A8 s8xs8 MXU)")
    return p


def config_from_args(argv=None) -> MLAConfig:
    ns = build_parser().parse_args(argv)
    kw = {f.name: getattr(ns, f.name) for f in dataclasses.fields(MLAConfig)
          if hasattr(ns, f.name)}
    kw["ghost_updates"] = not ns.no_ghost_updates
    kw["save_last"] = not ns.no_save_last
    if ns.mesh_shape:
        kw["mesh_shape"] = tuple(int(x) for x in ns.mesh_shape.split(","))
    if ns.resnet_stages:
        kw["resnet_stages"] = tuple(
            int(x) for x in ns.resnet_stages.split(","))
    else:
        kw.pop("resnet_stages", None)
    if ns.cav_blocks:
        kw["cav_blocks"] = tuple(int(x) for x in ns.cav_blocks.split(","))
    else:
        kw.pop("cav_blocks", None)
    if ns.av_alpha is None:
        # the reference's __main__ overrides the function default 0.5 with
        # 0.55 (main.py:968); detecting 'flag omitted' via a None sentinel
        # also covers the --av_alpha=X form a raw argv scan missed
        kw["av_alpha"] = 0.55
    if ns.export_batch_sizes:
        kw["export_batch_sizes"] = tuple(
            int(x) for x in ns.export_batch_sizes.split(","))
    else:
        kw.pop("export_batch_sizes", None)
    return MLAConfig(**kw).validate()
