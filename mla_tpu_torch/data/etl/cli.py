"""Offline ETL CLI — the reference's data/ scripts as one tool (port of
``mla_tpu/data/etl/cli.py``).

    python -m mla_tpu_torch.data.etl.cli <subcommand> ... [--device cuda|cpu]

Subcommands, names, positionals, flags and defaults as the JAX package's;
the audio transforms are the port's own ops (``ops/stft.py``,
``ops/fbank.py``) and run on ``--device``, the port's one flag of its own,
which only the three subcommands that run them take (DEVICE_COMMANDS): the
card (the default) or the CPU; asking for the card on a machine without
one raises. File I/O, cv2, PIL, the tokenizer and the lists stay on the
host. One file at a time, as in the JAX package.

  mp4-to-wav        ffmpeg mp4 -> 16 kHz pcm_s16le wav (mp4_to_wav.py:17)
  extract-spec      wav -> tile>=10 s, random 5 s crop, clip, log-STFT
                    n_fft 256 hop 128 .npy (extract_spec.py:13-22)
  extract-fbank     wav -> Kaldi fbank 128-mel padded to 1024 frames .npy
                    (extract_fbank.py:35-52), optional waveform mixup
  video-frames      mp4 -> jpg per frame at --fps (video_preprocessing.py)
  extract-token     BERT-base-uncased tokens, max_len 256, no special tokens;
                    saves *_token.npy + *_pm.npy = 1-attention_mask
                    (extract_token.py:38-50)
  preprocess-iemo   one-shot IEMOCAP: fbank + tokens + 256x256 face crops
                    per split (preprocess_iemo.py:14-181)
  gen-stat          class list from datalists (gen_stat.py)
  gen-txt           random split datalists (gen_*_txt.py)

Two places differ from the JAX CLI on purpose:
- ``--mix_lambda`` is passed through as given, 0.0 included (the JAX CLI
  turns 0.0 into -1.0); -1.0 stands only where ``--mix_dir`` is absent.
- the 0.01-filled fallback of ``extract-fbank`` and ``preprocess-iemo``
  (extract_fbank.py:38-40) covers a wav that cannot be read; an error of
  the fbank itself (a device or build failure) ends the subcommand instead
  of writing a valid-looking cache.
"""

from __future__ import annotations

import argparse
import os
import random
import subprocess
from os.path import join

import numpy as np
import torch

from mla_tpu_torch.device import resolve_device, set_matmul_precision


def _wavread(path):
    from scipy.io import wavfile
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return sr, data


def _on(dev, a):
    return None if a is None else torch.from_numpy(a).to(dev)


def _fbank(wave, dev, target_length, wave2=None, mix_lambda=-1.0):
    """numpy waveform(s) -> the (target_length, 128) fbank, computed on
    ``dev``, as a float32 numpy array."""
    from mla_tpu_torch.ops.fbank import wav2fbank
    fb = wav2fbank(_on(dev, wave), target_length=target_length,
                   waveform2=_on(dev, wave2), mix_lambda=mix_lambda)
    return fb.cpu().numpy()


def _fallback(name, err, target_length):
    """extract_fbank.py:38-40: an unreadable wav becomes a 0.01-filled
    array at --target_length (a fixed 512 would give the cache one
    artifact of another shape than the loader probes)."""
    print(f"there is a loading error ({name}: {err})")
    return np.zeros((target_length, 128), np.float32) + 0.01


def cmd_mp4_to_wav(args):
    os.makedirs(args.out_dir, exist_ok=True)
    for f in sorted(os.listdir(args.in_dir)):
        if not f.endswith((".mp4", ".flv")):
            continue
        out = join(args.out_dir, os.path.splitext(f)[0] + ".wav")
        subprocess.run(["ffmpeg", "-y", "-i", join(args.in_dir, f),
                        "-acodec", "pcm_s16le", "-ar", "16000", "-ac", "1",
                        out], check=True, capture_output=True)


def cmd_extract_spec(args):
    from mla_tpu_torch.ops.stft import log_stft
    os.makedirs(args.out_dir, exist_ok=True)
    rng = random.Random(args.seed)
    for f in sorted(os.listdir(args.in_dir)):
        if not f.endswith(".wav"):
            continue
        rate, sample = _wavread(join(args.in_dir, f))
        if len(sample) == 0:
            # e.g. ffmpeg output for a video with no audio stream; tiling an
            # empty array never reaches 10 s
            print(f"skip {f}: empty waveform")
            continue
        while len(sample) / rate < 10.0:
            sample = np.tile(sample, 2)
        start = rng.randint(0, rate * 5)
        new = np.clip(sample[start:start + rate * 5], -1.0, 1.0)
        spec = log_stft(_on(args.device, new), n_fft=256, hop_length=128)
        np.save(join(args.out_dir, f.replace(".wav", ".npy")),
                spec.cpu().numpy())


def cmd_extract_fbank(args):
    os.makedirs(args.out_dir, exist_ok=True)
    if (args.mix_dir is None) != (args.mix_lambda is None):
        raise SystemExit("--mix_dir and --mix_lambda go together")
    lam = -1.0 if args.mix_lambda is None else args.mix_lambda
    for f in sorted(os.listdir(args.in_dir)):
        if not f.endswith(".wav"):
            continue
        try:
            _, wave = _wavread(join(args.in_dir, f))
            wave2 = None
            if args.mix_dir is not None:
                # waveform mixup (extract_fbank.py:14-32): blend with the
                # same-named wav from --mix_dir before the fbank transform
                _, wave2 = _wavread(join(args.mix_dir, f))
        except Exception as e:   # noqa: BLE001 — the read's errors only
            fb = _fallback(f, e, args.target_length)
        else:
            fb = _fbank(wave, args.device, args.target_length, wave2, lam)
        np.save(join(args.out_dir, f.replace(".wav", ".npy")), fb)


def cmd_video_frames(args):
    import cv2
    os.makedirs(args.out_dir, exist_ok=True)
    for f in sorted(os.listdir(args.in_dir)):
        if not f.endswith((".mp4", ".flv", ".avi")):
            continue
        name = os.path.splitext(f)[0]
        vdir = join(args.out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        cap = cv2.VideoCapture(join(args.in_dir, f))
        fps = cap.get(cv2.CAP_PROP_FPS) or 30
        keep_every = max(1, int(round(fps / args.fps)))
        i = saved = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if i % keep_every == 0:
                cv2.imwrite(join(vdir, f"{saved:05d}.jpg"), frame)
                saved += 1
            i += 1
        cap.release()
        if saved == 0:
            print(f"Fail @ {f}")


def _make_encoder(vocab, tokenizer, max_length):
    """text -> (ids (1, L) int64, pm (1, L) float32) with extract_token.py's
    exact call contract (add_special_tokens=False, padding='max_length',
    pm = 1 - attention_mask). Shared by extract-token and preprocess-iemo."""
    if vocab:
        # self-contained C++ WordPiece (native/wordpiece.cc)
        from mla_tpu_torch.data.wordpiece import WordPieceTokenizer
        wp = WordPieceTokenizer(vocab)
        return lambda text: wp.encode(text, max_length)
    from transformers import BertTokenizer
    try:  # cached copy first: skips minutes of hub connect timeouts
        tok = BertTokenizer.from_pretrained(tokenizer,
                                            local_files_only=True)
    except Exception:
        try:
            tok = BertTokenizer.from_pretrained(tokenizer)
        except Exception as e:
            raise SystemExit(
                f"cannot load HF tokenizer '{tokenizer}': no cached "
                f"copy and the hub is unreachable ({type(e).__name__}). "
                "Pass --vocab vocab.txt to use the self-contained C++ "
                "WordPiece tokenizer instead.") from e

    def encode(text):
        enc = tok(text, max_length=max_length, truncation=True,
                  padding="max_length", add_special_tokens=False,
                  return_tensors="np")
        ids = enc["input_ids"].astype(np.int64)
        am = enc["attention_mask"]
        if ids.shape[1] == 0:
            # transformers does not pad a zero-token encoding to
            # max_length; write the padded row (the C++ path's)
            ids = np.zeros((1, max_length), np.int64)
            am = np.zeros((1, max_length), am.dtype)
        return ids, (1 - am).astype(np.float32)
    return encode


def cmd_extract_token(args):
    os.makedirs(args.out_dir, exist_ok=True)
    encode = _make_encoder(args.vocab, args.tokenizer, args.max_length)
    with open(args.text_file) as f:
        for line in f:
            name, _, text = line.rstrip("\n").partition("\t")
            ids, pm = encode(text)
            np.save(join(args.out_dir, name + "_token.npy"), ids)
            np.save(join(args.out_dir, name + "_pm.npy"), pm)


def cmd_preprocess_iemo(args):
    """One-shot IEMOCAP preprocessing (preprocess_iemo.py:14-181): per split,
    wav -> fbank npy, caption -> BERT token/pm npys, face crops -> 256x256
    bilinear jpgs, laid out where the IEMOCAP adapter reads them
    (datalists.py LAYOUTS: audio/{mode}_fbank, text_token/{mode}_token,
    visual/{mode}_imgs)."""
    from PIL import Image

    encode = _make_encoder(args.vocab, args.tokenizer, args.max_length)
    sep = " [split|sign] "
    for split in args.splits.split(","):
        lst = join(args.lists_dir, f"my_{split}_iemo.txt")
        if not os.path.exists(lst):
            print(f"skip split '{split}': no {lst}")
            continue
        fb_dir = join(args.out_root, "audio", f"{split}_fbank")
        tok_dir = join(args.out_root, "text_token", f"{split}_token")
        img_dir = join(args.out_root, "visual", f"{split}_imgs")
        for d in (fb_dir, tok_dir, img_dir):
            os.makedirs(d, exist_ok=True)
        with open(lst) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        for line in lines:
            try:
                path, caption, _label = line.split(sep)
            except ValueError:
                raise SystemExit(f"malformed datalist line in {lst!r}: "
                                 f"{line!r} (want 'path{sep}caption{sep}"
                                 "label')")
            name = path.replace(".mp4", "")
            # 1. audio: wav -> Kaldi fbank (extract_fbank.py law)
            try:
                _, wave = _wavread(join(args.audio_dir, name + ".wav"))
            except Exception as e:   # noqa: BLE001 — the read's errors only
                fb = _fallback(name, e, args.target_length)
            else:
                fb = _fbank(wave, args.device, args.target_length)
            np.save(join(fb_dir, name + ".npy"), fb)
            # 2. text: caption -> token + pm npys (extract_token.py law)
            ids, pm = encode(caption)
            np.save(join(tok_dir, name + "_token.npy"), ids)
            np.save(join(tok_dir, name + "_pm.npy"), pm)
            # 3. visual: face crops -> 256x256 bilinear jpgs
            #    (preprocess_iemo.py:136-181 process_img)
            src = join(args.faces_dir, name)
            if not os.path.isdir(src):
                print(f"Fail @ {name}: no face dir {src}")
                continue
            dst = join(img_dir, name)
            os.makedirs(dst, exist_ok=True)
            for frame in sorted(os.listdir(src)):
                if not frame.lower().endswith((".jpg", ".jpeg", ".png")):
                    continue
                img = Image.open(join(src, frame)).convert("RGB")
                img.resize((256, 256), Image.BILINEAR).save(
                    join(dst, os.path.splitext(frame)[0] + ".jpg"))


def cmd_gen_stat(args):
    per_list = []
    for lst in args.lists:
        labels = set()
        with open(lst) as f:
            for line in f:
                line = line.strip()
                if line:
                    labels.add(line.split(args.sep)[-1])
        per_list.append(labels)
    # gen_stat.py:20-25: every split must carry the SAME label set — a
    # typo'd label in one list would otherwise silently change n_classes
    # and shift every sorted class index
    for i, labels in enumerate(per_list[1:], 1):
        if labels != per_list[0]:
            diff = labels ^ per_list[0]
            raise SystemExit(
                f"label sets differ between {args.lists[0]} and "
                f"{args.lists[i]}: {sorted(diff)}")
    with open(args.out, "w") as f:
        f.write("\n".join(sorted(per_list[0])) + "\n")


def cmd_gen_txt(args):
    rng = random.Random(args.seed)
    with open(args.all_list) as f:
        # normalize: a final line without a trailing newline would merge
        # with its successor after the shuffle
        lines = [ln.rstrip("\n") + "\n" for ln in f if ln.strip()]
    rng.shuffle(lines)
    n_test = int(len(lines) * args.test_frac)
    with open(args.out_prefix + "_test.txt", "w") as f:
        f.writelines(lines[:n_test])
    with open(args.out_prefix + "_train.txt", "w") as f:
        f.writelines(lines[n_test:])


# the subcommands whose transforms run on a device, and so take --device
DEVICE_COMMANDS = ("extract-spec", "extract-fbank", "preprocess-iemo")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mla-tpu-torch-etl", description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("mp4-to-wav")
    s.add_argument("in_dir"); s.add_argument("out_dir")
    s.set_defaults(fn=cmd_mp4_to_wav)

    s = sub.add_parser("extract-spec")
    s.add_argument("in_dir"); s.add_argument("out_dir")
    s.add_argument("--seed", type=int, default=0)
    _device_flag(s)
    s.set_defaults(fn=cmd_extract_spec)

    s = sub.add_parser("extract-fbank")
    s.add_argument("in_dir"); s.add_argument("out_dir")
    s.add_argument("--target_length", type=int, default=1024)
    s.add_argument("--mix_dir", default=None,
                   help="waveform-mixup partner dir (same-named wavs); "
                        "blended per extract_fbank.py:14-32")
    s.add_argument("--mix_lambda", type=float, default=None)
    _device_flag(s)
    s.set_defaults(fn=cmd_extract_fbank)

    s = sub.add_parser("video-frames")
    s.add_argument("in_dir"); s.add_argument("out_dir")
    s.add_argument("--fps", type=float, default=1.0)
    s.set_defaults(fn=cmd_video_frames)

    s = sub.add_parser("extract-token")
    s.add_argument("text_file", help="TSV: name<TAB>text per line")
    s.add_argument("out_dir")
    s.add_argument("--max_length", type=int, default=256)
    s.add_argument("--tokenizer", default="bert-base-uncased")
    s.add_argument("--vocab", default=None,
                   help="vocab.txt for the native C++ WordPiece tokenizer "
                        "(no transformers dependency)")
    s.set_defaults(fn=cmd_extract_token)

    s = sub.add_parser("preprocess-iemo")
    s.add_argument("lists_dir", help="dir holding my_{split}_iemo.txt "
                                     "datalists (' [split|sign] ' separated)")
    s.add_argument("audio_dir", help="source wavs (subaudio/)")
    s.add_argument("faces_dir", help="per-clip face-crop dirs (faces/)")
    s.add_argument("out_root", help="dataset root to write "
                                    "audio/text_token/visual under")
    s.add_argument("--splits", default="train,dev,test")
    s.add_argument("--target_length", type=int, default=1024)
    s.add_argument("--max_length", type=int, default=256)
    s.add_argument("--tokenizer", default="bert-base-uncased")
    s.add_argument("--vocab", default=None)
    _device_flag(s)
    s.set_defaults(fn=cmd_preprocess_iemo)

    s = sub.add_parser("gen-stat")
    s.add_argument("lists", nargs="+"); s.add_argument("--out", required=True)
    s.add_argument("--sep", default=" ")
    s.set_defaults(fn=cmd_gen_stat)

    s = sub.add_parser("gen-txt")
    s.add_argument("all_list"); s.add_argument("out_prefix")
    s.add_argument("--test_frac", type=float, default=0.1)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_gen_txt)
    return p


def _device_flag(s: argparse.ArgumentParser):
    s.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the audio transform runs (default: the card)")


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX CLI's arguments, plus ``device`` for DEVICE_COMMANDS
    (``--device cuda|cpu`` after the subcommand), resolved as
    ``runtime/cli.py`` resolves it: asking for the card on a machine
    without one raises."""
    args = build_parser().parse_args(argv)
    if args.cmd in DEVICE_COMMANDS:
        args.device = resolve_device(args.device)
    return args


def main(argv=None):
    args = parse_args(argv)
    set_matmul_precision()     # the fbank's fp32 product without TF32
    args.fn(args)


if __name__ == "__main__":
    main()
