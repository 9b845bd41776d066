"""Static-graph training of the book's text models on the port: attention
seq2seq translation (then its beam-search decode) and the two sentiment
nets.

    python -m paddle_tpu_torch.tools.train_text
        --model seq2seq|stacked_lstm|conv [--steps 10] [--warmup 2]
        [--log-every 1] [--tiny] [--device cuda] [--decode]
        [--against-cpu]

The recipe is the JAX package's: ``fluid.layers.data`` -> the model's
builder -> an optimizer's ``minimize(loss)`` -> ``Executor.run`` of the
startup program, then of the main program on one batch made once and
repeated.  Every embedding is ``is_sparse=True`` (the models' default):
its gradient is a SelectedRows.

* ``seq2seq`` (``models/seq2seq.py``) at the widths of the Paddle book's
  chapter 8 (``08.machine_translation/train.py``): a dictionary of
  30,000 on both sides, ``word_dim`` 512, ``hidden_dim`` 512, batch 64,
  source and target 32 tokens, ``AdagradOptimizer(1e-4)`` with
  ``L2Decay(0.1)``.  The ids are drawn from numpy seed 0 (the repository
  holds no corpus): the target is the source, after a begin token.
  ``--decode`` then runs ``build_decode`` on the trained scope: beam 4,
  ``max_length`` 32, the batch's sources.
* ``stacked_lstm`` and ``conv`` (``models/sentiment.py``) at the widths of
  chapter 6 (``06.understand_sentiment``): the IMDB dictionary of 5,147
  words, ``EMB_DIM`` 128, ``HID_DIM`` 512, ``STACKED_NUM`` 3, batch 128,
  T 128 with each row's length drawn from 32-128 and fed,
  ``AdagradOptimizer(0.002)``.

``--tiny`` is the test sizes (seq2seq: dictionary 20, T 5, the model's
default widths 16 / 32, batch 16; sentiment: vocabulary 30, T 6,
widths 32, batch 8) and 3 steps.  The run is float32 with TF32 off on
the card.  On the card the fusion flag is ``auto``: seq2seq's two
fc -> bias -> tanh chains (the encoder's and the decoder's initial
state) run as ``fused_matmul_bias_act``, whose epilogue is kernel 9.  The
decode program holds ``beam_search_decode``, a host op, so it runs op by
op.

``--against-cpu`` runs the startup program on ``--device`` and then
``--steps`` steps from that state both there and on the CPU port, and
prints each side's losses as one JSON object: a second witness, at the
book's widths, of the card's loss trajectory.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import fluid
from ..framework import unique_name
from ..framework.place import resolve_device
from ..framework.scope import Scope, load_numpy_state, numpy_state
from ..models import seq2seq, sentiment
from .train_resnet import set_card_precision

__all__ = ["DEFAULTS", "TINY", "BOS", "EOS", "build_program",
           "build_decode_program", "make_batch", "decode_feed", "train",
           "decode", "against_cpu", "main"]

BOS, EOS = 0, 1
#: per model: the book chapter's widths, batch, sequence length and rate
DEFAULTS = {
    "seq2seq": {"dict_size": 30000, "word_dim": 512, "hidden_dim": 512,
                "batch": 64, "seq": 32, "lr": 1e-4, "l2": 0.1,
                "beam": 4, "max_length": 32},
    "stacked_lstm": {"dict_size": 5147, "emb_dim": 128, "hid_dim": 512,
                     "stacked_num": 3, "batch": 128, "seq": 128,
                     "min_len": 32, "lr": 0.002},
    "conv": {"dict_size": 5147, "emb_dim": 128, "hid_dim": 512,
             "batch": 128, "seq": 128, "min_len": 32, "lr": 0.002},
}
#: ``--tiny``: the same programs at the test sizes
TINY = {
    "seq2seq": {"dict_size": 20, "word_dim": 16, "hidden_dim": 32,
                "batch": 16, "seq": 5, "lr": 0.01, "l2": 0.1, "beam": 2,
                "max_length": 6},
    "stacked_lstm": {"dict_size": 30, "emb_dim": 32, "hid_dim": 32,
                     "stacked_num": 3, "batch": 8, "seq": 6, "min_len": 1,
                     "lr": 0.002},
    "conv": {"dict_size": 30, "emb_dim": 32, "hid_dim": 32, "batch": 8,
             "seq": 6, "min_len": 1, "lr": 0.002},
}


def build_program(model, cfg, seed=1):
    """(main, startup, fetches) of ``model``'s training program, from a
    fresh name generator; ``fetches[0]`` is the loss (sentiment: then the
    accuracy)."""
    with unique_name.guard():
        main_prog, startup = fluid.Program(), fluid.Program()
        main_prog.random_seed = seed
        startup.random_seed = seed
        with fluid.program_guard(main_prog, startup):
            T = cfg["seq"]
            if model == "seq2seq":
                src = fluid.layers.data("src", [T], dtype="int64")
                trg = fluid.layers.data("trg", [T], dtype="int64")
                label = fluid.layers.data("label", [T, 1], dtype="int64")
                loss, _ = seq2seq.build_train(
                    src, trg, label, cfg["dict_size"], cfg["word_dim"],
                    cfg["hidden_dim"])
                fetches = [loss]
                opt = fluid.optimizer.AdagradOptimizer(
                    cfg["lr"],
                    regularization=fluid.regularizer.L2Decay(cfg["l2"]))
            else:
                data = fluid.layers.data("words", [T], dtype="int64")
                label = fluid.layers.data("label", [1], dtype="int64")
                length = fluid.layers.data("length", [], dtype="int64")
                if model == "stacked_lstm":
                    loss, acc, _ = sentiment.stacked_lstm_net(
                        data, label, cfg["dict_size"],
                        emb_dim=cfg["emb_dim"], hid_dim=cfg["hid_dim"],
                        stacked_num=cfg["stacked_num"], length=length)
                else:
                    loss, acc, _ = sentiment.convolution_net(
                        data, label, cfg["dict_size"],
                        emb_dim=cfg["emb_dim"], hid_dim=cfg["hid_dim"],
                        length=length)
                fetches = [loss, acc]
                opt = fluid.optimizer.AdagradOptimizer(cfg["lr"])
            opt.minimize(loss)
    return main_prog, startup, fetches


def build_decode_program(cfg):
    """(main, startup, fetches) of seq2seq's beam-search decode over the
    trained parameters: (sentence ids, scores, lengths)."""
    with unique_name.guard():
        main_prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main_prog, startup):
            src = fluid.layers.data("src_d", [cfg["seq"]], dtype="int64")
            ids = fluid.layers.data("init_ids", [1], dtype="int64")
            scores = fluid.layers.data("init_scores", [1], dtype="float32")
            fetches = list(seq2seq.build_decode(
                src, ids, scores, cfg["dict_size"], cfg["word_dim"],
                cfg["hidden_dim"], beam_size=cfg["beam"],
                max_length=cfg["max_length"], eos_id=EOS))
    return main_prog, startup, fetches


def make_batch(model, cfg, seed=0):
    """One numpy feed.  seq2seq: source ids from 2 up (0 and 1 are the
    begin and end tokens), the target the source after a begin token,
    the label the source.  Sentiment: word ids, a 0/1 label and each
    row's length, from ``min_len`` to T."""
    rng = np.random.RandomState(seed)
    n, T, V = cfg["batch"], cfg["seq"], cfg["dict_size"]
    if model == "seq2seq":
        src = rng.randint(2, V, (n, T)).astype(np.int64)
        trg = np.concatenate([np.full((n, 1), BOS, np.int64), src[:, :-1]],
                             1)
        return {"src": src, "trg": trg, "label": src[..., None]}
    return {"words": rng.randint(0, V, (n, T)).astype(np.int64),
            "label": rng.randint(0, 2, (n, 1)).astype(np.int64),
            "length": rng.randint(cfg["min_len"], T + 1, n).astype(
                np.int64)}


def decode_feed(cfg, src):
    """The decode program's feed for the sources ``src`` ``[N, T]``: each
    tiled ``beam`` times, a begin token per hypothesis, score 0 for each
    source's first hypothesis and -1e9 for the rest."""
    beam = cfg["beam"]
    n = src.shape[0]
    first = np.zeros((beam, 1), np.float32)
    first[1:] = -1e9
    return {"src_d": np.repeat(src, beam, 0),
            "init_ids": np.full((n * beam, 1), BOS, np.int64),
            "init_scores": np.tile(first, (n, 1))}


def train(model="seq2seq", cfg=None, steps=10, device="cuda", warmup=0,
          log_every=1) -> dict:
    """Train ``warmup + steps`` steps on one repeated batch; time the last
    ``steps`` (host wall time around steps that each end in a host read
    of the loss).  Returns the per-step losses (sentiment: accuracies),
    ms/step, tokens/s (the padded batch's ``batch x T``), and
    what a profiler needs (executor, program and startup, feed, scope,
    fetches)."""
    cfg = dict(DEFAULTS[model] if cfg is None else cfg)
    dev = resolve_device(device)
    main_prog, startup, fetch = build_program(model, cfg)
    exe = fluid.Executor(dev)
    scope = Scope()
    exe.run(startup, scope=scope)
    feed = {k: torch.from_numpy(v).to(dev)
            for k, v in make_batch(model, cfg).items()}
    losses, accs = [], []
    t0 = time.perf_counter()
    for i in range(warmup + steps):
        if i == warmup:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        out = exe.run(main_prog, feed=feed, fetch_list=fetch, scope=scope)
        losses.append(float(out[0]))
        if len(out) > 1:
            accs.append(float(out[1]))
        if log_every and (i % log_every == 0 or i == warmup + steps - 1):
            print(f"step {i}: loss {losses[-1]:.4f}"
                  + (f" acc {accs[-1]:.3f}" if accs else ""), flush=True)
    wall = time.perf_counter() - t0
    return {"losses": losses, "acc": accs, "cfg": cfg,
            "ms_per_step": wall / steps * 1e3,
            "tokens_per_s": cfg["batch"] * cfg["seq"] * steps / wall,
            "executor": exe, "program": main_prog, "startup": startup,
            "feed": feed, "scope": scope, "fetch": fetch}


def decode(run: dict, repeats=1) -> dict:
    """seq2seq's beam decode of the trained batch's sources on the
    trained scope: (ids, scores, lengths) as numpy, and ms per decode
    (host wall time, the last of ``repeats`` runs)."""
    cfg = run["cfg"]
    prog, _, fetch = build_decode_program(cfg)
    feed = decode_feed(cfg, run["feed"]["src"].cpu().numpy())
    exe = run["executor"]
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = exe.run(prog, feed=feed, fetch_list=fetch, scope=run["scope"])
        ms = (time.perf_counter() - t0) * 1e3
    return {"ids": out[0], "scores": out[1], "lengths": out[2], "ms": ms,
            "program": prog}


def against_cpu(model="stacked_lstm", cfg=None, steps=4,
                device="cuda") -> dict:
    """``steps`` steps on ``device`` and on the CPU port from one startup
    state, ``device``'s (its startup run as :func:`train` runs it), on
    :func:`make_batch`'s batch: each side's per-step losses and their
    largest relative difference."""
    cfg = dict(DEFAULTS[model] if cfg is None else cfg)
    main_prog, startup, fetch = build_program(model, cfg)
    dev = resolve_device(device)
    start = Scope()
    fluid.Executor(dev).run(startup, scope=start)
    state = numpy_state(start, [n for n, _ in start.items()])
    feed = make_batch(model, cfg)
    losses = {}
    for side, where in (("on_device", dev), ("cpu", torch.device("cpu"))):
        scope = Scope()
        load_numpy_state(scope, state, where)
        exe = fluid.Executor(where)
        losses[side] = [float(exe.run(main_prog, feed=feed,
                                      fetch_list=fetch[:1],
                                      scope=scope)[0])
                        for _ in range(steps)]
    return {"model": model, "device": str(dev), "steps": steps, **losses,
            "max_rel_diff": max(abs(a - b) / abs(b) for a, b in
                                zip(losses["on_device"], losses["cpu"]))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(DEFAULTS), default="seq2seq")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--log-every", type=int, default=1, metavar="K",
                    help="print the loss of every K-th step and the last")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--decode", action="store_true",
                    help="seq2seq: beam-decode the batch's sources after")
    ap.add_argument("--against-cpu", action="store_true",
                    help="the --steps steps on --device and on the CPU "
                    "from --device's startup state; print both losses")
    args = ap.parse_args(argv)
    cfg = dict((TINY if args.tiny else DEFAULTS)[args.model])
    if args.tiny:
        args.steps, args.warmup = 3, 0
    if args.device != "cpu":
        set_card_precision()
    if args.against_cpu:
        print(json.dumps(against_cpu(args.model, cfg, args.steps,
                                     args.device)), flush=True)
        return
    run = train(args.model, cfg, args.steps, args.device, warmup=args.warmup,
                log_every=args.log_every)
    print(f"{args.model}: {args.steps} steps, "
          f"{run['tokens_per_s']:.1f} tokens/s, "
          f"{run['ms_per_step']:.2f} ms/step", flush=True)
    if args.decode and args.model == "seq2seq":
        d = decode(run)
        print(f"decode: beam {cfg['beam']}, {cfg['max_length']} steps, "
              f"{d['ms']:.2f} ms; first hypothesis "
              f"{d['ids'][0][:d['lengths'][0]].tolist()}", flush=True)


if __name__ == "__main__":
    main()
