"""Hold the compiled step (``FLAGS_cuda_step_session``) to the eager one
on the card.

    python -m paddle_tpu_torch.tools.check_step_capture [--steps 4]

Each check prints one JSON line; the run exits 1 when one fails.

* ``static``: for ResNet-18 (batch 4, 32x32, 10 classes) in f32, under
  ``decorate`` in bf16 and in fp16 (its default loss scale of 2^15 finds
  an Inf in the first steps at this size, and the check requires one),
  LeNet and word2vec (batch 16), and MobileNetV3-small under ``decorate``
  in bf16 (batch 4, 32x32, 10 classes) on the PaddleClas recipe, whose
  rate (a linear warm-up into a cosine per step) is computed in the
  program from the persistable step counter: the same steps from one
  startup state, once op by op and once through the step session (a
  warm-up, a capture, then replays), give the same fetches at every step
  (the MobileNet's rate among them, a new rate on every step) and the
  same scope state after (its counter among them), bit for bit;
* ``decode``: one small engine per KV dtype (f32, bf16, int8) serves the
  same requests op by op and captured: the same token streams, and the
  same pools and scales after, bit for bit; the graphs captured are at
  most the buckets used;
* ``bucket_switch``: the decode batch goes from bucket 8 to 4 and back
  to 8 (short requests end, new ones arrive and prefill eagerly between
  replays): the graphs share one memory pool, and switching back to an
  earlier graph still gives the eager run's tokens and pools;
* ``invalidation``: a ``scope.set`` between steps drops the graph (the
  next step warms up, the one after captures again) and the steps still
  equal eager steps with the same set; a new feed shape adds a graph,
  and the first shape again replays its own (A, B, A);
* ``launches``: :func:`launches_per_step`, a replayed step launches each
  hand-written kernel as often as an eager step does;
* ``dropout``: a program with ``dropout`` draws a new mask on every
  replay, and each replay's mask and loss equal those of the eager step
  at the same point of the generator's stream;
* ``raises``: a random op with a fixed seed in the step (a generator the
  graph cannot replay) raises ``StepCaptureError`` naming it.

cuDNN runs deterministically here (``torch.backends.cudnn.deterministic``)
so that two eager runs agree bit for bit; TF32 and cuBLAS's reduced
precision reductions are off, as on the training paths.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import fluid
from ..framework import unique_name
from ..framework.cuda_graph import StepCaptureError
from ..framework.scope import Scope, load_numpy_state, numpy_state
from ..utils.flags import get_flag, set_flags
from . import train_book as tb
from .train_resnet import (build_program, loss_scaling_state, make_batch,
                           set_card_precision)

__all__ = ["STATIC_CASES", "compare_program", "compare_static",
           "compare_decode", "check_bucket_switch", "check_invalidation",
           "check_dropout", "check_raises", "launches_per_step", "session",
           "main"]

#: name -> the program and batch of a static equality case
STATIC_CASES = {
    "resnet18-f32": dict(model="resnet", amp=False),
    "resnet18-bf16": dict(model="resnet", amp=True, amp_dtype="bfloat16"),
    "resnet18-fp16": dict(model="resnet", amp=True, amp_dtype="float16"),
    "lenet": dict(model="lenet"),
    "word2vec": dict(model="word2vec"),
    "mobilenet-bf16": dict(model="mobilenet", amp=True,
                           amp_dtype="bfloat16"),
}
#: the MobileNet case's size (``compare_static`` takes others) and its
#: recipe: a warm-up of 3 steps, then a cosine step by step
MOBILENET_CASE = dict(scale="small", image=32, classes=10, batch=4)
MOBILENET_RECIPE = dict(lr=0.05, warmup_steps=3, steps_per_epoch=1,
                        epochs=8)


@contextlib.contextmanager
def session(value: str):
    """``FLAGS_cuda_step_session`` at ``value`` inside the block."""
    prev = get_flag("FLAGS_cuda_step_session")
    set_flags({"FLAGS_cuda_step_session": value})
    try:
        yield
    finally:
        set_flags({"FLAGS_cuda_step_session": prev})


@contextlib.contextmanager
def deterministic():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def _build(case: dict, batch: Optional[int] = None, **size):
    """(main, startup, fetch names, feed) of a :data:`STATIC_CASES`
    entry; ``size`` overrides :data:`MOBILENET_CASE`."""
    if case["model"] == "mobilenet":
        from .train_mobilenet import build_program as build_mobilenet

        sz = dict(MOBILENET_CASE, **size)
        main, startup, loss, acc = build_mobilenet(
            sz["scale"], sz["image"], sz["classes"], amp=case["amp"],
            amp_dtype=case["amp_dtype"], **MOBILENET_RECIPE)
        rate = next(o.input("LearningRate")[0]
                    for o in main.global_block().ops if o.type == "momentum")
        img, label = make_batch(batch or sz["batch"], sz["image"],
                                sz["classes"])
        fetch = [loss.name, acc.name, rate]
        feed = {"img": img, "label": label}
    elif case["model"] == "resnet":
        main, startup, loss, acc = build_program(
            18, 32, 10, 0.1, amp=case["amp"],
            amp_dtype=case.get("amp_dtype", "bfloat16"))
        img, label = make_batch(batch or 4, 32, 10)
        fetch = [loss.name, acc.name]
        feed = {"img": img, "label": label}
    else:
        cfg = dict(tb.DEFAULTS[case["model"]], batch=batch or 16)
        main, startup, fetches = tb.build_program(case["model"], cfg)
        fetch = [f.name for f in fetches]
        feed = tb.make_batch(case["model"], cfg)
    scaling = loss_scaling_state(main)
    return main, startup, fetch + list(scaling or ()), feed


def _startup_state(startup) -> Dict[str, np.ndarray]:
    scope = Scope()
    with session("0"):
        fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope)
    return numpy_state(scope, [n for n, _ in scope.items()])


def _steps(main, state, feeds: List[dict], fetch, value: str, hook=None):
    """Run ``feeds`` (one step each) from ``state`` with the session at
    ``value``; ``hook(i, scope, exe)`` runs before step i.  Returns the
    fetches per step, the scope's state after, and the executor."""
    scope = Scope()
    load_numpy_state(scope, state, "cuda")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    outs = []
    with session(value):
        for i, feed in enumerate(feeds):
            if hook is not None:
                hook(i, scope, exe)
            outs.append(exe.run(main, feed=feed, fetch_list=fetch,
                                scope=scope))
    torch.cuda.synchronize()
    return outs, numpy_state(scope, [n for n, _ in scope.items()]), exe


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


def _diff(eager, captured):
    """(names of fetches per step, state names) that differ."""
    (e_out, e_state), (c_out, c_state) = eager, captured
    fetches = [(i, j) for i, (a, b) in enumerate(zip(e_out, c_out))
               for j, (x, y) in enumerate(zip(a, b)) if not _same(x, y)]
    state = sorted(n for n in e_state
                   if n not in c_state or not _same(e_state[n], c_state[n]))
    return fetches, state


def compare_program(name: str, main, startup, fetch, feed,
                    steps: int = 4):
    """``steps`` steps of ``main`` (fetching ``fetch``, the loss first) on
    one ``feed``, op by op and captured, from one state of ``startup``.
    Returns the row, whose ``ok`` says every fetch of every step and
    every scope tensor after are equal bit for bit and one graph was
    captured, and the two runs' fetches per step (eager, captured)."""
    state = _startup_state(startup)
    with deterministic():
        e_out, e_state, _ = _steps(main, state, [feed] * steps, fetch, "0")
        c_out, c_state, exe = _steps(main, state, [feed] * steps, fetch, "1")
    bad_fetch, bad_state = _diff((e_out, e_state), (c_out, c_state))
    return {"check": "static", "case": name, "steps": steps,
            "state_tensors": len(e_state), "graphs": exe.graphs_captured,
            "losses": [float(np.asarray(o[0]).reshape(-1)[0])
                       for o in c_out],
            "fetch_mismatches": bad_fetch,
            "state_mismatch_count": len(bad_state),
            "state_mismatches": {
                n: float(np.abs(np.asarray(e_state[n], np.float64)
                                - np.asarray(c_state[n], np.float64)).max())
                if n in c_state else None for n in bad_state[:8]},
            "ok": not bad_fetch and not bad_state and
            exe.graphs_captured == 1}, e_out, c_out


def compare_static(name: str, steps: int = 4, **size) -> dict:
    """One :data:`STATIC_CASES` entry, ``steps`` steps op by op and
    captured from one startup state (:func:`compare_program`); ``size``:
    the MobileNet case's (:data:`MOBILENET_CASE`)."""
    case = STATIC_CASES[name]
    main, startup, fetch, feed = _build(case, **size)
    row, e_out, c_out = compare_program(name, main, startup, fetch, feed,
                                        steps)
    if case["model"] == "mobilenet":
        row.update(size, rates=[float(np.asarray(o[2]).reshape(-1)[0])
                                for o in c_out])
        row["ok"] = row["ok"] and len(set(row["rates"])) == steps
    if loss_scaling_state(main):
        found = [bool(np.asarray(o[-1]).reshape(-1)[0]) for o in e_out]
        row["found_inf_steps"] = [i for i, f in enumerate(found) if f]
        row["ok"] = row["ok"] and any(found)
    return row


SMALL_DECODER = dict(vocab_size=256, hidden=64, num_heads=4, num_layers=2,
                     max_seq_len=256)


def _serve_both(kv_dtype: str, cfg: Optional[dict], schedule, kw: dict):
    """``schedule`` (``[(step, [(prompt, max_new), ...]), ...]``: the
    requests submitted before that engine step) served to the end by one
    engine op by op and one captured.  Per run: the token streams, the
    pools' and scales' bytes, graphs and buckets, decode steps and the
    decode batch of every step."""
    from ..inference.serving import (DecoderConfig, Request, ServingEngine,
                                     init_decoder_weights)

    dcfg = DecoderConfig(**(cfg or SMALL_DECODER))
    weights = init_decoder_weights(dcfg, 0)
    runs = {}
    for value in ("0", "1"):
        eng = ServingEngine(dcfg, weights, device="cuda", kv_dtype=kv_dtype,
                            **kw)
        reqs, batches, pending, i = [], [], list(schedule), 0
        with session(value):
            while pending or eng.has_work():
                while pending and pending[0][0] <= i:
                    for prompt, max_new in pending.pop(0)[1]:
                        reqs.append(Request(len(reqs), prompt, max_new))
                        eng.submit(reqs[-1])
                eng.step()
                batches.append(len(eng.running))
                i += 1
        torch.cuda.synchronize()
        core = eng.core
        pools = [t for pair in core.kv_pools for t in pair]
        if core.kv_scales is not None:
            pools += [t for pair in core.kv_scales for t in pair]
        runs[value] = {"tokens": [r.out_tokens for r in reqs],
                       "pools": [t.cpu().view(torch.uint8) for t in pools],
                       "graphs": eng.graphs_captured,
                       "buckets": len(core._buckets),
                       "steps": eng.stats["decode_steps"],
                       "batches": batches}
    return runs["0"], runs["1"]


def _decode_row(check: str, kv_dtype: str, e: dict, c: dict) -> dict:
    same_pools = all(torch.equal(a, b) for a, b in zip(e["pools"],
                                                       c["pools"]))
    return {"check": check, "kv_dtype": kv_dtype,
            "requests": len(c["tokens"]), "decode_steps": c["steps"],
            "same_tokens": e["tokens"] == c["tokens"],
            "same_pools": same_pools, "graphs": c["graphs"],
            "buckets": c["buckets"],
            "ok": (e["tokens"] == c["tokens"] and same_pools
                   and 0 < c["graphs"] <= c["buckets"])}


def _prompts(vocab: int, n: int, seed: int, lo: int = 5, hi: int = 60):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, int(m)).tolist()
            for m in rng.randint(lo, hi, size=n)]


def compare_decode(kv_dtype: str, cfg: Optional[dict] = None,
                   n_requests: int = 6, max_new: int = 12,
                   **engine_kw) -> dict:
    """The same requests through one engine op by op and one captured:
    token streams, pools and scales bit for bit; graphs at most the
    buckets used."""
    vocab = (cfg or SMALL_DECODER)["vocab_size"]
    kw = dict(num_pages=64, page_size=8, max_batch=4, token_budget=512)
    kw.update(engine_kw)
    schedule = [(0, [(p, max_new) for p in _prompts(vocab, n_requests, 3)])]
    return _decode_row("decode", kv_dtype,
                       *_serve_both(kv_dtype, cfg, schedule, kw))


def _bucket(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def check_bucket_switch(kv_dtype: str = "float32",
                        cfg: Optional[dict] = None, **engine_kw) -> dict:
    """Decode at batch bucket 8, then 4, then 8 again: 8 requests, 5 of
    which end after 3 tokens; after step 8, 5 more arrive.  Tokens and
    pools equal the eager run's bit for bit, and the batch really went
    8, 4, 8."""
    vocab = (cfg or SMALL_DECODER)["vocab_size"]
    kw = dict(num_pages=128, page_size=8, max_batch=8, token_budget=1024)
    kw.update(engine_kw)
    first = _prompts(vocab, 8, 5)
    late = _prompts(vocab, 5, 6)
    schedule = [(0, [(p, 3 if i < 5 else 20) for i, p in enumerate(first)]),
                (8, [(p, 6) for p in late])]
    e, c = _serve_both(kv_dtype, cfg, schedule, kw)
    row = _decode_row("bucket_switch", kv_dtype, e, c)
    seen = []
    for n in c["batches"]:
        if n and (not seen or seen[-1] != _bucket(n)):
            seen.append(_bucket(n))
    row["batch_buckets_in_order"] = seen
    went_back = any(seen[i:i + 3] == [8, 4, 8] for i in range(len(seen)))
    row["ok"] = row["ok"] and went_back and e["batches"] == c["batches"]
    return row


def check_invalidation(steps: int = 6) -> dict:
    """LeNet: a ``scope.set`` of a weight before step 3 drops the graph
    (step 3 warms up, step 4 captures again); then a new batch size adds
    a graph, and the first batch size again replays the graph it had
    (signatures A, B, A: both graphs in one memory pool).  Every step
    equals the eager run with the same set."""
    main, startup, fetch, feed = _build(STATIC_CASES["lenet"])
    big = _build(STATIC_CASES["lenet"], batch=32)[3]
    state = _startup_state(startup)
    w = sorted(n for n in state if n.endswith(".w_0"))[0]
    graphs = []

    def hook(i, scope, exe):
        if i == 3:
            scope.set(w, scope.get(w) * 0.5)
        graphs.append(exe.graphs_captured)

    feeds = [feed] * steps + [big] * 3 + [feed] * 2
    with deterministic():
        e_out, e_state, _ = _steps(main, state, feeds, fetch, "0", hook)
        graphs.clear()
        c_out, c_state, exe = _steps(main, state, feeds, fetch, "1", hook)
    graphs.append(exe.graphs_captured)
    bad_fetch, bad_state = _diff((e_out, e_state), (c_out, c_state))
    # graphs captured before each step and after the last: step 0 warms
    # up, 1 captures, 2 replays; the set before step 3 makes it a warm-up
    # and step 4 a capture; the new batch warms up at 6 and captures at 7;
    # 9 and 10 replay the first batch's graph
    want = [0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3]
    return {"check": "invalidation", "graphs_before_each_step": graphs,
            "invalidations": exe.session_invalidations,
            "fetch_mismatches": bad_fetch, "state_mismatches": bad_state[:8],
            "ok": (graphs == want and exe.session_invalidations == 1
                   and not bad_fetch and not bad_state)}


def _dropout_program():
    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 5
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [64])
            label = fluid.layers.data("label", [1], dtype="int64")
            h = fluid.layers.fc(x, 128, act="relu")
            h = fluid.layers.dropout(
                h, 0.5, dropout_implementation="upscale_in_train")
            logits = fluid.layers.fc(h, 10)
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(logits, label))
            fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    mask = next(op_.output("Mask")[0] for op_ in main.global_block().ops
                if op_.type == "dropout")
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(32, 64).astype(np.float32),
            "label": rng.randint(0, 10, (32, 1)).astype(np.int64)}
    return main, startup, [loss.name, mask], feed


def check_dropout(steps: int = 5) -> dict:
    """The dropout program's masks: new on every replay, and equal to the
    eager steps' (the program's generator is registered with the graph,
    so a replay draws what the next eager step would draw)."""
    main, startup, fetch, feed = _dropout_program()
    state = _startup_state(startup)
    e_out, e_state, _ = _steps(main, state, [feed] * steps, fetch, "0")
    c_out, c_state, exe = _steps(main, state, [feed] * steps, fetch, "1")
    masks = [np.asarray(o[1]) for o in c_out]
    replays_new = all(masks[i].tobytes() != masks[j].tobytes()
                      for i in range(1, steps) for j in range(i))
    bad_fetch, bad_state = _diff((e_out, e_state), (c_out, c_state))
    keep = float(np.mean([m.mean() for m in masks]))
    return {"check": "dropout", "steps": steps, "graphs": exe.graphs_captured,
            "new_mask_every_step": replays_new, "keep_rate": keep,
            "fetch_mismatches": bad_fetch, "state_mismatches": bad_state[:8],
            "ok": (replays_new and not bad_fetch and not bad_state
                   and exe.graphs_captured == 1)}


def check_raises() -> dict:
    """A step holding a random op with a fixed seed cannot be captured:
    its second run raises, naming the op, and runs nothing eagerly."""
    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [8])
            blk = main.global_block()
            blk.create_var(name="noise", shape=(4, 8), dtype="float32")
            blk.append_op("uniform_random", outputs={"Out": ["noise"]},
                          attrs={"shape": [4, 8], "min": -1.0, "max": 1.0,
                                 "seed": 11, "dtype": 5})
            out = fluid.layers.elementwise_add(x, blk.var("noise"))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = Scope()
    feed = {"x": np.zeros((4, 8), np.float32)}
    msg = None
    with session("1"):
        exe.run(startup, scope=scope)
        first = exe.run(main, feed=feed, fetch_list=[out], scope=scope)[0]
        try:
            exe.run(main, feed=feed, fetch_list=[out], scope=scope)
        except StepCaptureError as e:
            msg = str(e)
    return {"check": "raises", "message": (msg or "")[:160],
            "first_run_finite": bool(np.isfinite(first).all()),
            "ok": msg is not None and "uniform_random" in msg
            and exe.graphs_captured == 0}


def launches_per_step(step, kernels: Dict[str, object], value: str,
                      steps: int = 3) -> Dict[str, float]:
    """``{name: launches per step}`` of ``kernels`` (``{name:
    KernelFunction}``) over ``steps`` runs of ``step`` with the session
    at ``value``, after two untimed runs (on: the warm-up and the
    capture, so the counted steps are replays)."""
    with session(value):
        for _ in range(2):
            step()
        before = {n: k.launches for n, k in kernels.items()}
        for _ in range(steps):
            step()
    torch.cuda.synchronize()
    return {n: (k.launches - before[n]) / steps for n, k in kernels.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("check_step_capture: needs a CUDA device")
    set_card_precision()
    rows = [compare_static(n, args.steps) for n in STATIC_CASES]
    rows += [compare_decode(dt) for dt in ("float32", "bfloat16", "int8")]
    rows += [check_bucket_switch(dt) for dt in ("float32", "int8")]
    rows += [check_invalidation(), check_dropout(), check_raises()]
    for r in rows:
        print(json.dumps(r), flush=True)
    if not all(r["ok"] for r in rows):
        sys.exit(1)


if __name__ == "__main__":
    main()
