"""The static BERT encoder program, built once against whichever ``fluid``
module it is given: ``paddle_tpu.fluid`` (the JAX package) or
``paddle_tpu_torch.fluid`` (the port) build it op for op alike.  The
port's encoder tests and ``chip_smoke.py`` build it from here; this
module imports neither package (nor ``jax``) itself.

The program is a post-LN BERT encoder trained on a masked-LM loss over
every position:

* ``fluid.data`` feeds: ``src_ids``, ``pos_ids``, ``sent_ids`` (int64,
  (b, s)), ``input_mask`` (f32, (b, s): 1 for a token, 0 for padding)
  and ``mlm_label`` (int64, (b, s, 1));
* word, position and token-type ``fluid.embedding`` summed, then
  ``layer_norm`` and ``dropout``;
* per layer: Q, K and V by ``fc(num_flatten_dims=2)``, ``reshape`` and
  ``transpose`` to (b, heads, s, head_dim);
  ``layers.fused_multihead_attention`` with the (b, 1, 1, s) additive
  padding bias made in the program from ``input_mask``, scale
  ``head_dim ** -0.5`` and the attention dropout; ``transpose`` and
  ``reshape`` back, the out ``fc``, ``dropout``, the residual add and
  ``layer_norm``; ``fc(act="gelu")`` to the intermediate width, ``fc``
  back, ``dropout``, the residual add and ``layer_norm``;
* the MLM head: ``fc`` to the vocabulary, ``softmax_with_cross_entropy``
  and ``reduce_mean``;
* ``AdamOptimizer`` (``minimize``: ``append_backward`` and the updates),
  under bf16 ``decorate`` or fp16 ``decorate`` with dynamic loss scaling
  when asked.

:data:`BERT_BASE` holds the widths of ``google-bert/bert-base-uncased``;
:data:`TINY` the tests' size.
"""
import numpy as np

#: google-bert/bert-base-uncased: hidden 768, 12 layers of 12 heads of 64,
#: intermediate 3072, vocabulary 30522, 512 positions, 2 token types;
#: exact gelu, dropout 0.1 on hidden states and attention probabilities
BERT_BASE = dict(vocab=30522, hidden=768, layers=12, heads=12,
                 intermediate=3072, max_pos=512, type_vocab=2,
                 hidden_dropout=0.1, attn_dropout=0.1)
#: the CPU tests' encoder: 2 layers, hidden 64, 4 heads, vocabulary 128
TINY = dict(vocab=128, hidden=64, layers=2, heads=4, intermediate=128,
            max_pos=64, type_vocab=2, hidden_dropout=0.0, attn_dropout=0.0)


def encoder_loss(fluid, cfg, seq):
    """Build the encoder and its loss into the current program guard of
    ``fluid``; returns the loss var."""
    L = fluid.layers
    h, nh = cfg["hidden"], cfg["heads"]
    dh = h // nh
    src = fluid.data("src_ids", [-1, seq], "int64")
    pos = fluid.data("pos_ids", [-1, seq], "int64")
    sent = fluid.data("sent_ids", [-1, seq], "int64")
    mask = fluid.data("input_mask", [-1, seq], "float32")
    label = fluid.data("mlm_label", [-1, seq, 1], "int64")

    def hidden_dropout(x):
        p = cfg["hidden_dropout"]
        if not p:
            return x
        return L.dropout(x, p, dropout_implementation="upscale_in_train")

    emb = L.elementwise_add(
        L.elementwise_add(fluid.embedding(src, [cfg["vocab"], h]),
                          fluid.embedding(pos, [cfg["max_pos"], h])),
        fluid.embedding(sent, [cfg["type_vocab"], h]))
    x = hidden_dropout(L.layer_norm(emb, begin_norm_axis=2))
    # 0 on a token, -10000 on padding, broadcast over heads and queries
    bias = L.unsqueeze(L.scale(mask, scale=10000.0, bias=-10000.0),
                       axes=[1, 2])

    def heads(t):
        return L.transpose(L.reshape(t, [0, 0, nh, dh]), [0, 2, 1, 3])

    for _ in range(cfg["layers"]):
        q, k, v = (heads(L.fc(x, h, num_flatten_dims=2)) for _ in range(3))
        ctx = L.fused_multihead_attention(
            q, k, v, bias, scale=dh ** -0.5,
            dropout_rate=cfg["attn_dropout"])
        ctx = L.reshape(L.transpose(ctx, [0, 2, 1, 3]), [0, 0, h])
        attn = hidden_dropout(L.fc(ctx, h, num_flatten_dims=2))
        x = L.layer_norm(L.elementwise_add(x, attn), begin_norm_axis=2)
        ffn = L.fc(x, cfg["intermediate"], num_flatten_dims=2, act="gelu")
        ffn = hidden_dropout(L.fc(ffn, h, num_flatten_dims=2))
        x = L.layer_norm(L.elementwise_add(x, ffn), begin_norm_axis=2)
    logits = L.fc(x, cfg["vocab"], num_flatten_dims=2)
    return L.reduce_mean(L.softmax_with_cross_entropy(logits, label))


def build_encoder(fluid, unique_name, cfg, seq, lr=1e-4, amp=None, seed=1):
    """``(main, startup, loss)`` of the encoder train program under
    ``AdamOptimizer(lr)``, from a fresh name generator; ``amp`` None
    (f32), ``"bfloat16"`` (``decorate``) or ``"float16"``
    (``decorate(use_fp16=True)``, dynamic loss scaling)."""
    prev = unique_name.switch()
    try:
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = seed
        with fluid.program_guard(main, startup):
            loss = encoder_loss(fluid, cfg, seq)
            opt = fluid.optimizer.AdamOptimizer(lr)
            if amp is not None:
                opt = fluid.contrib.mixed_precision.decorate(
                    opt, use_fp16=amp == "float16")
            opt.minimize(loss)
    finally:
        unique_name.switch(prev)
    return main, startup, loss


def encoder_feed(cfg, batch, seq, seed=0, min_len=None):
    """One numpy feed: random tokens, each row padded after a random
    length in [``min_len`` (default seq // 2), seq]; padded positions
    carry token 0 and mask 0, and every label is a random token."""
    rng = np.random.RandomState(seed)
    lo = seq // 2 if min_len is None else min_len
    lens = rng.randint(lo, seq + 1, batch)
    keep = np.arange(seq)[None, :] < lens[:, None]
    src = rng.randint(1, cfg["vocab"], (batch, seq)) * keep
    return {
        "src_ids": src.astype(np.int64),
        "pos_ids": np.tile(np.arange(seq, dtype=np.int64), (batch, 1)),
        "sent_ids": (np.arange(seq)[None, :] >= lens[:, None] // 2)
        .astype(np.int64) * keep,
        "input_mask": keep.astype(np.float32),
        "mlm_label": rng.randint(0, cfg["vocab"], (batch, seq, 1))
        .astype(np.int64),
    }


def main(argv=None):
    """Train the encoder with the port, printing each step's loss:

        PYTHONPATH=. python tests/torch_static_encoder.py --tiny \\
            --device cpu [--amp bfloat16 | --amp float16]

    (``--tiny``: :data:`TINY` at batch 2 x seq 64; otherwise BERT-base
    at ``--batch`` x ``--seq``, 44 x 512 by default, on the card.)"""
    import argparse
    import time

    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--amp", default=None, choices=("bfloat16", "float16"))
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-4)
    args = ap.parse_args(argv)

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.scope import Scope

    cfg = dict(TINY if args.tiny else BERT_BASE)
    if args.layers:
        cfg["layers"] = args.layers
    batch = args.batch or (2 if args.tiny else 44)
    seq = args.seq or (64 if args.tiny else 512)
    main_prog, startup, loss = build_encoder(fluid, unique_name, cfg, seq,
                                             lr=args.lr, amp=args.amp)
    exe = fluid.Executor(fluid.CPUPlace() if args.device == "cpu"
                         else fluid.CUDAPlace(0))
    scope = Scope()
    exe.run(startup, scope=scope)
    feed = encoder_feed(cfg, batch, seq)
    for step in range(args.steps):
        t = time.perf_counter()
        out = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
        print(f"step {step}: loss {float(out[0]):.6f} "
              f"({(time.perf_counter() - t) * 1e3:.1f} ms)", flush=True)


if __name__ == "__main__":
    main()
