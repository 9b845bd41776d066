"""The static PSPNet segmentation program, built once against whichever
``fluid`` module it is given: ``paddle_tpu.fluid`` (the JAX package) or
``paddle_tpu_torch.fluid`` (the port) build it op for op alike.  The
port's PSPNet tests and ``chip_smoke.py`` build it from here; this
module imports neither package (nor ``jax``) itself.

PSPNet (Zhao et al., "Pyramid Scene Parsing Network", CVPR 2017,
arXiv:1612.01105) with a ResNet-50 backbone:

* the backbone: the bottleneck layout of the JAX package's
  ``models/resnet.py`` (conv -> BN -> ReLU units, the shortcut added
  before the block's last ReLU), dilated as in the paper's section 4 to
  output stride 8: stage 3 at stride 1 with dilation 2, stage 4 at
  stride 1 with dilation 4 (every 3x3 of the stage), so a 713x713 crop
  gives 90x90 maps; ``layers.conv2d(dilation=...)`` builds it, since
  ``models/resnet.py`` takes no dilation;
* the pyramid pooling module on stage 4: for each bin of 1, 2, 3 and 6,
  ``adaptive_pool2d(avg)``, a 1x1 conv to ``ppm_width`` + BN + ReLU and
  ``resize_bilinear`` back to the map's size; the branches concatenated
  with the features; a 3x3 conv to ``head_width`` + BN + ReLU, dropout
  and a 1x1 conv to the classes; ``resize_bilinear`` to the crop;
* the auxiliary head on stage 3: a 3x3 conv to ``aux_width`` + BN +
  ReLU, dropout, a 1x1 conv to the classes and the resize, weighted
  ``aux_weight`` in the loss;
* the loss: the logits transposed to NHWC and reshaped to (pixels,
  classes), as PaddleSeg does, ``softmax_with_cross_entropy`` with
  ``ignore_index`` 255, then ``reduce_mean``;
* ``MomentumOptimizer(0.9)`` with ``L2Decay(1e-4)`` on the "poly" rate
  ``polynomial_decay(lr, decay_steps, 0, power=0.9)`` computed in the
  program, under bf16 ``decorate`` when asked;
* the evaluation fetches: ``argmax`` over the classes and ``mean_iou``
  against the label.

:data:`PSPNET_R50` holds the paper's widths (Cityscapes: 19 classes,
713x713 crops; the paper's batch 16 is cut to 8 for one card);
:data:`TINY` the CPU tests' size.
"""
import numpy as np

#: PSPNet-ResNet-50 on Cityscapes: ResNet-50 (3, 4, 6, 3 bottlenecks,
#: base width 64) at output stride 8, bins 1 / 2 / 3 / 6 at 512 wide,
#: the head's 3x3 conv 512 wide, the auxiliary head 256 wide at weight
#: 0.4, dropout 0.1, 19 classes, 713x713 crops
PSPNET_R50 = dict(blocks=(3, 4, 6, 3), base=64, classes=19,
                  bins=(1, 2, 3, 6), ppm_width=512, head_width=512,
                  aux_width=256, aux_weight=0.4, dropout=0.1, crop=713)
#: the CPU tests' network: one bottleneck a stage at base width 8, heads
#: 16 / 16 / 8 wide, 5 classes, no dropout, 96x96 crops (12x12 maps at
#: output stride 8, which every bin divides)
TINY = dict(blocks=(1, 1, 1, 1), base=8, classes=5, bins=(1, 2, 3, 6),
            ppm_width=16, head_width=16, aux_width=8, aux_weight=0.4,
            dropout=0.0, crop=96)
#: the label of a pixel that does not count
IGNORE = 255
#: the share of the feeds' pixels labelled IGNORE
IGNORE_FRAC = 0.1
#: the programs' random seed (their startup initializers, dropout)
PROGRAM_SEED = 1


def _conv_bn(L, x, filters, k, stride=1, dilation=1, act=None):
    conv = L.conv2d(x, filters, k, stride=stride,
                    padding=dilation * (k - 1) // 2, dilation=dilation,
                    bias_attr=False)
    return L.batch_norm(conv, act=act)


def _bottleneck(L, x, filters, stride, dilation):
    a = _conv_bn(L, x, filters, 1, act="relu")
    b = _conv_bn(L, a, filters, 3, stride, dilation, act="relu")
    c = _conv_bn(L, b, filters * 4, 1)
    short = x
    if x.shape[1] != filters * 4 or stride != 1:
        short = _conv_bn(L, x, filters * 4, 1, stride)
    return L.elementwise_add(short, c, act="relu")


def _dropout(L, x, p):
    if not p:
        return x
    return L.dropout(x, p, dropout_implementation="upscale_in_train")


def _classifier(L, x, cfg, width, size):
    """3x3 conv + BN + ReLU, dropout, 1x1 conv to the classes, resized
    to the crop."""
    x = _conv_bn(L, x, width, 3, act="relu")
    x = _dropout(L, x, cfg["dropout"])
    x = L.conv2d(x, cfg["classes"], 1)
    return L.resize_bilinear(x, out_shape=(size, size))


def pspnet_logits(fluid, cfg, img):
    """(main logits, auxiliary logits), NCHW at the crop's size."""
    L = fluid.layers
    x = _conv_bn(L, img, cfg["base"], 7, 2, act="relu")
    x = L.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                 pool_type="max")
    strides, dilations = (1, 2, 1, 1), (1, 1, 2, 4)
    aux_in = None
    for stage, count in enumerate(cfg["blocks"]):
        for i in range(count):
            x = _bottleneck(L, x, cfg["base"] * 2 ** stage,
                            strides[stage] if i == 0 else 1,
                            dilations[stage])
        if stage == 2:
            aux_in = x
    h, w = x.shape[2], x.shape[3]
    branches = [x]
    for b in cfg["bins"]:
        p = L.adaptive_pool2d(x, b, pool_type="avg")
        p = _conv_bn(L, p, cfg["ppm_width"], 1, act="relu")
        branches.append(L.resize_bilinear(p, out_shape=(h, w)))
    head = L.concat(branches, axis=1)
    return (_classifier(L, head, cfg, cfg["head_width"], cfg["crop"]),
            _classifier(L, aux_in, cfg, cfg["aux_width"], cfg["crop"]))


def _seg_loss(L, logits, label, classes):
    nhwc = L.transpose(logits, [0, 2, 3, 1])
    flat = L.reshape(nhwc, [-1, classes])
    return L.reduce_mean(L.softmax_with_cross_entropy(
        flat, L.reshape(label, [-1, 1]), ignore_index=IGNORE))


def pspnet_loss(fluid, cfg):
    """Build the network, its loss and the evaluation fetches into the
    current program guard of ``fluid``: (loss, mean IoU, prediction)."""
    L = fluid.layers
    crop = cfg["crop"]
    img = fluid.data("image", [-1, 3, crop, crop], "float32")
    label = fluid.data("label", [-1, crop, crop, 1], "int64")
    main, aux = pspnet_logits(fluid, cfg, img)
    loss = L.elementwise_add(
        _seg_loss(L, main, label, cfg["classes"]),
        L.scale(_seg_loss(L, aux, label, cfg["classes"]),
                scale=cfg["aux_weight"]))
    pred = L.argmax(main, axis=1)
    miou, _, _ = L.mean_iou(pred, L.reshape(label, [-1, crop, crop]),
                            cfg["classes"])
    return loss, miou, pred


def build_pspnet(fluid, unique_name, cfg, lr=0.01, decay_steps=1000,
                 amp=None):
    """``(main, startup, loss, miou)`` of the PSPNet train program under
    ``MomentumOptimizer(0.9)``, ``L2Decay(1e-4)`` and the poly rate, from
    a fresh name generator; ``amp`` None (f32) or ``"bfloat16"``
    (``decorate``)."""
    prev = unique_name.switch()
    try:
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = PROGRAM_SEED
        with fluid.program_guard(main, startup):
            loss, miou, _ = pspnet_loss(fluid, cfg)
            rate = fluid.layers.polynomial_decay(lr, decay_steps, 0.0,
                                                 power=0.9)
            opt = fluid.optimizer.MomentumOptimizer(
                rate, 0.9, regularization=fluid.regularizer.L2Decay(1e-4))
            if amp is not None:
                opt = fluid.contrib.mixed_precision.decorate(
                    opt, use_fp16=amp == "float16")
            opt.minimize(loss)
    finally:
        unique_name.switch(prev)
    return main, startup, loss, miou


def pspnet_feed(cfg, batch, seed=0):
    """One numpy feed: images N(0, 1), labels uniform over the classes
    with about :data:`IGNORE_FRAC` of the pixels set to :data:`IGNORE`."""
    rng = np.random.RandomState(seed)
    crop = cfg["crop"]
    label = rng.randint(0, cfg["classes"], (batch, crop, crop, 1))
    label[rng.rand(batch, crop, crop, 1) < IGNORE_FRAC] = IGNORE
    return {"image": rng.randn(batch, 3, crop, crop).astype(np.float32),
            "label": label.astype(np.int64)}


def main(argv=None):
    """Train PSPNet with the port, printing each step's loss and mean
    IoU:

        PYTHONPATH=. python tests/torch_static_pspnet.py --tiny \\
            --device cpu [--amp bfloat16]

    (``--tiny``: :data:`TINY` at batch 2; otherwise PSPNet-ResNet-50 at
    ``--batch`` 713x713 crops, 8 by default, on the card.)"""
    import argparse
    import time

    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--amp", default=None, choices=("bfloat16",))
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--lr", type=float, default=0.01)
    args = ap.parse_args(argv)

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.framework import unique_name

    cfg = TINY if args.tiny else PSPNET_R50
    batch = args.batch or (2 if args.tiny else 8)
    main_prog, startup, loss, miou = build_pspnet(
        fluid, unique_name, cfg, lr=args.lr, amp=args.amp)
    place = fluid.CPUPlace() if args.device == "cpu" else fluid.CUDAPlace(0)
    exe = fluid.Executor(place)
    exe.run(startup)
    feed = pspnet_feed(cfg, batch)
    for step in range(args.steps):
        t0 = time.perf_counter()
        lv, mv = exe.run(main_prog, feed=feed,
                         fetch_list=[loss.name, miou.name])
        print(f"step {step}: loss {float(lv):.6f} mean_iou {float(mv):.4f} "
              f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")


if __name__ == "__main__":
    main()
