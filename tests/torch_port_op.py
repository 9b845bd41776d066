"""One op of the PyTorch port and its grad ops, run through the port's
registry on a device; and the transposed and 3-D convolution cases at
any size.  Imports no JAX: the card tests
(``tests/test_torch_cuda_kernels.py``) and ``chip_smoke.py`` share it.
"""
import numpy as np
import torch


def run_port_op(device, op_type, ins, outs, attrs, grad_of):
    """One op (and its grad ops, with seeded cotangents for ``grad_of``)
    through the port's registry on ``device``: {var name: tensor}."""
    import paddle_tpu_torch.framework.core as tcore
    import paddle_tpu_torch.ops.registry as treg

    blk = tcore.Program().global_block()
    env = {}
    for items in ins.values():
        for name, arr in items:
            blk.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype))
            env[name] = torch.from_numpy(np.array(arr)).to(device)
    for names in outs.values():
        for n in names:
            if not blk.has_var(n):
                blk.create_var(name=n)
    op = blk.append_op(op_type, inputs={s: [n for n, _ in v]
                                        for s, v in ins.items()},
                       outputs=outs, attrs=dict(attrs))
    gen = torch.Generator(device=device).manual_seed(0)
    treg.run_op(op, env, blk, gen, torch.device(device))
    result = {n: env[n] for names in outs.values() for n in names}
    rng = np.random.RandomState(0)
    cots = {n + "@GRAD": torch.from_numpy(
        rng.randn(*result[n].shape).astype(np.float32)).to(device)
        for n in grad_of}
    for desc in (treg.make_grad_ops(op) if cots else []):
        for names in list(desc["inputs"].values()) + \
                list(desc["outputs"].values()):
            for n in names:
                if n != "@EMPTY@" and not blk.has_var(n):
                    blk.create_var(name=n)
        gop = blk.append_op(desc["type"], inputs=desc["inputs"],
                            outputs=desc["outputs"], attrs=desc["attrs"])
        env.update(cots)
        treg.run_op(gop, env, blk, gen, torch.device(device))
        for names in desc["outputs"].values():
            result.update({n: env[n] for n in names if n in env})
    return result


def r32(seed, *shape):
    """Seeded N(0, 1) float32 numpy array."""
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


_CONV_T = dict(strides=[2, 2], paddings=[1, 1], dilations=[1, 1], groups=1,
               data_format="NCHW")
_CONV_3D = dict(strides=[1, 2, 1], paddings=[1, 1, 0], dilations=[1, 1, 1],
                groups=1, data_format="NCDHW")


def conv_op_cases(x2, x3, x3t):
    """{case: (op type, ins, outs, attrs, grad_of)} of the transposed and
    3-D convolutions with 3x3(x3) filters: conv2d_transpose (c to 3c/4
    channels) and depthwise_conv2d_transpose at stride 2 on an input of
    shape ``x2``, conv3d (c to 2c) on ``x3``, conv3d_transpose (c to
    3c/4) on ``x3t``."""
    c2, c3, c3t = x2[1], x3[1], x3t[1]
    conv = {"Output": ["o"]}
    return {
        "conv2d_transpose": (
            "conv2d_transpose", {"Input": [("x", r32(1, *x2))],
                                 "Filter": [("w", r32(2, c2, 3 * c2 // 4,
                                                      3, 3))]},
            conv, dict(_CONV_T, output_padding=[1, 0]), ["o"]),
        "depthwise_conv2d_transpose": (
            "depthwise_conv2d_transpose",
            {"Input": [("x", r32(1, *x2))],
             "Filter": [("w", r32(2, c2, 1, 3, 3))]},
            conv, dict(_CONV_T, groups=c2), ["o"]),
        "conv3d": (
            "conv3d", {"Input": [("x", r32(1, *x3))],
                       "Filter": [("w", r32(2, 2 * c3, c3, 3, 3, 3))]},
            conv, _CONV_3D, ["o"]),
        "conv3d_transpose": (
            "conv3d_transpose", {"Input": [("x", r32(1, *x3t))],
                                 "Filter": [("w", r32(2, c3t, 3 * c3t // 4,
                                                      3, 3, 3))]},
            conv, dict(_CONV_3D, strides=[2, 1, 2]), ["o"]),
    }
