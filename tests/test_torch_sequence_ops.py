"""PyTorch port, the recurrent and sequence op lowerings and the
SelectedRows gradient against the JAX package's.

* One parametrised case per op type of ``ops/sequence_ops.py`` (and per
  variant: every ``sequence_pool`` type, both directions of the
  recurrences), forward and grad, through ``test_torch_static_ops``'s
  harness (each package's ``registry.run_op``, then the grad op its grad
  maker writes, on the same cotangents; JAX's side under one
  ``jax.jit``, a host op's op by op), at a small size with ragged
  lengths (a 0 among them where the op defines it).  The port's
  ``dynamic_lstm``, ``gru_unit`` and ``sequence_conv`` grads are its
  explicit lowerings; JAX's are its vjp.
* SelectedRows (``framework/selected_rows.py``): ``lookup_table``'s sparse
  gradient (duplicate ids, ``padding_idx``) against JAX's; ``sgd``,
  ``momentum``, ``adagrad`` and ``adam`` (lazy and not) stepping with a
  SelectedRows gradient; ``scale``, ``sum`` and ``clip_by_norm`` over
  one; ``merge_rows`` slot for slot.  A SelectedRows result is compared
  densified, its rows and values too where both packages keep one.

Tolerances, f32: rtol / atol 1e-5 (``TIGHT``) for elementwise results;
1e-4 (``SUMS``) where a product sums over the hidden width in another
order (oneDNN against XLA) and a recurrence carries it through T steps;
the update ops' ``ELEMENTWISE`` (rtol 1e-6) and ``NORMS`` (rtol 1e-5) of
``torch_optimizer_cases.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.framework.core as jcore
import paddle_tpu.ops.registry as jreg
from paddle_tpu.framework.selected_rows import SelectedRows as JSR
import paddle_tpu_torch.framework.core as tcore
import paddle_tpu_torch.ops.registry as treg
from paddle_tpu_torch.framework.selected_rows import SelectedRows as TSR

from test_torch_static_ops import GRAD, SUMS, TIGHT, _check as _check_eager
from test_torch_static_ops_math_nn import _check
from torch_optimizer_cases import ELEMENTWISE, NORMS

N, T, D, H = 4, 6, 3, 5
LEN = np.array([6, 3, 0, 4], np.int64)       # ragged, one empty row
LEN_RNN = np.array([6, 3, 1, 4], np.int64)   # ragged, none empty


def _r(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _seq(op_type, x, outs, attrs=None, length=LEN, tol=TIGHT, **extra):
    ins = {"X": [("x", x)]}
    if length is not None:
        ins["Length"] = [("len", length)]
    ins.update(extra)
    return _check(op_type, ins, outs, attrs,
                  cot_of=[n for n in outs.get("Out", outs.get("Y", []))],
                  tol=tol, int_slots=("Length",))


def _pool(ptype):
    outs = {"Out": ["o"]}
    if ptype == "MAX":
        outs["MaxIndex"] = ["mi"]
    x = _r(0, N, T, D)
    x[0, 1] = x[0, 4]                    # a tie inside a max window
    return _seq("sequence_pool", x, outs,
                {"pooltype": ptype, "pad_value": 0.5})


def _conv(c_len, c_start):
    return _seq("sequence_conv", _r(0, N, T, D), {"Out": ["o"]},
                {"contextLength": c_len, "contextStart": c_start,
                 "contextStride": 1}, tol=SUMS,
                Filter=[("w", _r(1, c_len * D, 7, scale=0.5))])


def _dynamic_lstm(reverse, with_init):
    ins = {"Input": [("x", _r(0, N, T, 4 * H))],
           "Weight": [("w", _r(1, H, 4 * H, scale=0.4))],
           "Bias": [("b", _r(2, 1, 4 * H, scale=0.1))],
           "SequenceLength": [("len", LEN_RNN)]}
    if with_init:
        ins["H0"] = [("h0", _r(3, N, H))]
        ins["C0"] = [("c0", _r(4, N, H))]
    outs = {"Hidden": ["hid"], "Cell": ["cell"], "LastH": ["lh"],
            "LastC": ["lc"]}
    return _check("dynamic_lstm", ins, outs,
                  {"is_reverse": reverse, "use_peepholes": False},
                  cot_of=["hid", "cell", "lh", "lc"], tol=SUMS,
                  int_slots=("SequenceLength",))


def _dynamic_gru(reverse):
    ins = {"Input": [("x", _r(0, N, T, 3 * H))],
           "Weight": [("w", _r(1, H, 3 * H, scale=0.4))],
           "Bias": [("b", _r(2, 1, 3 * H, scale=0.1))],
           "H0": [("h0", _r(3, N, H))],
           "SequenceLength": [("len", LEN_RNN)]}
    return _check("dynamic_gru", ins, {"Hidden": ["hid"], "LastH": ["lh"]},
                  {"is_reverse": reverse}, cot_of=["hid", "lh"], tol=SUMS,
                  int_slots=("SequenceLength",))


def _fused_rnn(op_type, gates):
    ins = {"Input": [("x", _r(0, N, T, D))],
           "WeightIh": [("wi0", _r(1, D, gates * H, scale=0.4)),
                        ("wi1", _r(2, D, gates * H, scale=0.4))],
           "WeightHh": [("wh0", _r(3, H, gates * H, scale=0.4)),
                        ("wh1", _r(4, H, gates * H, scale=0.4))],
           "Bias": [("b0", _r(5, gates * H, scale=0.1)),
                    ("b1", _r(6, gates * H, scale=0.1))],
           "InitH": [("h0", _r(7, 2, N, H))],
           "SequenceLength": [("len", LEN_RNN)]}
    outs = {"Out": ["o"], "LastH": ["lh"]}
    if op_type == "lstm":
        ins["InitC"] = [("c0", _r(8, 2, N, H))]
        outs["LastC"] = ["lc"]
    return _check(op_type, ins, outs,
                  {"is_bidirec": True, "num_layers": 1, "hidden_size": H},
                  cot_of=list(n for ns in outs.values() for n in ns),
                  tol=SUMS, int_slots=("SequenceLength",))


def _gru_unit(with_bias, gate_cot):
    ins = {"Input": [("x", _r(0, N, 3 * H))],
           "HiddenPrev": [("hp", _r(1, N, H))],
           "Weight": [("w", _r(2, H, 3 * H, scale=0.4))]}
    if with_bias:
        ins["Bias"] = [("b", _r(3, 1, 3 * H, scale=0.1))]
    return _check("gru_unit", ins,
                  {"Gate": ["gate"], "ResetHiddenPrev": ["rhp"],
                   "Hidden": ["h"]}, {},
                  cot_of=["h", "gate", "rhp"] if gate_cot else ["h"],
                  tol=SUMS)


def _beam_scores(nb, v, seed):
    """Log-probs with exact ties (two equal columns a row)."""
    x = _r(seed, nb, v)
    x[:, 3] = x[:, 1]
    return np.log(np.exp(x) / np.exp(x).sum(1, keepdims=True)).astype(
        np.float32)


def _beam_search():
    beam, v = 2, 7
    pre_ids = np.array([[4], [1], [2], [5], [1], [1]], np.int64)  # end_id 1
    pre_scores = np.array([[-0.5], [-0.7], [-1.0], [-1.0], [-0.2], [-0.2]],
                          np.float32)
    return _check("beam_search",
                  {"PreIds": [("pi", pre_ids)],
                   "PreScores": [("ps", pre_scores)],
                   "Scores": [("s", _beam_scores(6, v, 0))]},
                  {"SelectedIds": ["si"], "SelectedScores": ["ss"],
                   "ParentIdx": ["par"]},
                  {"beam_size": beam, "end_id": 1})


def _beam_search_decode():
    steps, nb = 4, 6
    rng = np.random.RandomState(0)
    ids = [("i%d" % t, rng.randint(0, 5, (nb, 1)).astype(np.int64))
           for t in range(steps)]
    scores = [("s%d" % t, _r(10 + t, nb, 1)) for t in range(steps)]
    parents = [("p%d" % t, (np.arange(nb) // 2 * 2
                            + rng.randint(0, 2, nb)).astype(np.int32))
               for t in range(steps)]
    return _check_eager("beam_search_decode",
                        {"Ids": ids, "Scores": scores, "ParentIdx": parents},
                        {"SentenceIds": ["sid"], "SentenceScores": ["ssc"],
                         "SentenceLength": ["sl"]},
                        {"beam_size": 2, "end_id": 1})


def _gather_tree():
    rng = np.random.RandomState(0)
    return _check("gather_tree",
                  {"Ids": [("ids", rng.randint(0, 9, (5, 3, 4)).astype(
                      np.int64))],
                   "Parents": [("par", rng.randint(0, 4, (5, 3, 4)).astype(
                       np.int64))]},
                  {"Out": ["o"]})


CASES = {
    "sequence_mask": lambda: _check(
        "sequence_mask", {"X": [("x", LEN)]}, {"Y": ["y"]},
        {"maxlen": 7, "out_dtype": "int64"}),
    "sequence_mask-float": lambda: _check(
        "sequence_mask", {"X": [("x", LEN)]}, {"Y": ["y"]},
        {"maxlen": 6, "out_dtype": "float32"}),
    "sequence_softmax": lambda: _seq("sequence_softmax", _r(0, N, T),
                                     {"Out": ["o"]}),
    "sequence_reverse": lambda: _seq("sequence_reverse", _r(0, N, T, D),
                                     {"Y": ["y"]}),
    "sequence_reverse-full": lambda: _seq(
        "sequence_reverse", _r(0, N, T, D), {"Y": ["y"]}, length=None),
    "sequence_conv": lambda: _conv(3, -1),
    "sequence_conv-window4": lambda: _conv(4, -1),
    "dynamic_lstm": lambda: _dynamic_lstm(False, False),
    "dynamic_lstm-reverse": lambda: _dynamic_lstm(True, True),
    "dynamic_gru": lambda: _dynamic_gru(False),
    "dynamic_gru-reverse": lambda: _dynamic_gru(True),
    "lstm": lambda: _fused_rnn("lstm", 4),
    "gru": lambda: _fused_rnn("gru", 3),
    "lstm_unit": lambda: _check(
        "lstm_unit", {"X": [("x", _r(0, N, 4 * H))],
                      "C_prev": [("c", _r(1, N, H))]},
        {"C": ["c_out"], "H": ["h"]}, {"forget_bias": 1.0},
        cot_of=["c_out", "h"]),
    "gru_unit": lambda: _gru_unit(True, False),
    "gru_unit-every_cotangent": lambda: _gru_unit(False, True),
    "beam_search": _beam_search,
    "beam_search_decode": _beam_search_decode,
    "gather_tree": _gather_tree,
    "beam_gather_states": lambda: _check(
        "beam_gather_states",
        {"X": [("x", _r(0, 3, 4, 5))],
         "Ids": [("ids", np.array([[0, 0, 3, 1], [2, 2, 2, 2],
                                   [3, 1, 0, 1]], np.int64))]},
        {"Out": ["o"]}, cot_of=["o"], int_slots=("Ids",)),
}
CASES.update({f"sequence_pool-{p.lower()}": (lambda p=p: _pool(p))
              for p in ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST")})


# --------------------------------------------------------------------------
# SelectedRows
# --------------------------------------------------------------------------
VOCAB, DIM = 9, 4
IDS = np.array([[3], [7], [3], [2], [0], [3], [8], [2]], np.int64)


def _dense(v):
    return v.numpy() if isinstance(v, (JSR, TSR)) else np.asarray(v)


def _run_env(core, reg, op_type, ins, outs, attrs):
    """Run one op on ready-made values: {output name: value}."""
    prog = core.Program()
    blk = prog.global_block()
    env = {}
    for slot, items in ins.items():
        for name, val in items:
            blk.create_var(name=name)
            env[name] = val
    for names in outs.values():
        for n in names:
            if not blk.has_var(n):
                blk.create_var(name=n)
    op = blk.append_op(op_type, inputs={s: [n for n, _ in v]
                                        for s, v in ins.items()},
                       outputs=outs, attrs=dict(attrs))
    reg.run_op(op, env, blk)
    return {n: env[n] for names in outs.values() for n in names}


def _sr_pair(seed=0, ids=IDS, height=VOCAB):
    rows = ids.reshape(-1)
    vals = _r(seed, rows.size, DIM)
    return (JSR(jnp.asarray(rows.astype(np.int32)), jnp.asarray(vals),
                height),
            TSR(torch.from_numpy(rows.copy()), torch.from_numpy(vals.copy()),
                height))


def _both(op_type, ins, outs, attrs, tol, sparse_out=()):
    """ins: slot -> [(name, numpy or (jax SR, port SR))]."""
    def pick(k):
        return {s: [(n, (v[k] if isinstance(v, tuple) else
                         (jnp.asarray(v) if k == 0 else
                          torch.from_numpy(np.array(v)))))
                    for n, v in items] for s, items in ins.items()}
    j = _run_env(jcore, jreg, op_type, pick(0), outs, attrs)
    t = _run_env(tcore, treg, op_type, pick(1), outs, attrs)
    for n in j:
        assert isinstance(t[n], TSR) == (n in sparse_out), n
        assert isinstance(j[n], JSR) == (n in sparse_out), n
        np.testing.assert_allclose(_dense(t[n]), _dense(j[n]), err_msg=n,
                                   **tol)


def _update_sr(op_type, accs, attrs, tol=ELEMENTWISE):
    ins = {"Param": [("p", _r(20, VOCAB, DIM))],
           "Grad": [("g", _sr_pair())],
           "LearningRate": [("lr", np.array([0.1], np.float32))]}
    outs = {"ParamOut": ["p"]}
    for in_slot, out_slot, name, value in accs:
        ins[in_slot] = [(name, value)]
        outs[out_slot] = [name]
    _both(op_type, ins, outs, attrs, tol)


def _pos(seed, *shape):
    return (np.random.RandomState(seed).rand(*shape) + 0.1).astype(
        np.float32)


def _adam_sr(lazy):
    _update_sr("adam", [
        ("Moment1", "Moment1Out", "m1", 0.1 * _r(21, VOCAB, DIM)),
        ("Moment2", "Moment2Out", "m2", 0.1 * _pos(22, VOCAB, DIM)),
        ("Beta1Pow", "Beta1PowOut", "b1p", np.array([0.729], np.float32)),
        ("Beta2Pow", "Beta2PowOut", "b2p", np.array([0.997], np.float32))],
        {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "lazy_mode": lazy})


def _lookup_sparse(op_type, ids, padding_idx):
    """The forward and its sparse grad in each package: W@GRAD densified
    equal, the port's a SelectedRows of the raw (clipped) ids."""
    w = _r(0, VOCAB, DIM)
    attrs = {"padding_idx": padding_idx, "is_sparse": True,
             "is_distributed": False}
    res = {}
    for core, reg, to in ((jcore, jreg, jnp.asarray),
                          (tcore, treg, lambda v: torch.from_numpy(
                              np.array(v)))):
        prog = core.Program()
        blk = prog.global_block()
        blk.create_var(name="w", shape=w.shape, dtype="float32")
        blk.create_var(name="ids", shape=ids.shape, dtype="int64",
                       stop_gradient=True)
        blk.create_var(name="o")
        op = blk.append_op(op_type, inputs={"W": ["w"], "Ids": ["ids"]},
                           outputs={"Out": ["o"]}, attrs=attrs)
        env = {"w": to(w), "ids": to(ids)}
        reg.run_op(op, env, blk)
        (desc,) = reg.make_grad_ops(op, frozenset({"ids"}))
        assert desc["type"] == "lookup_table_sparse_grad"
        for names in desc["outputs"].values():
            for n in names:
                blk.create_var(name=n)
        gop = blk.append_op(desc["type"], inputs=desc["inputs"],
                            outputs=desc["outputs"], attrs=desc["attrs"])
        env["o@GRAD"] = to(_r(1, *np.shape(env["o"])))
        reg.run_op(gop, env, blk)
        res[core] = (env["o"], env["w@GRAD"])
    (jo, jg), (to_, tg) = res[jcore], res[tcore]
    np.testing.assert_allclose(to_.numpy(), np.asarray(jo), **TIGHT)
    assert isinstance(tg, TSR) and isinstance(jg, JSR)
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg.rows))
    np.testing.assert_allclose(tg.values.numpy(), np.asarray(jg.values),
                               **TIGHT)
    np.testing.assert_allclose(tg.to_dense().numpy(), _dense(jg), **TIGHT)


_IDS_OUT_OF_RANGE = np.array([[[3], [11]], [[3], [-2]]], np.int64)

CASES.update({
    "lookup_table-sparse": lambda: _lookup_sparse("lookup_table", IDS, 3),
    "lookup_table-sparse_clipped": lambda: _lookup_sparse(
        "lookup_table", _IDS_OUT_OF_RANGE, -1),
    "lookup_table_v2-sparse": lambda: _lookup_sparse(
        "lookup_table_v2", IDS.reshape(2, 4), 2),
    "embedding-sparse": lambda: _lookup_sparse("embedding",
                                               IDS.reshape(2, 4), -1),
    "sgd-sparse": lambda: _update_sr("sgd", [], {}),
    "momentum-sparse": lambda: _update_sr(
        "momentum", [("Velocity", "VelocityOut", "v", _r(21, VOCAB, DIM))],
        {"mu": 0.9}),
    "momentum-sparse_nesterov": lambda: _update_sr(
        "momentum", [("Velocity", "VelocityOut", "v", _r(21, VOCAB, DIM))],
        {"mu": 0.9, "use_nesterov": True}),
    "adagrad-sparse": lambda: _update_sr(
        "adagrad", [("Moment", "MomentOut", "m", _pos(21, VOCAB, DIM))],
        {"epsilon": 1e-6}),
    "adam-sparse_lazy": lambda: _adam_sr(True),
    "adam-sparse_dense": lambda: _adam_sr(False),
    "scale-sparse": lambda: _both(
        "scale", {"X": [("x", _sr_pair())]}, {"Out": ["o"]},
        {"scale": 0.1, "bias": 0.0}, TIGHT, sparse_out=("o",)),
    "scale-sparse_bias": lambda: _both(
        "scale", {"X": [("x", _sr_pair())]}, {"Out": ["o"]},
        {"scale": 0.1, "bias": 0.5}, TIGHT),
    "sum-sparse": lambda: _both(
        "sum", {"X": [("a", _sr_pair(0)), ("b", _sr_pair(1))]},
        {"Out": ["o"]}, {}, TIGHT, sparse_out=("o",)),
    "sum-sparse_dense": lambda: _both(
        "sum", {"X": [("a", _sr_pair(0)), ("b", _r(5, VOCAB, DIM))]},
        {"Out": ["o"]}, {}, TIGHT),
    "sum-dense_sparse": lambda: _both(
        "sum", {"X": [("b", _r(5, VOCAB, DIM)), ("a", _sr_pair(0))]},
        {"Out": ["o"]}, {}, TIGHT),
    "clip_by_norm-sparse": lambda: _both(
        "clip_by_norm", {"X": [("x", _sr_pair())]}, {"Out": ["o"]},
        {"max_norm": 1.0}, NORMS, sparse_out=("o",)),
    "clip_by_norm-sparse_unclipped": lambda: _both(
        "clip_by_norm", {"X": [("x", _sr_pair())]}, {"Out": ["o"]},
        {"max_norm": 100.0}, NORMS, sparse_out=("o",)),
})


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    CASES[case]()


def test_merge_rows_matches_jax_slot_for_slot():
    j, t = _sr_pair(3)
    jm, tm = j.merge_rows(), t.merge_rows()
    np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(jm.rows))
    np.testing.assert_allclose(tm.values.numpy(), np.asarray(jm.values),
                               **TIGHT)
    # the sentinel slots: row == height, value 0, and they densify away
    n_rows = len(set(IDS.reshape(-1).tolist()))
    assert (tm.rows.numpy()[n_rows:] == VOCAB).all()
    assert not tm.values.numpy()[n_rows:].any()
    np.testing.assert_allclose(tm.to_dense().numpy(), t.to_dense().numpy(),
                               **TIGHT)


def test_sparse_embedding_program_fetches_dense_and_fuses_as_jax():
    """A static program with ``embedding(is_sparse=True)`` under Adam
    lazy mode: the W gradient is a SelectedRows between its grad op and
    the update, and a fetch of it is dense.  The fuse pass groups the
    sparse update with the dense ones as JAX's does (its SELECTED_ROWS
    var-type check never fires: no JAX layer sets the type), so the
    fused update sees the densified gradient in both packages."""
    import paddle_tpu_torch.fluid as fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", [3], dtype="int64")
        e = fluid.layers.embedding(ids, size=[10, 4], is_sparse=True)
        loss = fluid.layers.mean(fluid.layers.fc(e, 2, num_flatten_dims=2))
        fluid.optimizer.AdamOptimizer(0.1, lazy_mode=True).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    w_name = main.global_block().all_parameters()[0].name
    feed = {"ids": np.array([[1, 1, 4], [4, 9, 0]], np.int64)}
    (g,) = exe.run(main, feed=feed, fetch_list=[w_name + GRAD],
                   scope=scope)
    assert g.shape == (10, 4)
    assert not g[[2, 3, 5, 6, 7, 8]].any() and g[1].any()
    types = [o.type for o in list(exe._cache.values())[-1].ops]
    assert "lookup_table_sparse_grad" in types and "fused_adam" in types


def test_lazy_adam_fused_densifies_as_jax():
    """``AdamOptimizer(lazy_mode=True)`` over a sparse embedding and an fc
    in each package from JAX's startup scope: the fuse pass groups the
    three updates into one ``fused_adam`` over the densified gradient, so
    a row that step 1's ids touch and step 2's do not still moves in
    step 2 (its moments decay), in both packages; every parameter and
    moment within rtol / atol 1e-5 of JAX's after the two steps."""
    import paddle_tpu as pt
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.framework import unique_name as junique
    import paddle_tpu_torch.fluid as tfluid
    from paddle_tpu_torch.framework import unique_name as tunique
    from paddle_tpu_torch.framework.scope import load_numpy_state

    def build(fluid, un):
        prev = un.switch()
        try:
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                ids = fluid.layers.data("ids", [3], dtype="int64")
                e = fluid.layers.embedding(ids, size=[10, 4],
                                           is_sparse=True)
                loss = fluid.layers.mean(
                    fluid.layers.fc(e, 2, num_flatten_dims=2))
                fluid.optimizer.AdamOptimizer(
                    0.1, lazy_mode=True).minimize(loss)
        finally:
            un.switch(prev)
        return main, startup, loss

    jmain, jstart, jloss = build(jfluid, junique)
    tmain, _, tloss = build(tfluid, tunique)
    jexe, jscope = pt.Executor(pt.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    names = [v.name for v in jstart.global_block().vars.values()
             if v.persistable]
    tscope = tfluid.Scope()
    load_numpy_state(tscope, {n: np.asarray(jscope.get(n)) for n in names},
                     "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    w_name = tmain.global_block().all_parameters()[0].name
    feeds = [{"ids": np.array([[1, 1, 4], [2, 9, 0]], np.int64)},
             {"ids": np.array([[1, 4, 4], [9, 9, 0]], np.int64)}]
    w1 = None
    for step, fd in enumerate(feeds):
        jexe.run(jmain, feed=fd, fetch_list=[jloss], scope=jscope)
        texe.run(tmain, feed=fd, fetch_list=[tloss], scope=tscope)
        if step == 0:
            w1 = (np.asarray(jscope.get(w_name)).copy(),
                  tscope.get(w_name).numpy().copy())
    for n in names:
        np.testing.assert_allclose(tscope.get(n).numpy(),
                                   np.asarray(jscope.get(n)), err_msg=n,
                                   rtol=1e-5, atol=1e-5)
    # row 2: in step 1's ids, not in step 2's; a lazy update keeps it
    for before, after in zip(w1, (np.asarray(jscope.get(w_name)),
                                  tscope.get(w_name).numpy())):
        assert (after[2] != before[2]).all()
        np.testing.assert_array_equal(after[[3, 5, 6, 7, 8]],
                                      before[[3, 5, 6, 7, 8]])
    types = [o.type for o in list(texe._cache.values())[-1].ops]
    assert types.count("fused_adam") == 1 and "adam" not in types


def test_static_rnn_raises_until_control_flow_is_ported():
    import paddle_tpu_torch.fluid as fluid
    with pytest.raises(NotImplementedError, match="control-flow"):
        fluid.layers.StaticRNN()
