"""PyTorch port, the compiled step's CPU side: what runs the same way
eagerly and inside a CUDA graph, held to the JAX package and to the
port's earlier formulation on the CPU (the graphs themselves run only on
the card: ``tests/test_torch_cuda_kernels.py``).

* the static-shape KV write (``ops/paged_ops.write_plan``,
  ``kv_cache_append``, and the serving forms' plan that knows row 0 is
  live) over f32, bf16 and int8 pools == JAX's
  ``kv_cache_append`` (its ``_quant_scatter`` for int8) and == the
  port's data-dependent formulation it replaces (``nonzero`` to drop the
  pad sentinel, ``unique`` for int8's touched pages, copied below), bit
  for bit: pad sentinels first, between and last, several rows of one
  page, page opens, the pool's last slot, a step whose every row is a
  pad, and seeded multi-step sequences;
* the int8 write over a host-built page list (the prefill and chunk
  forms': ``touched``, ``serving.touched_pages``) == the per-row write
  and the old one, bit for bit, with a listed page no row writes and a
  page listed twice;
* a capture's recorded kernel launches (``kernel_build
  .recorded_launches``) count at each replay (``CapturedStep``), and a
  dead scope's step session leaves its executor;
* the scope's write stamp: which writes bump ``Scope.mutation_counter``,
  and that the executor's in-place writeback does not while its
  replacement writeback does;
* ``FLAGS_cuda_step_session`` resolution: ``auto`` is off on the CPU,
  ``"1"`` on a CPU executor or engine raises, the CPU path is the same
  under every value;
* ``FeedStager`` / ``double_buffered_feeds``: identical staged values
  with ``FLAGS_cuda_double_buffer`` on and off, equal to the executor's
  own feed conversion; a staging error surfaces at its batch;
* ``tools/check_step_capture.py`` finds MobileNet's rate on the program
  as built, which the executor's ``fuse_optimizer_ops_pass`` rewrites.

Every comparison is exact (bit for bit); the only tolerance is the
training-loss one of the staged-feed run (none: the same program on the
same values gives the same bits).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.registry import eager_call

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.executor import (FeedStager, StagedFeed,
                                       double_buffered_feeds)
from paddle_tpu_torch.framework import unique_name
from paddle_tpu_torch.framework.scope import (Scope, load_numpy_state,
                                              scope_guard)
from paddle_tpu_torch.inference import serving as T
from paddle_tpu_torch.ops import paged_ops as tpo
from paddle_tpu_torch.utils import flags as tflags
from paddle_tpu_torch.utils.flags import cuda_step_session_enabled

N_KV, N_PAGES, PS, D = 2, 4, 4, 8
PAD = N_PAGES * PS


@pytest.fixture(autouse=True)
def _flags():
    yield
    tflags._SET.pop("FLAGS_cuda_step_session", None)
    tflags._SET.pop("FLAGS_cuda_double_buffer", None)


# ==========================================================================
# the KV write: the formulation this PR replaced, kept as the oracle
# ==========================================================================
def _old_quant_scatter_(pool, scales, new, slots):
    if slots.numel() == 0:
        return
    n_kv, n_pages, page_size, d = pool.shape
    pages = slots // page_size
    touched, inverse = torch.unique(pages, sorted=True, return_inverse=True)
    keep = torch.ones(touched.shape, dtype=torch.float32)
    keep.index_fill_(0, inverse[slots % page_size == 0], 0.0)
    old_eff = scales[:, touched] * keep
    new_abs = new.abs().amax(dim=2)
    page_max = torch.zeros_like(old_eff).scatter_reduce_(
        1, inverse[None, :].expand(n_kv, -1), new_abs, reduce="amax")
    new_scales = torch.maximum(old_eff, page_max)
    pos = new_scales > 0
    ratio = torch.where(pos, old_eff / torch.where(pos, new_scales, 1.0),
                        1.0)
    old_pages = pool[:, touched].float()
    pool[:, touched] = torch.round(
        old_pages * ratio[..., None, None]).to(pool.dtype)
    scales[:, touched] = new_scales
    slot_scale = new_scales[:, inverse]
    denom = torch.where(slot_scale > 0, slot_scale, 1.0)
    q = torch.clamp(torch.round(new / denom[..., None] * tpo.INT8_QMAX),
                    -tpo.INT8_QMAX, tpo.INT8_QMAX).to(pool.dtype)
    pool.view(n_kv, n_pages * page_size, d).index_copy_(1, slots, q)


def _old_append(k, v, slot_mapping, k_pool, v_pool, k_scale=None,
                v_scale=None):
    n_kv, n_pages, page_size, d = k_pool.shape
    rows = torch.nonzero(slot_mapping < n_pages * page_size).squeeze(1)
    slots = slot_mapping[rows].long()
    if k_scale is not None:
        for pool, sc, new in ((k_pool, k_scale, k), (v_pool, v_scale, v)):
            _old_quant_scatter_(pool, sc, new[rows].float().transpose(0, 1),
                                slots)
        return
    for pool, new in ((k_pool, k), (v_pool, v)):
        flat = pool.view(n_kv, n_pages * page_size, d)
        flat.index_copy_(1, slots, new[rows].to(pool.dtype).transpose(0, 1))


def _jax_append(k, v, slots, pools):
    ins = {"K": [jnp.asarray(k)], "V": [jnp.asarray(v)],
           "SlotMapping": [jnp.asarray(slots)]}
    arity = {"KCacheOut": 1, "VCacheOut": 1}
    if pools[0].dtype == torch.bfloat16:
        jp = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
              for a in pools]
    else:
        jp = [jnp.asarray(a.numpy()) for a in pools]
    ins["KCache"], ins["VCache"] = [jp[0]], [jp[1]]
    if len(pools) == 4:
        ins["KScale"], ins["VScale"] = [jp[2]], [jp[3]]
        arity.update(KScaleOut=1, VScaleOut=1)
    outs = eager_call("kv_cache_append", ins, {}, arity)
    return [np.asarray(outs[n][0]) for n in arity]


def _bits(t):
    """A torch tensor's bytes (bf16 included) as a numpy uint8 array."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().view(np.uint8)


def _jax_bits(a, like):
    if like.dtype == torch.bfloat16:
        a = np.asarray(jnp.asarray(a).view(jnp.int16))
    return np.asarray(a).view(np.uint8)


def _pools(rng, dtype):
    """(k_pool, v_pool[, k_scale, v_scale]) of a seeded state; for int8
    page 3 is never written (scale 0, codes 0)."""
    if dtype == "int8":
        out = []
        for _ in range(2):
            out.append(torch.from_numpy(rng.randint(
                -127, 128, (N_KV, N_PAGES, PS, D)).astype(np.int8)))
        for _ in range(2):
            s = (np.abs(rng.randn(N_KV, N_PAGES)) + 0.5).astype(np.float32)
            s[:, 3] = 0.0
            out.append(torch.from_numpy(s))
        out[0][:, 3] = 0
        out[1][:, 3] = 0
        return out
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return [torch.from_numpy(rng.randn(N_KV, N_PAGES, PS, D).astype(
        np.float32)).to(tdt) for _ in range(2)]


SCENARIOS = {
    "pads-between": [5, PAD, 6, PAD, 12],
    "pads-first": [PAD, PAD, 1, 2],
    "pads-last": [9, 10, PAD],
    # several rows of one page, and two pages each written twice
    "duplicate-pages": [8, 9, 10, 11, PAD, 2, 3],
    # writes at page offset 0 open (recycle) their pages
    "page-opens": [0, 4, 8, PAD],
    # the pool's last slot, which an all-pad step writes back to itself
    "last-slot": [15, PAD],
    "all-pads": [PAD, PAD, PAD, PAD],
    "one-row": [7],
}


def _one_write(dtype, slots, rng, scale=2.0):
    pools = _pools(rng, dtype)
    k = torch.from_numpy((rng.randn(len(slots), N_KV, D) * scale).astype(
        np.float32))
    v = torch.from_numpy((rng.randn(len(slots), N_KV, D) * scale).astype(
        np.float32))
    sm = torch.from_numpy(np.asarray(slots, np.int32))
    return pools, k, v, sm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_static_kv_write_matches_jax_and_the_old_write(dtype, name):
    rng = np.random.RandomState(sorted(SCENARIOS).index(name))
    pools, k, v, sm = _one_write(dtype, SCENARIOS[name], rng)
    want = _jax_append(k.numpy(), v.numpy(), sm.numpy(), pools)
    old = [p.clone() for p in pools]
    _old_append(k, v, sm, *old)
    new = [p.clone() for p in pools]
    ptrs = [p.data_ptr() for p in new]
    assert tpo.kv_cache_append(k, v, sm, *new) is None
    assert [p.data_ptr() for p in new] == ptrs            # in place
    for got, o, w in zip(new, old, want):
        np.testing.assert_array_equal(_bits(got), _bits(o))
        np.testing.assert_array_equal(_bits(got), _jax_bits(w, got))
    if name == "all-pads":
        for got, p in zip(new, pools):
            np.testing.assert_array_equal(_bits(got), _bits(p))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", sorted(n for n, v in SCENARIOS.items()
                                        if v[0] != PAD))
def test_kv_write_with_a_known_live_row(dtype, name):
    """The serving forms' plan (``live_row=0``: row 0 always writes a
    token) writes what the general plan writes, bit for bit."""
    rng = np.random.RandomState(sorted(SCENARIOS).index(name))
    pools, k, v, sm = _one_write(dtype, SCENARIOS[name], rng)
    old = [p.clone() for p in pools]
    _old_append(k, v, sm, *old)
    new = [p.clone() for p in pools]
    plan = tpo.write_plan(sm, PAD, PS, dtype == "int8", live_row=0)
    assert plan.live is None
    tpo.scatter_rows(new[0], new[1], k, v, plan,
                     None if dtype != "int8" else (new[2], new[3]))
    for got, o in zip(new, old):
        np.testing.assert_array_equal(_bits(got), _bits(o))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("seed", range(3))
def test_static_kv_write_multi_step_sequences(dtype, seed):
    """25 steps from one seeded state: each step a random set of distinct
    live slots with pad sentinels mixed in (sometimes nothing else), the
    three writes carried on side by side."""
    rng = np.random.RandomState(50 + seed)
    pools = _pools(rng, dtype)
    old = [p.clone() for p in pools]
    new = [p.clone() for p in pools]
    jax_state = pools
    for _ in range(25):
        n_live = rng.randint(0, 6)
        live = rng.choice(PAD, size=n_live, replace=False).tolist()
        slots = live + [PAD] * rng.randint(0, 3)
        if not slots:
            slots = [PAD]
        rng.shuffle(slots)
        k = torch.from_numpy((rng.randn(len(slots), N_KV, D)
                              * rng.choice([0.1, 1.0, 5.0])).astype(
                                  np.float32))
        v = torch.from_numpy(rng.randn(len(slots), N_KV, D).astype(
            np.float32))
        sm = torch.from_numpy(np.asarray(slots, np.int32))
        want = _jax_append(k.numpy(), v.numpy(), sm.numpy(), jax_state)
        _old_append(k, v, sm, *old)
        tpo.kv_cache_append(k, v, sm, *new)
        for got, o, w in zip(new, old, want):
            np.testing.assert_array_equal(_bits(got), _bits(o))
            np.testing.assert_array_equal(_bits(got), _jax_bits(w, got))
        jax_state = [p.clone() for p in new]


def test_write_plan_drops_pads_without_data_dependent_shapes():
    sm = torch.tensor([PAD, 5, PAD, 9], dtype=torch.int32)
    plan = tpo.write_plan(sm, PAD, PS, quantized=True)
    assert all(t.shape == (4,) for t in plan[:5])
    # pad rows write the first live row's value at its slot
    assert plan.src.tolist() == [1, 1, 1, 3]
    assert plan.slot.tolist() == [5, 5, 5, 9]
    assert plan.live.tolist() == [True] * 4
    assert plan.page.tolist() == plan.scale_page.tolist() == [1, 1, 1, 2]
    assert plan.keep.tolist() == [1.0] * 4
    empty = tpo.write_plan(torch.full((3,), PAD, dtype=torch.int32), PAD,
                           PS, quantized=True)
    assert empty.slot.tolist() == [PAD - 1] * 3       # inside the pool
    assert empty.live.tolist() == [False] * 3
    assert empty.scale_page.tolist() == [N_PAGES] * 3   # the scales' sink
    assert empty.keep.tolist() == [1.0] * 3             # nothing opened
    # a write at offset 0 opens its page for every row of the page
    opened = tpo.write_plan(torch.tensor([4, PAD, 5, 9]), PAD, PS,
                            quantized=True)
    assert opened.keep.tolist() == [0.0, 0.0, 0.0, 1.0]
    assert tpo.write_plan(sm, PAD, PS).page is None     # f32 / bf16 pools


@pytest.mark.parametrize("name", sorted(n for n, v in SCENARIOS.items()
                                        if v[0] != PAD))
def test_int8_write_over_a_host_page_list(name):
    """The prefill and chunk forms' int8 write, which requantizes each
    page of a host-built list once (``touched``), writes what the
    per-row write and the old write do, bit for bit; a listed page that
    no row writes, and a page listed twice, keep their bits."""
    rng = np.random.RandomState(sorted(SCENARIOS).index(name))
    slots = SCENARIOS[name]
    pools, k, v, sm = _one_write("int8", slots, rng)
    old = [p.clone() for p in pools]
    _old_append(k, v, sm, *old)
    pages = sorted({s // PS for s in slots if s < PAD})
    spare = [p for p in range(N_PAGES) if p not in pages][0]
    touched = torch.tensor(pages + [spare, pages[0]], dtype=torch.int32)
    plan = tpo.write_plan(sm, PAD, PS, True, live_row=0, touched=touched)
    assert plan.touched.shape == (len(pages) + 2,)
    new = [p.clone() for p in pools]
    tpo.scatter_rows(new[0], new[1], k, v, plan, (new[2], new[3]))
    for got, o in zip(new, old):
        np.testing.assert_array_equal(_bits(got), _bits(o))


@pytest.mark.parametrize("S,first_offset", [(8, 0), (8, 3), (16, 15),
                                            (2, 3), (64, 1)])
def test_touched_pages_has_one_length_per_bucket(S, first_offset):
    """``touched_pages``: every page a slice's slots fall in, once, then
    the first page repeated, at ``ceil(S / page_size) + 1`` entries for
    any slice of at most S tokens."""
    rng = np.random.RandomState(S + first_offset)
    perm = rng.permutation(64)
    for n in (1, S // 2 + 1, S):
        logical = first_offset + np.arange(n)
        slots = perm[logical // PS] * PS + logical % PS
        got = T.touched_pages(slots.tolist(), S, PS)
        assert got.dtype == np.int32 and got.shape == (-(-S // PS) + 1,)
        want = np.unique(slots // PS)
        np.testing.assert_array_equal(got[:want.size], want)
        assert (got[want.size:] == want[0]).all()


# ==========================================================================
# launches recorded in a capture count at each replay; dead scopes'
# sessions go
# ==========================================================================
class _FakeLib:
    def paddle_fake(self, *args):
        return 0


class _FakeKernel:
    functions = {"paddle_fake": []}
    source = "fake.cu"

    def load(self):
        return _FakeLib()


class _FakeGraph:
    replays = 0

    def replay(self):
        self.replays += 1


def test_a_replay_counts_the_launches_its_capture_recorded():
    from paddle_tpu_torch.framework.cuda_graph import CapturedStep
    from paddle_tpu_torch.kernel_build import (KernelFunction,
                                               recorded_launches)

    a = KernelFunction(_FakeKernel(), "paddle_fake", "a")
    b = KernelFunction(_FakeKernel(), "paddle_fake", "b")
    a()
    assert a.launches == 1                 # an eager call launches
    with recorded_launches() as tally:     # a capture records only
        for _ in range(3):
            a()
        b()
        with recorded_launches() as inner:
            b()
        assert inner == {b: 1}
    assert (a.launches, b.launches) == (1, 0)
    assert tally == {a: 3, b: 1}
    step = CapturedStep(_FakeGraph(), tally)
    for _ in range(2):
        step.replay()
    assert step.graph.replays == 2
    assert (a.launches, b.launches) == (7, 2)
    a()
    assert a.launches == 8                 # recording ended


def test_a_dead_scopes_step_session_leaves_the_executor():
    import gc

    from paddle_tpu_torch.executor import _forget_session, _StepSession

    sessions = {}
    scope = Scope()
    key = ("plan", id(scope))
    sessions[key] = _StepSession(scope, _forget_session(sessions, key))
    other = Scope()
    okey = ("plan", id(other))
    sessions[okey] = _StepSession(other, _forget_session(sessions, okey))
    del scope
    gc.collect()
    assert list(sessions) == [okey]
    # a newer session under the same key is not the dead one's to drop
    third = Scope()
    stale = _StepSession(third, _forget_session(sessions, okey))
    sessions[okey] = _StepSession(other, _forget_session(sessions, okey))
    del third, stale
    gc.collect()
    assert list(sessions) == [okey]


# ==========================================================================
# the scope's write stamp
# ==========================================================================
def _stamp():
    return Scope.mutation_counter


def test_scope_writes_bump_the_stamp():
    s = Scope()
    kid = s.new_scope()
    t = _stamp()
    s.var("a")
    assert _stamp() == t + 1              # a new name
    s.var("a")
    assert _stamp() == t + 1              # an existing name: no write
    s.set("a", 1)
    assert _stamp() == t + 2
    kid.set("a", 2)                       # through the parent chain
    assert _stamp() == t + 3 and s.get("a") == 2
    s.find_var("a").set(3)                # a slot's set
    assert _stamp() == t + 4
    s.get("a"), s.has("a"), s.find_var("a"), list(s.items())
    assert _stamp() == t + 4              # reads leave it
    load_numpy_state(s, {"b": np.ones(2, np.float32)}, device="cpu")
    assert _stamp() == t + 5
    s.erase(["a"])
    assert _stamp() == t + 6


def _tiny_program(dropout=False, keep=False):
    """A 2-layer classifier with Momentum; ``keep``: its hidden layer is
    also written, scaled, into the persistable var ``keep``, which no op
    reads (so the scope holds no value for it before the first run)."""
    with unique_name.guard():
        main, start = fluid.Program(), fluid.Program()
        main.random_seed = start.random_seed = 3
        with fluid.program_guard(main, start):
            x = fluid.layers.data("x", [6])
            label = fluid.layers.data("label", [1], dtype="int64")
            h = fluid.layers.fc(x, 8, act="relu")
            if keep:
                blk = main.global_block()
                blk.create_var(name="keep", shape=(-1, 8), dtype="float32",
                               persistable=True)
                blk.append_op("scale", inputs={"X": [h]},
                              outputs={"Out": ["keep"]},
                              attrs={"scale": 2.0, "bias": 0.0,
                                     "bias_after_scale": True})
            if dropout:
                h = fluid.layers.dropout(h, 0.25)
            logits = fluid.layers.fc(h, 3)
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(logits, label))
            fluid.optimizer.MomentumOptimizer(0.1, 0.9).minimize(loss)
    return main, start, loss


def _feed(seed=0, n=4):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, 6).astype(np.float32),
            "label": rng.randint(0, 3, (n, 1)).astype(np.int64)}


def test_in_place_writeback_leaves_the_stamp_a_replacement_bumps_it():
    main, start, loss = _tiny_program(keep=True)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = Scope()
    exe.run(start, scope=scope)
    assert not scope.has("keep")
    t = _stamp()
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    assert _stamp() > t                   # "keep" was bound: a set
    w = next(n for n in scope.local_var_names() if n.endswith(".w_0"))
    before = {n: scope.get(n) for n in ("keep", w)}
    t = _stamp()
    for i in range(3):                    # parameters, velocities, keep
        exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
    assert _stamp() == t                  # ... written in place
    assert all(scope.get(n) is v for n, v in before.items())
    # a value that no longer fits (another batch size) is rebound: a set
    exe.run(main, feed=_feed(0, n=6), fetch_list=[loss], scope=scope)
    assert _stamp() > t and scope.get("keep").shape == (6, 8)


def test_numpy_and_tensor_feeds_of_one_dtype_share_a_plan():
    """A host numpy batch and a tensor of the same dtype and shape are
    one feed signature (on the card: one graph); another dtype or shape
    is another."""
    main, start, loss = _tiny_program()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = Scope()
    exe.run(start, scope=scope)
    feed = _feed()
    outs = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
            for f in (feed, {k: torch.from_numpy(v) for k, v in feed.items()})]
    assert len(exe._cache) == 2           # the startup program's and one
    assert np.isfinite(outs[1]).all()
    exe.run(main, feed=dict(feed, x=feed["x"].astype(np.float64)),
            fetch_list=[loss], scope=scope)
    exe.run(main, feed=_feed(0, n=6), fetch_list=[loss], scope=scope)
    assert len(exe._cache) == 4


# ==========================================================================
# the flags
# ==========================================================================
def test_step_session_flag_resolution():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tflags.get_flag("FLAGS_cuda_step_session") == "auto"
    assert not cuda_step_session_enabled(cpu)
    assert cuda_step_session_enabled(cuda)
    tflags.set_flags({"FLAGS_cuda_step_session": "0"})
    assert not cuda_step_session_enabled(cuda)
    assert not cuda_step_session_enabled(cpu)
    tflags.set_flags({"FLAGS_cuda_step_session": "1"})
    assert cuda_step_session_enabled(cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_step_session_enabled(cpu)
    assert tflags.flag_bool("FLAGS_cuda_double_buffer")


def test_forced_session_on_a_cpu_executor_raises():
    main, start, loss = _tiny_program()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = Scope()
    exe.run(start, scope=scope)
    tflags.set_flags({"FLAGS_cuda_step_session": "1"})
    with pytest.raises(ValueError, match="FLAGS_cuda_step_session"):
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)


def test_forced_session_on_a_cpu_engine_raises():
    cfg = T.DecoderConfig(vocab_size=32, hidden=16, num_heads=2,
                          num_layers=1, max_seq_len=64)
    eng = T.ServingEngine(cfg, T.init_decoder_weights(cfg, 0), num_pages=8,
                          page_size=4, device="cpu")
    tflags.set_flags({"FLAGS_cuda_step_session": "1"})
    with pytest.raises(ValueError, match="FLAGS_cuda_step_session"):
        eng.generate([[1, 2, 3]], max_new_tokens=3)


@pytest.mark.parametrize("dropout", [False, True])
def test_cpu_steps_are_the_same_under_every_session_value(dropout):
    """On the CPU the flag's "auto" and "0" both run the eager path: the
    same losses and state, bit for bit (dropout's masks too)."""
    runs = []
    for value in ("auto", "0"):
        tflags.set_flags({"FLAGS_cuda_step_session": value})
        main, start, loss = _tiny_program(dropout)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = Scope()
        exe.run(start, scope=scope)
        losses = [exe.run(main, feed=_feed(i), fetch_list=[loss],
                          scope=scope)[0] for i in range(3)]
        state = {n: scope.get(n).numpy().copy()
                 for n in sorted(scope.local_var_names())
                 if isinstance(scope.get(n), torch.Tensor)}
        runs.append((losses, state))
    (l0, s0), (l1, s1) = runs
    for a, b in zip(l0, l1):
        np.testing.assert_array_equal(a, b)
    assert s0.keys() == s1.keys()
    for n in s0:
        np.testing.assert_array_equal(s0[n], s1[n], err_msg=n)


# ==========================================================================
# feed staging
# ==========================================================================
def _batches(n=5):
    rng = np.random.RandomState(11)
    return [{"x": rng.randn(4, 6),            # float64: cast to f32
             "label": rng.randint(0, 3, (4, 1))} for _ in range(n)]


@pytest.mark.parametrize("double_buffer", [True, False])
def test_staged_feeds_equal_the_executors_conversion(double_buffer):
    main, start, loss = _tiny_program()
    tflags.set_flags({"FLAGS_cuda_double_buffer": double_buffer})
    stager = FeedStager(main, ["x", "label"], fluid.CPUPlace())
    staged = list(double_buffered_feeds(_batches(), stager))
    assert len(staged) == 5
    for got, raw in zip(staged, _batches()):
        assert isinstance(got, StagedFeed) and got.ready is None
        assert got["x"].dtype == torch.float32
        assert got["label"].dtype == torch.int64
        np.testing.assert_array_equal(
            got["x"].numpy(), torch.from_numpy(raw["x"]).float().numpy())
        np.testing.assert_array_equal(got["label"].numpy(), raw["label"])


def test_double_buffer_on_and_off_stage_identical_values_and_steps():
    main, start, loss = _tiny_program()
    runs = []
    for double_buffer in (True, False):
        tflags.set_flags({"FLAGS_cuda_double_buffer": double_buffer})
        exe = fluid.Executor(fluid.CPUPlace())
        scope = Scope()
        exe.run(start, scope=scope)
        stager = FeedStager(main, ["x", "label"], fluid.CPUPlace())
        runs.append([exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
                     for f in double_buffered_feeds(_batches(), stager)])
    # and the same steps from the raw feeds
    exe = fluid.Executor(fluid.CPUPlace())
    scope = Scope()
    exe.run(start, scope=scope)
    runs.append([exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
                 for f in _batches()])
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("double_buffer", [True, False])
def test_a_staging_error_surfaces_at_its_batch(double_buffer):
    main, start, loss = _tiny_program()
    tflags.set_flags({"FLAGS_cuda_double_buffer": double_buffer})
    feeds = _batches(4)
    feeds[2] = {"x": np.array([["not", "a", "number"]]),
                "label": feeds[2]["label"]}
    stager = FeedStager(main, ["x", "label"], fluid.CPUPlace())
    got = []
    with pytest.raises(TypeError):
        for f in double_buffered_feeds(feeds, stager):
            got.append(f)
    assert len(got) == 2                  # batches 0 and 1 came out


def test_the_global_scope_guard_still_routes_runs():
    """The stamp changes nothing of how a run finds its scope."""
    main, start, loss = _tiny_program()
    scope = Scope()
    with scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(start)
        out = exe.run(main, feed=_feed(), fetch_list=[loss])
    assert np.isfinite(out[0]).all()


def test_step_capture_tool_reads_the_rate_from_the_built_program():
    """``tools/check_step_capture.py`` fetches MobileNet's rate var, which
    it finds on the ``momentum`` ops of the program as built; the
    executor's plan has one ``fused_momentum`` reading that var."""
    from paddle_tpu_torch.tools import check_step_capture as csc

    main, startup, fetch, feed = csc._build(csc.STATIC_CASES[
        "mobilenet-bf16"])
    rate = fetch[2]
    assert {o.input("LearningRate")[0] for o in main.global_block().ops
            if o.type == "momentum"} == {rate}
    exe, scope = fluid.Executor(fluid.CPUPlace()), Scope()
    exe.run(startup, scope=scope)
    out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    assert 0 < float(out[2][0]) <= csc.MOBILENET_RECIPE["lr"]
    plan = next(p for k, p in exe._cache.items() if k[0] == main._uid)
    fused = [o for o in plan.ops if o.type == "fused_momentum"]
    assert [o.input("LearningRate") for o in fused] == [[rate]]
    assert "momentum" not in [o.type for o in plan.ops]
