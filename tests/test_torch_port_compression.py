"""The port's compression stack and push_pull against the JAX package.

The same gradients give the same onebit payload and EF/momentum state
(bit-identical words; the L1-mean scale and the float state to a stated
ulp bound against the eager JAX stack, and bit for bit against the
jitted one, whose FMAs and summation order the port reproduces). The
collective paths run over gloo groups of one rank, or of two spawned
ranks, on a FileStore in the test's temporary directory, so parallel
workers never share a port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import byteps_tpu_torch as bps
from byteps_tpu.ops.compression import make_compressor as j_make
from byteps_tpu.ops.compression.codecs import OnebitCodec as JOnebit
from byteps_tpu.ops.compression.feedback import CompressorStack as JStack
from byteps_tpu_torch.ops import push_pull as tpp
from byteps_tpu_torch.ops.compression import kernels as K
from byteps_tpu_torch.ops.compression import (
    CompressionTransform, compressed_psum_tree, default_stacks,
    make_compressor,
)


@pytest.fixture()
def group(tmp_path):
    bps.init(device="cpu", store=dist.FileStore(str(tmp_path / "store"), 1),
             rank=0, world_size=1)
    try:
        yield bps.get_state().group
    finally:
        bps.shutdown()


def test_registry_onebit_and_not_yet_ported():
    st = make_compressor({"compressor": "onebit", "ef": "vanilla",
                          "momentum": "nesterov"}, 100)
    assert st.use_ef and st.momentum_mu == 0.9 and st.codec.scaled
    # lossless is a host (PS) tier codec only, as in the JAX package
    with pytest.raises(ValueError, match="unknown compressor"):
        make_compressor({"compressor": "lossless"}, 100)
    rk = make_compressor({"compressor": "randomk", "k": "0.1",
                          "seed": "3"}, 100).codec
    assert (rk.k, rk.seed) == (10, 3)
    dt = make_compressor({"compressor": "dithering", "k": "15",
                          "partition_type": "natural"}, 100).codec
    assert (dt.s, dt.partition, dt.normalize) == (15, "natural", "max")
    with pytest.raises(ValueError, match="unknown compressor"):
        make_compressor({"compressor": "nope"}, 100)
    with pytest.raises(ValueError, match="momentum requires ef"):
        make_compressor({"compressor": "onebit", "momentum": "nesterov"}, 10)
    with pytest.raises(ValueError, match="unknown ef"):
        make_compressor({"compressor": "onebit", "ef": "vanila"}, 10)


def test_min_compress_bytes_threshold():
    params = [torch.zeros(1000), torch.zeros(10)]
    stacks = default_stacks(params, {"compressor": "onebit"},
                            min_compress_bytes=1024)
    assert stacks[0] is not None and stacks[1] is None


@pytest.mark.parametrize("kwargs", [
    {"compressor": "onebit", "ef": "vanilla"},
    {"compressor": "onebit", "ef": "vanilla", "momentum": "nesterov"},
    {"compressor": "onebit", "scaling": "false"},
])
def test_stack_payload_and_state_match_jax(kwargs):
    """Three rounds with an LR schedule (the EF prev_lr rescale): the
    words are bit-identical and the state agrees to 4 ulps of its scale."""
    n = 5003
    jst, tst = j_make(kwargs, n), make_compressor(kwargs, n)
    assert isinstance(jst, JStack)
    jst = JStack(codec=JOnebit(size=n, scaled=jst.codec.scaled,
                               use_pallas=False),
                 use_ef=jst.use_ef, momentum_mu=jst.momentum_mu)
    jstate, tstate = jst.init_state(n), tst.init_state(n)
    rng = np.random.RandomState(0)
    for step, lr in enumerate((0.1, 0.05, 0.05)):
        g = rng.randn(n).astype(np.float32)
        jp, jstate = jst.compress(jnp.asarray(g), jstate, step, lr=lr)
        tp, tstate = tst.compress(torch.from_numpy(g), tstate, step, lr=lr)
        np.testing.assert_array_equal(tp["bits"].numpy().view(np.uint32),
                                      np.asarray(jp["bits"]))
        np.testing.assert_allclose(tp["scale"].numpy(),
                                   np.asarray(jp["scale"]), rtol=2e-7)
        assert set(tstate) == set(jstate)
        for key in jstate:
            want = np.asarray(jstate[key])
            ulp = 4 * np.spacing(np.float32(np.abs(want).max() + 1e-30))
            np.testing.assert_allclose(tstate[key].numpy(), want, rtol=0,
                                       atol=ulp, err_msg=key)
        np.testing.assert_allclose(tst.decompress(tp).numpy(),
                                   np.asarray(jst.decompress(jp)),
                                   rtol=2e-7)


# the jitted JAX stack is the reference (XLA contracts the momentum and
# the EF rescale into FMAs and sums in its own tree order); LR ratios 2
# and 0.6, the second not a power of two
JIT_STACK_KWS = [
    {"compressor": "randomk", "k": "0.05", "ef": "vanilla",
     "momentum": "nesterov", "seed": "6"},
    {"compressor": "dithering", "ef": "vanilla", "momentum": "nesterov",
     "seed": "4"},
    {"compressor": "dithering", "ef": "vanilla", "normalize_type": "l2",
     "seed": "2"},
    {"compressor": "randomk", "k": "0.05", "ef": "vanilla", "seed": "3"},
    {"compressor": "onebit", "ef": "vanilla", "momentum": "nesterov"},
    {"compressor": "topk", "k": "0.05", "ef": "vanilla"},
    {"compressor": "topk", "k": "0.05", "ef": "vanilla",
     "momentum": "nesterov"},
]


@pytest.mark.parametrize("kwargs", JIT_STACK_KWS, ids=[
    "randomk-momentum", "dithering-momentum", "dithering-l2", "randomk",
    "onebit-momentum", "topk", "topk-momentum"])
def test_stack_matches_the_jitted_jax_stack_bit_for_bit(kwargs):
    """Three rounds, mu = 0.9, LRs 0.1 -> 0.05 -> 0.03: payload, momentum,
    EF residual and prev_lr equal the jitted JAX stack's bit for bit."""
    import jax
    n = 4096
    jst, tst = j_make(kwargs, n), make_compressor(kwargs, n)
    jstate, tstate = jst.init_state(n), tst.init_state(n)
    rng = np.random.RandomState(7)
    for step, lr in enumerate((0.1, 0.05, 0.03)):
        g = rng.randn(n).astype(np.float32)
        jp, jstate = jax.jit(
            lambda v, st, lr, step=step: jst.compress(v, st, step, lr=lr))(
            jnp.asarray(g), jstate, jnp.float32(lr))
        tp, tstate = tst.compress(torch.from_numpy(g), tstate, step, lr=lr)
        assert set(tp) == set(jp) and set(tstate) == set(jstate)
        for key in jp:
            want = np.asarray(jp[key])
            got = tp[key].numpy()
            if key == "bits":
                got = got.view(np.uint32)
            np.testing.assert_array_equal(got, want, err_msg=f"{step} {key}")
        for key in jstate:
            np.testing.assert_array_equal(tstate[key].numpy(),
                                          np.asarray(jstate[key]),
                                          err_msg=f"{step} {key}")


@pytest.mark.parametrize("seed", range(3))
def test_xla_sum_and_mean_follow_the_jitted_jax_order(seed):
    """``kernels.xla_sum``/``xla_mean`` and the codecs' L2 norm and onebit
    scale equal jitted ``jnp.sum``/``jnp.mean`` bit for bit, n = 1 to
    24,576,000 (the Llama-125M embedding), over three seeds."""
    import jax
    from byteps_tpu.ops.compression.codecs import DitheringCodec as JDither
    from byteps_tpu_torch.ops.compression.codecs import (
        DitheringCodec, OnebitCodec,
    )
    jsum = jax.jit(jnp.sum)
    jmean = jax.jit(lambda v: jnp.mean(jnp.abs(v)))
    sizes = [1, 5, 31, 32, 33, 257, 1025, 4099, 65537]
    if seed == 0:
        sizes += [1_000_003, 24_576_000]
    for n in sizes:
        rs = np.random.default_rng(seed * 7919 + n)
        x = (rs.standard_normal(n) * 10.0 ** (seed - 1)).astype(np.float32)
        t = torch.from_numpy(x)
        assert K.xla_sum(t).item() == np.float32(jsum(x)), n
        assert K.xla_mean(t.abs()).item() == np.float32(jmean(x)), n
        assert OnebitCodec(size=n).compress(t)["scale"].item() == \
            np.float32(jmean(x)), n
        if n > 70_000:
            continue
        jn = jax.jit(lambda v, n=n: JDither(
            size=n, normalize="l2", use_pallas=False).compress(v)["norm"])
        tn = DitheringCodec(size=n, normalize="l2").norm(t)
        assert tn.item() == np.float32(jn(x)), n


# n = 1..32 is one window; 33, 32,769 and 100,003 pad level 1 on the left
# (and 32,769 and 100,003 level 2), 32,000 pads level 2 alone and 32,758
# level 1 alone; 1,025 is the first length with two level-2 windows
XLA_SUM_LENGTHS = [1, 31, 32, 33, 1025, 32_000, 32_758, 32_769, 100_003]


@pytest.mark.parametrize("n", XLA_SUM_LENGTHS)
def test_xla_sum_modes_follow_the_jitted_jax_sums(n):
    """``xla_sum`` with ``absolute`` and ``square`` (|x| and x * x taken
    as the sum reads x), and ``xla_mean`` with ``absolute``, equal jitted
    ``jnp.sum(jnp.abs(x))``, ``jnp.sum(jnp.square(x))`` and
    ``jnp.mean(jnp.abs(x))`` bit for bit, the plain twin and the wrapper
    alike; so do the onebit scale and the L2 norm against the JAX
    codecs."""
    import jax
    from byteps_tpu.ops.compression.codecs import DitheringCodec as JDither
    from byteps_tpu_torch.ops.compression.codecs import (
        DitheringCodec, OnebitCodec,
    )
    jabs = jax.jit(lambda v: jnp.sum(jnp.abs(v)))
    jsq = jax.jit(lambda v: jnp.sum(jnp.square(v)))
    jmean = jax.jit(lambda v: jnp.mean(jnp.abs(v)))
    jscale = jax.jit(lambda v: JOnebit(size=n).compress(v)["scale"])
    jnorm = jax.jit(lambda v: JDither(size=n, normalize="l2",
                                      use_pallas=False).compress(v)["norm"])
    for k in range(3):
        rs = np.random.default_rng(n * 3 + k)
        x = (rs.standard_normal(n) * 10.0 ** (2 * k - 2)).astype(np.float32)
        t = torch.from_numpy(x)
        want_abs, want_sq, want_mean = (np.float32(f(x))
                                        for f in (jabs, jsq, jmean))
        for f in (K.xla_sum_plain, K.xla_sum):
            assert f(t, absolute=True).item() == want_abs, (n, k)
            assert f(t, square=True).item() == want_sq, (n, k)
            assert f(t, square=True, absolute=True).item() == want_sq, (n, k)
        assert K.xla_mean(t, absolute=True).item() == want_mean, (n, k)
        assert OnebitCodec(size=n).compress(t)["scale"].item() == \
            np.float32(jscale(x)), (n, k)
        assert DitheringCodec(size=n, normalize="l2").norm(t).item() == \
            np.float32(jnorm(x)), (n, k)


def test_onebit_scale_takes_abs_inside_the_sum(monkeypatch):
    """``OnebitCodec.compress`` hands x itself to ``xla_mean`` with
    ``absolute``, so no |x| tensor is built before the sum."""
    from byteps_tpu_torch.ops.compression import codecs
    seen = []

    def spy(x, absolute=False):
        seen.append((x, absolute))
        return K.xla_mean(x, absolute=absolute)

    monkeypatch.setattr(codecs, "xla_mean", spy)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100).astype(np.float32))
    codecs.OnebitCodec(size=100).compress(x)
    assert len(seen) == 1 and seen[0][0] is x and seen[0][1] is True


@pytest.mark.parametrize("n", [1, 2, 3, 8, 32, 33, 100])
def test_rank_sum_follows_the_jitted_jax_order(n):
    """``rank_sum`` of n ranks' vectors equals jitted ``jnp.sum`` over
    the gathered axis bit for bit, signed zeros included (XLA's CPU
    backend folds up to 32 in order, and goes through windows of 32
    above)."""
    import jax
    from byteps_tpu_torch.ops.compression import rank_sum
    rs = np.random.RandomState(n)
    d = (rs.randn(n, 301) * 10.0 ** rs.randint(-3, 3, (n, 1))
         ).astype(np.float32)
    d[:, :5] = -0.0
    want = np.asarray(jax.jit(lambda v: jnp.sum(v, axis=0))(d))
    got = rank_sum(list(torch.from_numpy(d))).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# the collective compressed push_pull of every ported codec
COLLECTIVE_KWS = [
    {"compressor": "onebit", "ef": "vanilla"},
    {"compressor": "randomk", "k": "0.05", "ef": "vanilla", "seed": "5"},
    {"compressor": "dithering", "ef": "vanilla", "seed": "3"},
    {"compressor": "topk", "k": "0.05", "ef": "vanilla"},
]
COLLECTIVE_IDS = ["onebit", "randomk", "dithering", "topk"]


@pytest.mark.parametrize("kw", COLLECTIVE_KWS, ids=COLLECTIVE_IDS)
def test_compressed_psum_tree_one_rank(group, kw):
    """Over one rank the reduction returns each leaf's own decompressed
    payload (compressed leaves) or the leaf itself (plain leaves)."""
    rng = np.random.RandomState(1)
    grads = [torch.from_numpy(rng.randn(40, 30).astype(np.float32)),
             torch.from_numpy(rng.randn(7).astype(np.float32))]
    stacks = default_stacks(grads, kw, min_compress_bytes=1024)
    states = [s.init_state(g.numel()) if s else {}
              for g, s in zip(grads, stacks)]
    out, new_states = compressed_psum_tree(grads, states, stacks, group)
    flat = grads[0].reshape(-1)
    if kw["compressor"] == "onebit":
        # the scale is the L1 mean in XLA's summation order (the JAX
        # codec's)
        want = torch.where(flat >= 0, 1.0, -1.0) * K.xla_mean(flat.abs())
        want_error = flat - want
    else:
        payload, st = stacks[0].compress(flat, states[0], 0)
        want, want_error = stacks[0].decompress(payload), st["error"]
    torch.testing.assert_close(out[0].reshape(-1), want, rtol=0, atol=0)
    torch.testing.assert_close(new_states[0]["error"], want_error,
                               rtol=0, atol=0)
    torch.testing.assert_close(out[1], grads[1], rtol=0, atol=0)

    tx = CompressionTransform(grads, kw, group=group, min_compress_bytes=0)
    r1 = tx.update(grads)
    r2 = tx.update(grads)
    assert tx.step == 2 and all(s is not None for s in tx.stacks)
    assert r1[0].shape == grads[0].shape and r2[1].shape == grads[1].shape


@pytest.mark.parametrize("kw", COLLECTIVE_KWS, ids=COLLECTIVE_IDS)
def test_two_ranks_match_jax_two_device_mesh(tmp_path, kw):
    """Two gloo ranks (spawned processes) against the JAX
    compressed_psum_tree on a two-device dp mesh: each rank's payload bit
    for bit, the same mean of the decompressed payloads, the same
    per-rank EF residual, and the truncating integer mean; plus eager
    push_pull and broadcast_parameters from rank 1."""
    import multiprocessing as mp

    import jax
    from jax.sharding import PartitionSpec as P

    from byteps_tpu.ops.compression import (
        compressed_psum_tree as j_cpt, default_stacks as j_stacks,
    )
    from byteps_tpu.parallel.mesh import make_mesh
    from byteps_tpu.ops.push_pull import psum_tree as j_psum

    import _torch_port_worker as W

    ctx = mp.get_context("spawn")
    store, outs = str(tmp_path / "store"), []
    procs = []
    for r in range(2):
        outs.append(str(tmp_path / f"rank{r}.npz"))
        procs.append(ctx.Process(target=W.run_rank,
                                 args=(r, 2, store, outs[r], kw)))
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    got = [np.load(o) for o in outs]

    per_rank = [W.grads_for(r) for r in range(2)]
    stacked = [np.stack([g[i] for g in per_rank]) for i in range(3)]
    stacks = j_stacks({"a": stacked[0][0], "b": stacked[1][0]}, kw,
                      min_compress_bytes=1024)

    def body(a, b, ints):
        grads = {"a": a[0], "b": b[0]}
        states = {"a": stacks["a"].init_state(a[0].size), "b": {}}
        out, new = j_cpt(grads, states, stacks, "dp", 0)
        return (out["a"][None], out["b"][None], new["a"]["error"][None],
                j_psum(ints[0], "dp")[None])

    mesh = make_mesh(devices=jax.devices()[:2])
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("dp"),) * 3,
                               out_specs=(P("dp"),) * 4, check_vma=False))
    want = [np.asarray(x) for x in fn(*stacked)]
    jst = stacks["a"]
    for r in range(2):
        jp, _ = jax.jit(lambda v: jst.compress(
            v, jst.init_state(v.size), 0))(per_rank[r][0].reshape(-1))
        for key, v in jp.items():
            tv = got[r]["payload_" + key]
            np.testing.assert_array_equal(
                tv.view(np.uint32) if key == "bits" else tv.reshape(
                    np.shape(v)), np.asarray(v), err_msg=f"rank {r} {key}")
        # the mean of two decompressed payloads; where the ranks differ
        # in sign the mean is a difference, so the bound is absolute: 4
        # ulps of the largest value
        for key, w in (("a", want[0][r]), ("error", want[2][r])):
            ulp4 = 4 * np.spacing(np.float32(np.abs(w).max()))
            np.testing.assert_allclose(got[r][key], w, rtol=0, atol=ulp4,
                                       err_msg=key)
        np.testing.assert_allclose(got[r]["b"], want[1][r], rtol=1e-6)
        np.testing.assert_array_equal(got[r]["ints"], want[3][r])
    np.testing.assert_array_equal(got[0]["ints"], [-3, 3, 5])
    for r in range(2):
        np.testing.assert_array_equal(got[r]["mean"], [0.5])
        np.testing.assert_array_equal(got[r]["bcast"], [1.0, 1.0, 1.0])


def test_push_pull_and_broadcast_one_rank(group):
    x = torch.arange(6, dtype=torch.float32)
    torch.testing.assert_close(bps.push_pull(x), x)
    torch.testing.assert_close(bps.broadcast(x, root_rank=0), x)
    tree = {"a": x, "b": [torch.tensor([3, -3], dtype=torch.int32)]}
    out = tpp.psum_tree(tree, average=True)
    torch.testing.assert_close(out["b"][0], tree["b"][0])
    assert bps.size() == 1 and bps.rank() == 0 and bps.local_size() == 1


def test_integer_average_truncates_toward_zero():
    """The truncating integer mean of push_pull.py:48-66 (reference
    torch/ops.cc:78-90): -3 / 2 is -1, not floor's -2."""
    t = torch.tensor([-3, 3, -1, 5], dtype=torch.int32)
    assert tpp._average_(t.clone(), 2).tolist() == [-1, 1, 0, 2]
    assert tpp._average_(torch.tensor([-3.0]), 2).tolist() == [-1.5]
