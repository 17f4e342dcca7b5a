"""The port's PyTorch adapter (``byteps_tpu_torch.torch``) against the JAX
package's (``byteps_tpu.torch``).

Each test runs a mixed fleet on one loopback server: worker 0 is
``byteps_tpu.torch``, worker 1 ``byteps_tpu_torch.torch``, both training
the same small ``nn.Module`` (an embedding, two linear layers) on their
own numpy-seeded batches, worker 1 from other weights. Both adapters are
torch, so the fleet must agree bit for bit:

- ``broadcast_parameters`` and ``broadcast_optimizer_state`` from worker
  0 make the weights and the optimizer's state equal;
- ``DistributedOptimizer`` (SGD + momentum with
  ``backward_passes_per_step=2``; Adam with ``Compression.fp16``; SGD on
  an ``nn.Embedding(sparse=True)``, whose gradient rides the row-sparse
  wire), ``DistributedDataParallel`` + ``sync_gradients()`` and
  ``CrossBarrier`` (SGD and Adam): both workers end with the same
  parameters, which are where plain local steps on the mean of the two
  workers' gradients leave them (bit for bit; fp16-rounded gradients
  for fp16); the JAX package's CrossBarrier writes Adam out and lands
  within 1e-6 of the port's;
- the async ops (``push_pull_async``, ``poll``, ``synchronize``,
  ``push_pull``, ``push_pull_inplace``, f32 and bf16) and
  ``broadcast_object`` from either worker.

Without servers the adapter is the identity; a ``dp`` group of more than
one process is refused.
"""

import concurrent.futures

import numpy as np
import pytest
import torch
from torch import nn

import byteps_tpu_torch.torch as tbps
from byteps_tpu_torch.torch.cross_barrier import CrossBarrier as TCrossBarrier
from _torch_port_ps_util import _free_port, _ps_env, bounded, ps_server
from test_torch_port_ps import jax_uses_port_lib, ps_lib  # noqa: F401

VOCAB, DIM, STEPS = 50, 8, 3


class Net(nn.Module):
    def __init__(self, sparse=False):
        super().__init__()
        self.emb = nn.Embedding(VOCAB, DIM, sparse=sparse)
        self.fc1 = nn.Linear(DIM, 16)
        self.fc2 = nn.Linear(16, 4)

    def forward(self, idx):
        h = self.emb(idx).mean(1)
        return self.fc2(torch.relu(self.fc1(h)))


def _net(seed, sparse=False):
    net = Net(sparse)
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(
                (0.3 * rs.randn(*p.shape)).astype(np.float32)))
    return net


def _batch(worker, step, k):
    rs = np.random.RandomState(1000 * worker + 10 * step + k)
    idx = torch.from_numpy(rs.randint(0, VOCAB, (6, 5)))
    y = torch.from_numpy(rs.randn(6, 4).astype(np.float32))
    return idx, y


def _loss(model, batch):
    idx, y = batch
    return ((model(idx) - y) ** 2).mean()


VARIANTS = {
    # name: (optimizer, compression, passes, sparse, ddp, cross barrier)
    "sgd_passes2": (lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
                    "none", 2, False, False, False),
    "adam_fp16": (lambda ps: torch.optim.Adam(ps, lr=1e-2), "fp16", 1,
                  False, False, False),
    "sparse_sgd": (lambda ps: torch.optim.SGD(ps, lr=0.1), "none", 1, True,
                   False, False),
    "ddp_adam": (lambda ps: torch.optim.Adam(ps, lr=1e-2), "none", 1, False,
                 True, False),
    "cb_sgd": (lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9), "none",
               1, False, False, True),
    "cb_adam": (lambda ps: torch.optim.Adam(ps, lr=1e-2), "none", 1, False,
                False, True),
}


def _train(A, CB, worker, variant):
    """``STEPS`` steps of ``variant`` through adapter module ``A`` (with
    its CrossBarrier ``CB``): the final parameters by name, and the
    learning rate after the broadcasts."""
    make_opt, comp, passes, sparse, ddp, cb = VARIANTS[variant]
    model = _net(worker, sparse)
    if ddp:
        model = A.DistributedDataParallel(model)
        opt = make_opt(model.parameters())
    else:
        A.broadcast_parameters(model.state_dict(), root_rank=0)
        base = make_opt(model.parameters())
        if worker == 1:
            base.param_groups[0]["lr"] *= 3    # the broadcast restores it
        opt = A.DistributedOptimizer(
            base, named_parameters=model.named_parameters(),
            compression=getattr(A.Compression, comp),
            backward_passes_per_step=passes)
        A.broadcast_optimizer_state(opt, root_rank=0)
    lr = opt.param_groups[0]["lr"]
    if cb:
        opt = CB(model, opt, num_steps=STEPS)
        opt.step()                      # step 0: no gradients yet
    for s in range(STEPS):
        opt.zero_grad()
        for k in range(passes):
            _loss(model, _batch(worker, s, k)).backward()
        if ddp:
            model.sync_gradients()
        opt.step()
    names = [n.replace("module.", "") for n, _ in model.named_parameters()]
    return {n: p.detach().clone() for n, (_, p)
            in zip(names, model.named_parameters())}, lr


def _local(variant):
    """Plain local steps from worker 0's weights on the mean of the two
    workers' gradients (each the mean of its passes)."""
    make_opt, comp, passes, sparse, _, cb = VARIANTS[variant]
    model = _net(0, sparse)
    opt = make_opt(model.parameters())
    for s in range(STEPS):
        grads = []
        for w in (0, 1):
            model.zero_grad(set_to_none=True)
            for k in range(passes):
                _loss(model, _batch(w, s, k)).backward()
            g = [p.grad.to_dense() if p.grad.is_sparse else p.grad
                 for p in model.parameters()]
            grads.append([x / passes if passes > 1 else x for x in g])
        for p, g0, g1 in zip(model.parameters(), *grads):
            if comp == "fp16":
                mean = ((g0.half().float() + g1.half().float()).half()
                        / 2).float()
            else:
                mean = (g0 + g1) / 2
            p.grad = mean
        opt.step()
    return {n: p.detach() for n, p in model.named_parameters()}


def _fleet(monkeypatch, jax_fn, port_fn, timeout=60):
    """Run ``jax_fn`` as worker 0 (byteps_tpu.torch) and ``port_fn`` as
    worker 1 (byteps_tpu_torch.torch) against one server, at once."""
    import jax

    import byteps_tpu as jbps
    from byteps_tpu.core.state import GlobalState
    from byteps_tpu.parallel.mesh import make_mesh

    with ps_server(num_workers=2) as port:
        _ps_env(monkeypatch, port, num_workers=2)
        monkeypatch.setenv("BYTEPS_LEDGER", "0")
        monkeypatch.setenv("DMLC_WORKER_ID", "0")
        GlobalState._instance = None
        jbps.init(mesh=make_mesh(devices=jax.devices()[:1]))
        monkeypatch.setenv("DMLC_WORKER_ID", "1")
        tbps.init(device="cpu")
        try:
            def both():
                with concurrent.futures.ThreadPoolExecutor(2) as pool:
                    fs = [pool.submit(jax_fn), pool.submit(port_fn)]
                    return [f.result() for f in fs]

            return bounded(both, timeout=timeout)
        finally:
            tbps.shutdown()
            jbps.shutdown()
            GlobalState._instance = None


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mixed_fleet_trains_alike(ps_lib, monkeypatch, jax_uses_port_lib,
                                  variant):
    import byteps_tpu.torch as jad
    from byteps_tpu.torch.cross_barrier import CrossBarrier as JCrossBarrier
    (j, j_lr), (t, t_lr) = _fleet(
        monkeypatch, lambda: _train(jad, JCrossBarrier, 0, variant),
        lambda: _train(tbps, TCrossBarrier, 1, variant))
    assert j_lr == t_lr
    local = _local(variant)
    for n in j:
        torch.testing.assert_close(t[n], local[n], rtol=0, atol=0, msg=n)
        # the JAX package's CrossBarrier writes Adam out (mul and add for
        # the first moment where torch lerps): a few ulps apart; the
        # port's steps torch's own Adam
        atol = 1e-6 if variant == "cb_adam" else 0
        torch.testing.assert_close(t[n], j[n], rtol=0, atol=atol, msg=n)


def _ops(A, worker, xs, bf):
    t = torch.from_numpy(xs[worker].copy())
    h = A.push_pull_async(t, name="ops/x")
    assert isinstance(h, int)
    A.synchronize(h)
    assert A.poll(h)
    b = torch.from_numpy(bf[worker]).to(torch.bfloat16)
    inplace = torch.from_numpy(xs[worker] * 2)
    out = {"async": t,
           "bf16": A.push_pull(b, name="ops/bf", average=False).float(),
           "sum": A.push_pull(torch.from_numpy(xs[worker]), average=False,
                              name="ops/sum"),
           "inplace": A.push_pull_inplace(inplace, name="ops/in")}
    assert out["inplace"] is inplace
    out["obj0"] = A.broadcast_object({"from": worker}, root_rank=0)
    out["obj1"] = A.broadcast_object([worker, "x" * (worker * 50)],
                                     root_rank=1, name="o1")
    return out


def test_mixed_fleet_async_ops_and_broadcast_object(ps_lib, monkeypatch,
                                                    jax_uses_port_lib):
    import byteps_tpu.torch as jad
    rs = np.random.RandomState(3)
    xs = [rs.randn(20, 30).astype(np.float32) for _ in range(2)]
    bf = [rs.randn(257).astype(np.float32) for _ in range(2)]
    j, t = _fleet(monkeypatch, lambda: _ops(jad, 0, xs, bf),
                  lambda: _ops(tbps, 1, xs, bf))
    for k in ("async", "bf16", "sum", "inplace"):
        torch.testing.assert_close(t[k], j[k], rtol=0, atol=0, msg=k)
    np.testing.assert_array_equal(t["async"].numpy(),
                                  (xs[0] + xs[1]) / np.float32(2))
    np.testing.assert_array_equal(t["sum"].numpy(), xs[0] + xs[1])
    assert t["obj0"] == j["obj0"] == {"from": 0}
    assert t["obj1"] == j["obj1"] == [1, "x" * 50]


def test_without_servers_the_adapter_is_the_identity(monkeypatch):
    _ps_env(monkeypatch, _free_port())
    monkeypatch.setenv("DMLC_NUM_SERVER", "0")
    tbps.init(device="cpu")
    try:
        assert (tbps.rank(), tbps.size()) == (0, 1)
        model, ref = _net(0), _net(0)
        opt = tbps.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-2),
            named_parameters=model.named_parameters())
        ref_opt = torch.optim.Adam(ref.parameters(), lr=1e-2)
        for s in range(2):
            for m, o in ((model, opt), (ref, ref_opt)):
                o.zero_grad()
                _loss(m, _batch(0, s, 0)).backward()
                o.step()
        for (n, p), q in zip(model.named_parameters(), ref.parameters()):
            torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
        assert tbps.broadcast_object({"a": 1}) == {"a": 1}
        x = torch.arange(6.0)
        torch.testing.assert_close(tbps.push_pull(x, name="x"), x)
        with pytest.raises(ValueError, match="name"):
            tbps.push_pull_async(x)
        with pytest.raises(ValueError, match="unique"):
            tbps.DistributedOptimizer(
                torch.optim.SGD(ref.parameters(), lr=0.1),
                named_parameters=[("w", p) for p in ref.parameters()])
        # a dp group of several processes under one worker is refused
        st = tbps.get_state()
        st.local_size = 2
        try:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                tbps.push_pull(x, name="x")
        finally:
            st.local_size = 1
    finally:
        tbps.shutdown()


@pytest.mark.parametrize("kind", ["optimizer", "ddp", "cross_barrier"])
def test_a_dropped_model_and_its_optimizer_are_freed(ps_lib, monkeypatch,
                                                     kind):
    """The gradient hooks hold their optimizer (or DDP wrapper) weakly:
    they live on the autograd side, where the garbage collector cannot
    see a cycle through them, so a strong hold kept every wrapped model,
    optimizer and gradient alive for the life of the process. One worker
    against a loopback server; the parameter that stays alive past its
    optimizer keeps no hook."""
    import gc
    import weakref

    with ps_server() as port:
        _ps_env(monkeypatch, port)
        tbps.init(device="cpu")
        try:
            def run():
                model = _net(0)
                if kind == "ddp":
                    model = tbps.DistributedDataParallel(model)
                    opt = torch.optim.SGD(model.parameters(), lr=0.1)
                else:
                    opt = tbps.DistributedOptimizer(
                        torch.optim.SGD(model.parameters(), lr=0.1),
                        named_parameters=model.named_parameters())
                    if kind == "cross_barrier":
                        opt = TCrossBarrier(model, opt, num_steps=STEPS)
                        opt.step()
                for s in range(STEPS):
                    opt.zero_grad()
                    _loss(model, _batch(0, s, 0)).backward()
                    if kind == "ddp":
                        model.sync_gradients()
                    opt.step()
                kept = next(model.parameters())
                return weakref.ref(model), weakref.ref(opt), kept

            model_ref, opt_ref, kept = bounded(run)
            gc.collect()
            assert model_ref() is None and opt_ref() is None
            assert not kept._post_accumulate_grad_hooks
        finally:
            tbps.shutdown()
