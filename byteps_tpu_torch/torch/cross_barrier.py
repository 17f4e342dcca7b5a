"""Barrier-crossing optimizer of the PyTorch adapter.

Port of byteps_tpu/torch/cross_barrier.py (BytePS's
byteps/torch/cross_barrier.py:28-225, ByteScheduler, SOSP'19): instead of
one barrier in ``step()``, each parameter has a lock; a poller thread
applies that parameter's update the moment its round lands, and a
pre-forward hook on each module that owns parameters waits only for the
locks of its own, so the next forward of layer k overlaps the rounds
still in flight for the layers after it.

The poller applies each update as one step of the user's optimizer
class over that parameter alone, sharing the optimizer's state, so it is
the update ``optimizer.step()`` would make, bit for bit; the classes are
SGD, Adam and RMSprop, as in BytePS (cross_barrier.py:172-180), whose
updates are elementwise per parameter.

On the card the poller runs with the parameters' card current
(``training.train.on_card``: a new thread starts on card 0) and records
an event after each parameter's update; the pre-forward hook makes the
forward's stream wait on it, so the update is ordered before the next
read of the parameter on the device, not only on the host's lock.

Use as in BytePS: call ``step()`` once before training (the parameter
broadcast time, with no gradients yet): step 0 runs the plain optimizer;
from then on the poller applies every update and ``step()`` only submits
what the backward did not. The scheme's own trade (BytePS's too): a
parameter may change in place while the tail of the current backward
still runs; on a real model the round outlasts the backward, but on a toy
model autograd's version counter can notice.
"""

from __future__ import annotations

import queue
import threading
import time

import torch

from byteps_tpu_torch.core.state import get_state
from byteps_tpu_torch.torch import _land, size
from byteps_tpu_torch.training.train import on_card


class CrossBarrier:
    """Wrap a ``byteps_tpu_torch.torch.DistributedOptimizer`` so that each
    round's completion drives its parameter's update, with no global
    barrier.

    Args:
        model: the model (its modules get the pre-forward hooks).
        byteps_opt: a DistributedOptimizer-wrapped torch optimizer.
        num_steps: the training steps after step 0; at the last the
            poller drains and exits (cross_barrier.py:81-88).
    """

    def __init__(self, model: torch.nn.Module, byteps_opt,
                 num_steps: int = 10 ** 6):
        self._model = model
        self._opt = byteps_opt
        self._step = 0
        self._final_step = num_steps
        self._locks = {p: threading.Lock()
                       for p in self._opt._all_params()}
        # the wrapped user optimizer's exact class (the dynamic subclass's
        # base): a subclass may update otherwise (torch's AdamW is Adam's)
        self._base = type(self._opt).__mro__[1]
        if self._base not in (torch.optim.SGD, torch.optim.Adam,
                              torch.optim.RMSprop):
            raise ValueError("CrossBarrier takes SGD, Adam and RMSprop "
                             f"only, not {self._base.__name__}")
        self._subs: dict = {}        # param -> its one-parameter optimizer
        self._inflight: dict = {}
        self._pushed_at: dict = {}   # param -> step of its last submit
        self._updated: dict = {}     # param -> event after its update
        self._poller_error: Exception = None
        self._distributed = size() > 1 or get_state().scheduler is not None
        if self._distributed:
            self._register_forward_hooks()
            self._event_queue: "queue.Queue" = queue.Queue()
            self._poller = threading.Thread(target=self._poll,
                                            name="bps-crossbarrier",
                                            daemon=True)
            self._poller.start()
            # the optimizer's hooks submit and lock, and feed the poller
            self._opt._on_grad = self._push_pull_async

    def __getattr__(self, item):
        return getattr(self._opt, item)

    # ---- gradient side ------------------------------------------------ #

    def _push_pull_async(self, p: torch.Tensor) -> None:
        self._locks[p].acquire()
        self._pushed_at[p] = self._step
        pending, ctx, sparse = self._opt._start(p)
        self._inflight[p] = pending
        self._event_queue.put((p, pending, ctx, sparse))

    def _poll(self) -> None:
        """Completion poller, FIFO (cross_barrier.py:161-190): when a
        parameter's round lands, write its aggregate, apply its update,
        zero its gradient and release its lock."""
        while True:
            item = self._event_queue.get()
            if item[0] is None:
                return
            p, pending, ctx, sparse = item
            if not pending.done():
                self._event_queue.put(item)
                time.sleep(0.0005)
                continue
            try:
                with on_card(p.device):
                    _land(p, pending.wait(), self._opt._compression, ctx,
                          sparse)
                    self._update_one(p)
                    p.grad.zero_()
                    if p.is_cuda:
                        ev = torch.cuda.Event()
                        ev.record(torch.cuda.current_stream(p.device))
                        self._updated[p] = ev
            except Exception as e:  # noqa: BLE001 - re-raised in step()
                self._poller_error = e
                self._inflight.pop(p, None)
                self._locks[p].release()
                # the poller exits; the other parameters keep their locks
                # (releasing them here could race a waiter into a double
                # release) and pre_forward raises this error instead
                return
            self._inflight.pop(p, None)
            self._locks[p].release()

    # ---- forward side -------------------------------------------------- #

    def _register_forward_hooks(self) -> None:
        """A pre-forward hook on each module that owns parameters waits
        until each of them is updated, on the host and on the forward's
        stream. BytePS hooks the leaf modules (cross_barrier.py:192-225);
        here every module that holds parameters itself, or in a
        ``ParameterDict``/``ParameterList`` (never called), is hooked for
        them, so a model such as ``models.llama.Llama``, whose weights
        sit on the top module and in a ``ParameterDict``, is covered."""
        containers = (torch.nn.ParameterDict, torch.nn.ParameterList)

        def owned(mod):
            ps = list(mod.parameters(recurse=False))
            for kid in mod.children():
                if isinstance(kid, containers):
                    ps += list(kid.parameters())
            return [p for p in ps if p in self._locks]

        def make(params):
            def pre_forward(mod, _inputs):
                for p in params:
                    lock = self._locks[p]
                    # a poller that died never releases the locks of the
                    # rounds in flight: surface its error, not a hang
                    while not lock.acquire(timeout=0.5):
                        if self._poller_error is not None:
                            raise self._poller_error
                    ev = self._updated.pop(p, None)
                    lock.release()
                    if ev is not None:
                        torch.cuda.current_stream(p.device).wait_event(ev)

            return pre_forward

        for mod in self._model.modules():
            params = [] if isinstance(mod, containers) else owned(mod)
            if params:
                mod.register_forward_pre_hook(make(params))

    # ---- optimizer surface --------------------------------------------- #

    def step(self, closure=None):
        if not self._distributed:
            self._step += 1
            return self._opt.step(closure)
        if self._poller_error is not None:
            raise self._poller_error
        if self._step > 0:
            # submit what the backward did not (the missing_p sweep,
            # cross_barrier.py:128-139)
            for p in self._opt._all_params():
                if (p.requires_grad and p.grad is not None
                        and self._pushed_at.get(p, -1) != self._step):
                    self._push_pull_async(p)
            if self._step == self._final_step:
                self.drain()
            loss = closure() if closure is not None else None
            self._step += 1
            return loss
        # step 0: the user's optimizer step, without the distributed
        # optimizer's synchronize (cross_barrier.py:94-97)
        super(type(self._opt), self._opt).step()
        self._step += 1
        return None

    def zero_grad(self) -> None:
        # the poller zeroes each gradient after its update; a global zero
        # would race the rounds in flight (cross_barrier.py:99-107)
        if not (self._distributed and self._step > 0):
            self._opt.zero_grad()

    def drain(self) -> None:
        """Wait until every round in flight is applied, then stop the
        poller (the last step's path)."""
        if not self._distributed:
            return
        while self._inflight and self._poller_error is None:
            time.sleep(0.001)
        self._event_queue.put((None, None, None, None))
        self._poller.join(timeout=30)
        if self._poller_error is not None:
            raise self._poller_error

    # ---- the per-parameter update ------------------------------------- #

    def _group_of(self, p):
        for group in self._opt.param_groups:
            if any(q is p for q in group["params"]):
                return group
        raise KeyError("parameter not in optimizer groups")

    @torch.no_grad()
    def _update_one(self, p: torch.Tensor) -> None:
        """``p``'s update: one step of the user's optimizer class over
        ``p`` alone, with ``p``'s group's hyperparameters and the wrapped
        optimizer's state (BytePS writes the update out,
        cross_barrier.py:227-330; torch's own step gives the bits that
        ``optimizer.step()`` would, foreach or not)."""
        group = self._group_of(p)
        hyper = {k: v for k, v in group.items() if k != "params"}
        sub = self._subs.get(p)
        if sub is None:
            sub = self._subs[p] = self._base([dict(hyper, params=[p])])
            sub.state = self._opt.state     # one state, by parameter
        else:
            sub.param_groups[0].update(hyper)
        sub.step()
