"""Device-resident fit loop (counterpart of
atlasqtl_tpu/inference/device_loop.py): the annealing ladder and the
converged CAVI phase with their control held on the device.

The host loop (driver.py) runs each iteration as ~10^2-10^3 torch calls
and reads the ELBO back after every evaluation; at the small shapes the
fit is bound by the host.  Here the reference's control flow
(R/atlasqtl_global_local_core.R:125-377) -- annealing ladder, adaptive ELBO
thinning, convergence test, monotonicity guard -- is restated over device
tensors (it, lb_prev, conv, ibc, bc, nev, the ELBO and iteration buffers,
mono, diff), and every step updates the state in place:

- on the CPU each step runs as plain tensor calls;
- on a CUDA device each kind of step (an annealed lite iteration, a
  converged lite iteration, a converged full one, a converged full one
  with the float64 ELBO and the control update) runs eagerly once on a
  side stream -- a real step, which also makes the kernels' first calls --
  is then captured as one CUDA graph that ends by copying its outputs into
  the static state buffers it read, and is replayed from then on.  All
  graphs share one memory pool.  The annealing temperature is read from a
  device copy of the ladder, indexed by a device rung counter.

Semantics are the host loop's: the same iteration count, lite iterations
unless the result feeds an ELBO evaluation or the iteration is the last
possible one, the same thinning, convergence rule and noise floor.  The
monotonicity guard is flagged on the device and raised after the loop from
the recorded trace, with the same first offending pair.  The host reads
nothing in a step that evaluates no ELBO, five control integers after each
evaluation (conv, bc, mono, nev, finite), and the history once at the end.
A failed capture raises; the fit never carries on in the host loop.
"""
from __future__ import annotations

import dataclasses
import gc
import math

import numpy as np
import torch

from ..ops.special import as_scalar
from ..types import VBState

# Fixed ELBO-trace capacity (the JAX package's): evaluations beyond it
# overwrite the last slot; the guard runs on the device, so only the host
# history is truncated.
ELBO_BUF = 2048
# CUDA-graph replays of every device loop since the count was last set to 0
replays = 0


def eligible(cfg, verbose, data, checkpointer=None, tracer=None) -> bool:
    """The reference's policy (atlasqtl_tpu/inference/device_loop.py:
    eligible): off with a host hook (a checkpointer or a tracer, which run
    between iterations) or verbose=2, whose per-evaluation diagnostics need
    the host; cfg.device_loop "on"/"off" override; "auto" is on for a CUDA
    device and at most 2^25 cells."""
    if cfg.device_loop == "off":
        return False
    if checkpointer is not None or tracer is not None or verbose == 2:
        return False
    if cfg.device_loop == "on":
        return True
    cells = data.x.shape[1] * data.y.shape[1]
    return data.x.device.type == "cuda" and cells <= (1 << 25)


def launch_counters():
    """The kernel wrappers whose `launches` count their kernels' launches
    (and the counts of B1's and B2's bf16 instances, of B1's lookahead
    variant and of both probe instances); a replayed graph adds the
    launches it captured to each."""
    from ..ops import sweep_fused, sweep_missing_fused, sweep_pallas
    from ..ops import sweep_staggered
    return (sweep_fused.sweep_fused, sweep_missing_fused.sweep_missing_fused,
            sweep_pallas.block_gs, sweep_pallas.inner_gs_pallas,
            sweep_staggered.sweep_fused_staggered,
            sweep_fused.sweep_fused.bf16,
            sweep_missing_fused.sweep_missing_fused.pair_bf16,
            sweep_fused.sweep_fused.lookahead,
            sweep_fused.sweep_fused.probe,
            sweep_missing_fused.sweep_missing_fused.probe)


def _count_replay():
    global replays
    replays += 1


class _Step:
    """One kind of step: `body()` computes its outputs from the static
    buffers, `commit(out)` writes them back.  On the CPU both run at every
    call; on CUDA the first call runs eagerly on a side stream, the second
    captures body + commit as a CUDA graph in the loop's pool and replays
    it, and every later call replays it."""

    def __init__(self, loop, name, body, commit):
        self.loop, self.name = loop, name
        self.body, self.commit = body, commit
        self.calls = 0
        self.graph = None
        self.launches = None   # per replay, per counter

    def __call__(self):
        loop = self.loop
        self.calls += 1
        if not loop.cuda:
            self.commit(self.body())
            return
        if self.calls == 1:
            side = torch.cuda.Stream(device=loop.device)
            side.wait_stream(torch.cuda.current_stream(loop.device))
            with torch.cuda.stream(side):
                self.commit(self.body())
            torch.cuda.current_stream(loop.device).wait_stream(side)
            return
        if self.graph is None:
            self._capture()
        self.graph.replay()
        _count_replay()
        for fn, k in zip(launch_counters(), self.launches):
            fn.launches += k

    def _capture(self):
        counters = launch_counters()
        before = [fn.launches for fn in counters]
        stream = torch.cuda.current_stream(self.loop.device)
        graph = torch.cuda.CUDAGraph()
        # an earlier fit's loop and its graphs are cyclic garbage (a step
        # refers to its loop): the collector must not destroy a graph while
        # a stream captures, which invalidates the capture
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.loop.pool):
                self.commit(self.body())
        except Exception as exc:
            # a failed capture leaves the capture stream current; and the
            # failed graph, destroyed later by the garbage collector, could
            # break another capture then: destroy it now
            torch.cuda.set_stream(stream)
            graph.reset()
            raise RuntimeError(
                f"device loop: capturing the {self.name} step as a CUDA "
                f"graph failed ({type(exc).__name__}: {exc})") from None
        finally:
            if gc_on:
                gc.enable()
            # the capture recorded the launches; only replays run them
            self.launches = [fn.launches - b
                             for fn, b in zip(counters, before)]
            for fn, b in zip(counters, before):
                fn.launches = b
        self.graph = graph


class DeviceLoop:
    """The annealing ladder and the converged phase of one fit, on the data's
    device, from `state` (copied into static buffers; the input is not
    modified).  `mod` is the model module (models/global_local or
    models/global_only), `block` the data's predictor block."""

    def __init__(self, mod, data, hyper, state, gram_blocks, cfg, block,
                 ladder=None):
        self.mod, self.data, self.hyper = mod, data, hyper
        self.gram, self.cfg, self.block = gram_blocks, cfg, block
        dev = data.x.device
        self.device = dev
        self.cuda = dev.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self.buf = ELBO_BUF
        self.fields = [f.name for f in dataclasses.fields(state)]
        self.static = {k: getattr(state, k).clone() for k in self.fields
                       if getattr(state, k) is not None}
        dt, edt, i64 = cfg.dtype, cfg.elbo_dtype, torch.int64
        self.one = as_scalar(1.0, dt, dev)
        full = lambda v, dtype: torch.full((), v, dtype=dtype, device=dev)
        if ladder is not None and len(ladder) > 1:
            cs = torch.as_tensor(np.asarray(ladder[:-1], np.float64),
                                 dtype=dt, device=dev)
            self.ladder_c = cs
            self.ladder_cs = cs if cfg.anneal_scale else torch.ones_like(cs)
        self.rung = full(0, i64)
        self.it = full(0, i64)
        self.lb = full(-math.inf, edt)
        self.diff = full(math.inf, edt)
        self.conv = full(False, torch.bool)
        self.mono = full(False, torch.bool)
        self.bc = full(1, i64)
        self.nev = full(0, i64)
        self.ebuf = torch.zeros(self.buf, dtype=edt, device=dev)
        self.ibuf = torch.zeros(self.buf, dtype=i64, device=dev)
        self.ctl = torch.zeros(5, dtype=i64, device=dev)
        if cfg.thinned_elbo_eval:
            times, batch = [1.0, 5.0, 10.0, 50.0], [1, 10, 25, 50]
        else:
            times, batch = [1.0], [1]
        self.times = torch.tensor(times, dtype=edt, device=dev) * cfg.tol
        self.batch = torch.tensor(batch, dtype=i64, device=dev)
        self.ibc = full(len(batch) + 1, i64)
        self.steps = {
            "anneal": _Step(self, "annealed lite", self._anneal_body,
                            self._anneal_commit),
            "lite": _Step(self, "converged lite",
                          lambda: self._iterate(True), self._commit_state),
            "full": _Step(self, "converged full",
                          lambda: self._iterate(False), self._commit_state),
            "eval": _Step(self, "converged full + ELBO", self._eval_body,
                          self._eval_commit),
        }

    # ------------------------------------------------------------ steps

    def state(self) -> VBState:
        return VBState(**{k: self.static.get(k) for k in self.fields})

    def _iterate(self, lite, c=None, c_s=None, annealed=False):
        c = self.one if c is None else c
        c_s = self.one if c_s is None else c_s
        return self.mod.cavi_iteration(
            self.data, self.hyper, self.state(), self.gram, c, c_s,
            cfg=self.cfg, annealed=annealed, lite=lite, block=self.block)

    def _commit_state(self, new):
        for k, buf in self.static.items():
            v = getattr(new, k)
            if v is None:
                raise RuntimeError(f"device loop: the iteration dropped "
                                   f"state field {k}")
            if v is not buf:
                buf.copy_(v)
        self.it.add_(1)

    def _anneal_body(self):
        k = self.rung.view(1)
        c = self.ladder_c.index_select(0, k).view(())
        c_s = self.ladder_cs.index_select(0, k).view(())
        return self._iterate(True, c, c_s, annealed=True)

    def _anneal_commit(self, new):
        self._commit_state(new)
        self.rung.add_(1)

    def _eval_body(self):
        """A full converged iteration, its ELBO and the control update of
        atlasqtl_tpu/inference/device_loop.py:do_eval, as tensors."""
        cfg = self.cfg
        new = self._iterate(False)
        lb = self.mod.compute_elbo(self.data, self.hyper, new,
                                   cfg=cfg).to(cfg.elbo_dtype)
        eps = float(np.finfo(np.float64).eps) ** 0.5
        eps_rel = 64.0 * float(torch.finfo(cfg.elbo_dtype).eps)
        lb_prev = self.lb
        fin = torch.isfinite(lb)
        mono = (self.mono
                | (torch.isfinite(lb_prev)
                   & (lb + eps + eps_rel * torch.abs(lb_prev) < lb_prev))
                | ~fin)
        diff = torch.abs(lb - lb_prev)
        exceed = torch.sum(diff > self.times)
        conv = ((exceed == 0) | (diff <= eps_rel * torch.abs(lb))) & fin
        upd = (exceed > 0) & (self.ibc > exceed)
        ibc = torch.where(upd, exceed, self.ibc)
        bc = torch.where(upd, self.batch.index_select(
            0, torch.clamp(ibc - 1, min=0).view(1)).view(()), self.bc)
        idx = torch.clamp(self.nev, max=self.buf - 1).view(1)
        nev = self.nev + 1
        ctl = torch.stack([conv.long(), bc, mono.long(), nev, fin.long()])
        return new, lb, diff, conv, mono, ibc, bc, nev, idx, ctl

    def _eval_commit(self, out):
        new, lb, diff, conv, mono, ibc, bc, nev, idx, ctl = out
        self._commit_state(new)
        self.ebuf.index_copy_(0, idx, lb.view(1))
        self.ibuf.index_copy_(0, idx, self.it.view(1))
        for buf, v in ((self.lb, lb), (self.diff, diff), (self.conv, conv),
                       (self.mono, mono), (self.ibc, ibc), (self.bc, bc),
                       (self.nev, nev), (self.ctl, ctl)):
            buf.copy_(v)

    # ------------------------------------------------------------- loops

    def anneal(self, n_rungs: int):
        """The ladder's rungs below c = 1, lite and annealed."""
        for _ in range(n_rungs):
            self.steps["anneal"]()

    def converged(self, it0: int, it_init: int, maxit: int):
        """The converged phase from iteration it0.  The host mirrors the
        schedule (it, and bc read after each evaluation), so it picks each
        step's kind without reading the device.  Returns (state, it, lb,
        converged, diff_lb, n_eval, elbo history [(it, lb)], mono)."""
        it, bc, conv, nev = it0, 1, False, 0
        self.it.fill_(it0)  # a loop built after the ladder starts there too
        while not conv and it < maxit:
            it += 1
            will_eval = it <= it_init + 1 or it % bc == 0 or it % bc == 1
            if will_eval:
                self.steps["eval"]()
                conv, bc, mono, nev, fin = self.ctl.tolist()
                if mono and (self.cfg.debug or not fin):
                    break  # the fit raises from the recorded trace
            else:
                self.steps["full" if it >= maxit else "lite"]()
        m = min(nev, self.buf)
        host = torch.cat([
            torch.stack([self.it.double(), self.lb.double(),
                         self.conv.double(), self.diff.double(),
                         self.mono.double()]),
            self.ebuf[:m].double(), self.ibuf[:m].double()]).tolist()
        history = list(zip((int(i) for i in host[5 + m:]), host[5:5 + m]))
        return (self.state(), int(host[0]), host[1], bool(host[2]), host[3],
                nev, history, bool(host[4]))
