"""What the output check reads of the window's replays.

A job's calls after its first two are replays of one captured CUDA graph:
more than 99% of a window. Set-up's recorder (``record``) sees only the
eager first call of set-up's ``train()``, so while the window runs the
harness also wraps, by name:

- ``TrainDriver._call``, which the eager first call and the capture pass
  through (a replay does not): it learns the ``train()``'s static buffers,
  the tables and the generator the graph replays on, and the driver's
  settings;
- ``CapturedCalls.__call__``: around call ``k`` of every job (``pick``: a
  replay, the capture being call 1) it keeps, on the card and with no
  wait for it, the tables before and after the call, and the generator's
  state before and after it. Each job overwrites the last one's, so after
  the window they are the last job's. That is four copies of the tables a
  job (~1.3 ms of a 4.6 s job on the Youtube graph).

After the window (``rerun``), the program's call runs once more, eagerly,
from the kept tables and generator state, with the rates of the
reference's own schedule (``reference.sgns.alpha_schedule``) and a
recorder on all of its updates. The output check (``check.replay_numbers``)
then has the reference follow those updates from the kept tables and holds
the replay's change of the tables to the reference's, and holds the
generator's state after the eager call to the state the replay left: a
replay that draws anything else than the eager call, or that does not
advance the generator, fails one or the other.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from perfbench.harness.record import Recorder
from perfbench.reference import sgns

LEAVES = ("vertex", "context")
K_MAX = 16


class Abort(Exception):
    """Raised after call ``k`` where a job is cut there (calibration)."""


def n_calls(driver) -> int:
    steps = max(1, -(-driver.total_samples // driver.samples_per_step))
    return -(-steps // driver.steps_per_call)


def pick(calls: int, from_end: Optional[int] = None) -> Optional[int]:
    """The call kept: half-way through the job, at most call 16, or, with
    ``from_end``, the call that many before the job's end; None where the
    job has no replay after its capture."""
    if calls < 3:
        return None
    if from_end is not None:
        return max(2, calls - from_end)
    return max(2, min(K_MAX, calls // 2))


class ReplayProbe:
    def __init__(self, abort: bool = False, from_end: Optional[int] = None):
        self.abort = abort
        self.from_end = from_end
        self.driver = self.state = self.gen = None
        self.k: Optional[int] = None
        self.kept = False
        self.before: Dict[str, torch.Tensor] = {}
        self.after: Dict[str, torch.Tensor] = {}
        self.gen_before = self.gen_after = self.gen_eager = None
        self._patches: List[tuple] = []

    # -- patching ------------------------------------------------------ #
    def install(self) -> None:
        from smore_tpu_torch.models import base

        probe = self
        orig_call = base.TrainDriver._call
        orig_loop = base.CapturedCalls.__call__

        def _call(driver, state, gen, alphas, loss):
            probe._seen(driver, state, gen)
            return orig_call(driver, state, gen, alphas, loss)

        def loop_call(loop, run, kind=None):
            d = probe.driver
            if d is None or loop is not d.loop or loop.calls != probe.k:
                return orig_loop(loop, run, kind)
            probe.gen_before = probe.gen.get_state()
            probe._copy(probe.before)
            orig_loop(loop, run, kind)
            probe.gen_after = probe.gen.get_state()
            probe._copy(probe.after)
            probe.kept = True
            if probe.abort:
                raise Abort()

        for cls, name, f in ((base.TrainDriver, "_call", _call),
                             (base.CapturedCalls, "__call__", loop_call)):
            self._patches.append((cls, name, getattr(cls, name)))
            setattr(cls, name, f)

    def restore(self) -> None:
        for cls, name, orig in reversed(self._patches):
            setattr(cls, name, orig)
        self._patches.clear()

    def forget(self) -> None:
        """Before a job: drop the last job's driver and tables."""
        self.driver = self.state = self.gen = None
        self.kept = False

    # -- what the wrappers call ------------------------------------------ #
    def _seen(self, driver, state, gen) -> None:
        if driver is self.driver:
            return
        self.driver, self.state, self.gen = driver, state, gen
        self.k = pick(n_calls(driver), self.from_end)
        self.kept = False

    def _copy(self, into: Dict[str, torch.Tensor]) -> None:
        for name in LEAVES:
            t = self.state[name]
            if name not in into or into[name].shape != t.shape:
                into[name] = torch.empty_like(t)
            into[name].copy_(t)

    # -- after the window ------------------------------------------------- #
    def schedule(self) -> torch.Tensor:
        """The rates of call ``k`` by the reference's schedule, from the
        driver's settings."""
        d = self.driver
        a = sgns.alpha_schedule(d.alpha, self.k * d.steps_per_call,
                                d.steps_per_call, d.micro_steps,
                                d.samples_per_step, d.total_samples)
        return torch.as_tensor(a, device=self.state["vertex"].device)

    def rerun(self, fam) -> Recorder:
        """Call ``k`` again, eagerly, from the kept tables and generator
        state, with the reference's rates; returns its recorded updates
        (kept on the card)."""
        if not self.kept:
            raise RuntimeError("the output check kept no replay: the last "
                               "job has no call after its capture")
        d = self.driver
        for name in LEAVES:
            self.state[name].copy_(self.before[name])
        self.gen.set_state(self.gen_before)
        rec = Recorder(n_draws=1 << 62, tables=False, on_card=True)
        fam.hooks(rec)
        try:
            d._call(self.state, self.gen, self.schedule(),
                    torch.zeros((), dtype=torch.float32,
                                device=self.state["vertex"].device))
            if self.state["vertex"].is_cuda:
                torch.cuda.synchronize(self.state["vertex"].device)
        finally:
            rec.restore()
        self.gen_eager = self.gen.get_state()
        if not rec.updates:
            raise RuntimeError("the eager call of the output check reached "
                               "no update at the recorded boundary")
        return rec

    def release(self) -> None:
        """Drop the program's state; keep the kept tables and states."""
        self.driver = self.state = self.gen = None
