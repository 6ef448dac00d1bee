"""Faults that act only in the replays of a job's captured call, planted to
show that the output check of the window's replays (``replay``) catches
them. Each is a context manager that patches the program's driver by name;
plant it before the harness installs its own wrappers, so that these see
the broken call.

- ``stale_alphas``: the rates staged for a call stop reaching the card
  after the capture: every replay runs on the capture's rates;
- ``frozen_rng``: a replay does not advance the training generator, so
  every replay repeats the draws of the one before;
- ``lost_update``: a replay's change of the tables is lost (the tables
  put back as they were before it).
"""

from __future__ import annotations

import contextlib

REPLAY_FAULTS = ("stale_alphas", "frozen_rng", "lost_update")


def _closure(run, name: str):
    return run.__closure__[run.__code__.co_freevars.index(name)].cell_contents


@contextlib.contextmanager
def plant(fault: str):
    from smore_tpu_torch.models import base

    if fault == "stale_alphas":
        cls, name = base._AlphaStaging, "put"
        orig = cls.put

        def f(self, values, dst):
            n = getattr(self, "_puts", 0)
            self._puts = n + 1
            if n < 2:  # the eager first call's and the capture's
                orig(self, values, dst)
    elif fault in ("frozen_rng", "lost_update"):
        cls, name = base.CapturedCalls, "__call__"
        orig = cls.__call__

        def f(self, run, kind=None):
            if self.calls < 2:
                return orig(self, run, kind)
            if fault == "frozen_rng":
                s = self.gen.get_state()
                orig(self, run, kind)
                self.gen.set_state(s)
            else:
                state = _closure(run, "state")
                keep = {k: v.clone() for k, v in state.items()
                        if getattr(v, "ndim", 0) == 2}
                orig(self, run, kind)
                for k, v in keep.items():
                    state[k].copy_(v)
    else:
        raise ValueError(f"no replay fault {fault!r}")
    setattr(cls, name, f)
    try:
        yield
    finally:
        setattr(cls, name, orig)
