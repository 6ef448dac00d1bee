"""What the output check reads of the program's first steps.

During set-up's warm ``train()`` the harness wraps, by name, the program's
functions at the boundary between a step's draws and its update (and, for
the walk models, between the walk and the mapper), so that the first call
of that ``train()``, which the program runs eagerly before it captures its
calls as CUDA graphs, hands over what went in and what came out:

- the tables before the first update, after it and after the third (to the
  host, so that the card's memory peak is the program's);
- the draws of the first ``n_draws`` updates (ids, masks, rates) and the
  loss that each of the first three returned;
- the first walks.

Nothing is recorded while a CUDA graph is being captured (the wrapper only
passes the call on), and the wrappers are removed before the window. The
output check of the window's replays (``replay``) records all the updates
of one eager call the same way, without the tables and on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

N_STEPS = 3


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


class Recorder:
    def __init__(self, n_draws: int = 64, tables: bool = True,
                 on_card: bool = False):
        self.n_draws = n_draws
        self.keep_tables = tables
        self._keep = ((lambda t: t.detach().clone()) if on_card
                      else _host)
        self.updates: List[dict] = []  # the draws of each update
        self.losses: List[float] = []  # the first N_STEPS updates' losses
        self.tables: Dict[int, Dict[str, torch.Tensor]] = {}  # 0, 1, 3
        self.walks: List[torch.Tensor] = []
        self._patches: List[tuple] = []

    # -- patching ------------------------------------------------------ #
    def patch(self, module, name: str, make: Callable) -> None:
        """Replace ``module.name`` by ``make(original)`` until restore()."""
        orig = getattr(module, name)
        self._patches.append((module, name, orig))
        setattr(module, name, make(orig))

    def restore(self) -> None:
        for module, name, orig in reversed(self._patches):
            setattr(module, name, orig)
        self._patches.clear()

    # -- what the wrappers call ------------------------------------------ #
    def wants(self, probe: torch.Tensor) -> bool:
        """Record this update? Only the first n_draws, never under
        capture."""
        return len(self.updates) < self.n_draws and not _capturing(probe)

    def before(self, tables: Dict[str, torch.Tensor]) -> None:
        if not self.updates and self.keep_tables:
            self.tables[0] = {k: _host(v) for k, v in tables.items()}

    def after(self, tables: Dict[str, torch.Tensor], draws: dict,
              loss: torch.Tensor) -> None:
        i = len(self.updates)
        # an update applied again to the same draws (the walk models'
        # inner passes at truncated budgets) is a "repeat": the reference
        # follows it, the laws count its draws once
        rec = {k: self._keep(v) if torch.is_tensor(v) else v
               for k, v in draws.items()}
        last = self.updates[-1] if self.updates else None
        rec["repeat"] = last is not None and all(
            torch.equal(rec[k], last[k]) for k in ("src", "pos", "negs"))
        self.updates.append(rec)
        if i < N_STEPS:
            self.losses.append(float(loss))
        if i in (0, N_STEPS - 1) and self.keep_tables:
            self.tables[i + 1] = {k: _host(v) for k, v in tables.items()}

    def walk(self, walk: torch.Tensor) -> None:
        if len(self.walks) < self.n_draws and not _capturing(walk):
            self.walks.append(self._keep(walk))

    @property
    def complete(self) -> bool:
        return len(self.losses) == N_STEPS and set(self.tables) == {0, 1, 3}


def shared_negs_wrapper(rec: Recorder) -> Callable:
    """Wraps ``sgns_shared_negs_step(w_vertex, w_context, src, pos, negs,
    alpha, k_equiv=..., mask=..., src_group=..., ...)`` (order 2: two
    tables, updated in place)."""

    def make(orig):
        def wrapped(w_vertex, w_context, src, pos, negs, alpha, *a, **kw):
            if not rec.wants(src):
                return orig(w_vertex, w_context, src, pos, negs, alpha, *a,
                            **kw)
            rec.before({"vertex": w_vertex, "context": w_context})
            out = orig(w_vertex, w_context, src, pos, negs, alpha, *a, **kw)
            mask: Optional[torch.Tensor] = kw.get("mask")
            rec.after({"vertex": out[0], "context": out[1]},
                      {"kind": "shared", "src": src, "pos": pos,
                       "negs": negs, "mask": mask, "alpha": float(alpha),
                       "k_equiv": int(kw.get("k_equiv", 5)),
                       "src_group": int(kw.get("src_group", 1))},
                      out[2])
            return out

        return wrapped

    return make


def multiblock_wrapper(rec: Recorder) -> Callable:
    """Wraps LINE's ``multiblock_apply(state, band_size, sb, db, src_l,
    pos_l, negs, alphas, k_equiv)`` (one superstep, tables in place; sb and
    db are band START rows, src_l and pos_l band-local)."""

    def make(orig):
        def wrapped(state, band_size, sb, db, src_l, pos_l, negs, alphas,
                    k_equiv):
            if not rec.wants(src_l):
                return orig(state, band_size, sb, db, src_l, pos_l, negs,
                            alphas, k_equiv)
            rec.before(state)
            loss = orig(state, band_size, sb, db, src_l, pos_l, negs, alphas,
                        k_equiv)
            rec.after(state,
                      {"kind": "superstep",
                       "src": sb[:, None].long() + src_l.long(),
                       "pos": db[:, None].long() + pos_l.long(),
                       "negs": negs, "alphas": alphas,
                       "k_equiv": int(k_equiv), "band_size": int(band_size)},
                      loss)
            return loss

        return wrapped

    return make


def walk_wrapper(rec: Recorder) -> Callable:
    """Wraps ``random_walk(tables, gen, starts, steps, ...) -> (walk,
    row_mask)``."""

    def make(orig):
        def wrapped(*a, **kw):
            walk, row_mask = orig(*a, **kw)
            rec.walk(walk)
            return walk, row_mask

        return wrapped

    return make
