"""JODIE: joint dynamic user-item embeddings.

Port of ``smore_tpu/models/jodie.py``. Per epoch the dynamic tables are
reset to the STATIC ones, then the events are scanned in time order
(``ops/jodie_epoch.py``): a BCE step of the event's rows against one random
negative item at ``bce_lr`` (the reference only logs this loss; the JAX
package also applies it, and ``bce_lr=0`` turns it off), the user and item
rows through their fixed RNN cells (``ops/rnn.py``, never trained), and the
statics' move toward the new rows at 0.1 lr. A projection cell (input dt /
100) projects an embedding forward in time. ``evaluate_predictions`` is
the reference's pairwise accuracy pos > random negative over the last <=
1000 events.

The scan is one kernel launch an epoch on the card and the plain loop on
the CPU; on the card the epoch's dependency levels, which the kernel walks,
are built on the host from the events and that epoch's negatives. The time
gaps dt = (t - last t of the row) / 100 depend only on the events, so they
are computed on the host once, and the RNN inputs' table-free part Wx[:,
D:] [f | dt] + b is one matrix product an epoch before the scan.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from smore_tpu_torch.graph.bipartite import InteractionGraph
from smore_tpu_torch.io.embeddings import save_embeddings
from smore_tpu_torch.models.base import (
    INIT_STREAM,
    TRAIN_STREAM,
    seeded_generator,
)
from smore_tpu_torch.ops.jodie_epoch import jodie_epoch, level_schedule
from smore_tpu_torch.ops.rnn import init_rnn_cell, rnn_forward
from smore_tpu_torch.utils.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    save_checkpoint,
)

_CELLS = ("user_rnn", "item_rnn", "proj_rnn")
# JODIE's RNN cells start at the tighter 0.1 its quality gates were tuned
# at, not the cell's 1/sqrt(H) default
RNN_SCALE = 0.1


def _time_gaps(order: np.ndarray, indptr: np.ndarray, ts: np.ndarray,
               t0: float) -> np.ndarray:
    """(t - the row's previous event time) / 100 for every event, in
    float32; a row's first event counts from ``t0``. ``order`` / ``indptr``
    group the events by row in time order."""
    prev = np.full(len(ts), np.float32(t0), np.float32)
    starts = np.zeros(len(ts), bool)
    starts[indptr[:-1][indptr[:-1] < len(ts)]] = True
    later = np.nonzero(~starts)[0]
    prev[order[later]] = ts[order[later - 1]]
    return (ts - prev) / np.float32(100.0)


class JODIE:
    """``device`` holds the tables, the cells and every draw: the CUDA card
    unless the caller asks for another."""

    def __init__(self, ig: InteractionGraph, seed: int = 0,
                 device: torch.device | str = "cuda"):
        self.ig = ig
        self.seed = seed
        self.device = torch.device(device)
        self.state: Dict[str, object] = {}
        self.dim = 0
        self._events = None

    @classmethod
    def load_interactions(cls, path: str, **kw):
        return cls(InteractionGraph.load_interactions(path), **kw)

    def init(self, dim: int) -> None:
        self.dim = dim
        ig = self.ig
        gen = seeded_generator(self.seed, INIT_STREAM, self.device)

        def table(rows):
            u = torch.rand(rows, dim, generator=gen, dtype=torch.float32,
                           device=self.device)
            return (u - 0.5) / dim

        ue, ie = table(ig.n_users), table(ig.n_items)
        in_dim = dim + ig.feature_dim + 1
        self.state = {"user_static": ue, "item_static": ie}
        for name, n_in in zip(_CELLS, (in_dim, in_dim, 1)):
            self.state[name] = init_rnn_cell(gen, n_in, dim, RNN_SCALE,
                                             self.device)
        self.user_dyn, self.item_dyn = ue, ie

    def _device_events(self):
        """(uid, iid, [f | dt_u], [f | dt_i]) on the device, built at first
        use."""
        if self._events is None:
            ig = self.ig
            ts = ig.timestamps
            dt_u = _time_gaps(ig.user_order, ig.user_indptr, ts, ig.min_time)
            dt_i = _time_gaps(ig.item_order, ig.item_indptr, ts, ig.min_time)
            f = (ig.features if ig.features is not None
                 else np.zeros((len(ts), 0), np.float32))

            def dev(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(
                    self.device)

            self._events = (dev(ig.user_ids), dev(ig.item_ids),
                            dev(np.concatenate([f, dt_u[:, None]], 1)),
                            dev(np.concatenate([f, dt_i[:, None]], 1)))
        return self._events

    def scan_inputs(self, state):
        """(uid, iid, cu, ci): the events' users and items and, for the user
        and item cells of ``state``, the table-free part of each event's
        RNN input, Wx[:, D:] [f | dt] + b, (T, D) each."""
        uid, iid, xu, xi = self._device_events()
        D = self.dim
        up, ip = state["user_rnn"], state["item_rnn"]
        cu = (xu @ up["Wx"][:, D:].T + up["b"]).contiguous()
        ci = (xi @ ip["Wx"][:, D:].T + ip["b"]).contiguous()
        return uid, iid, cu, ci

    def epoch(self, state, learning_rate: float, bce_lr: float,
              negs: Optional[torch.Tensor] = None,
              gen: Optional[torch.Generator] = None):
        """One epoch from ``state``'s statics: returns (ue, ie, us, is_,
        mean BCE loss), new tensors. ``negs`` (T,) are the events' negative
        items; when not given they are drawn from ``gen``."""
        ig = self.ig
        if negs is None:
            negs = torch.randint(0, ig.n_items, (ig.n_interactions,),
                                 generator=gen, device=self.device,
                                 dtype=torch.int32)
        negs = negs.to(self.device)
        schedule = None  # the plain loop on the CPU walks the events in order
        if negs.device.type == "cuda":
            schedule = level_schedule(ig.user_ids, ig.item_ids, negs,
                                      ig.n_users, ig.n_items, self.device)
        uid, iid, cu, ci = self.scan_inputs(state)
        ue, ie = (state[k].clone() for k in ("user_static", "item_static"))
        us, is_ = ue.clone(), ie.clone()
        loss = jodie_epoch(ue, ie, us, is_, uid, iid, negs, cu, ci,
                           state["user_rnn"], state["item_rnn"],
                           float(learning_rate), float(bce_lr), schedule)
        return ue, ie, us, is_, loss / ig.n_interactions

    def train(self, epochs: int = 5, learning_rate: float = 0.01,
              bce_lr: Optional[float] = None, verbose: bool = True,
              checkpoint: Optional[str] = None, checkpoint_every: int = 1,
              resume: bool = True) -> None:
        """checkpoint: a directory; the statics, the RNN cells, the final
        dynamic tables, the generator's state and the epoch counter are
        saved there every ``checkpoint_every`` epochs and after the last;
        with ``resume`` a restart continues the uninterrupted run's epochs
        (each epoch restarts the dynamics from the statics, so the epoch is
        the natural unit)."""
        if bce_lr is None:
            bce_lr = learning_rate
        gen = seeded_generator(self.seed, TRAIN_STREAM, self.device)
        state = self.state
        ue = ie = None
        start_ep = 0
        if checkpoint and resume and checkpoint_exists(checkpoint):
            loaded, done_ep, extra = load_checkpoint(checkpoint)
            state = _to_device(loaded["s"], self.device)
            ue, ie = (loaded[k].to(self.device) for k in ("ue", "ie"))
            gen.set_state(extra["gen"])
            start_ep = min(done_ep, epochs)
        for ep in range(start_ep, epochs):
            ue, ie, us, is_, loss = self.epoch(state, learning_rate, bce_lr,
                                               gen=gen)
            state = dict(state, user_static=us, item_static=is_)
            if verbose:
                print(f"\tepoch {ep + 1}/{epochs} BCE={float(loss):.4f}",
                      end="\r", flush=True)
            if checkpoint and ((ep + 1) % max(1, checkpoint_every) == 0
                               or ep + 1 == epochs):
                save_checkpoint(checkpoint, {"s": state, "ue": ue, "ie": ie},
                                step=ep + 1, extra={"gen": gen.get_state()})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if verbose:
            print()
        self.state = state
        if ue is not None:
            self.user_dyn, self.item_dyn = ue, ie

    def project(self, user_emb: torch.Tensor, dt: float) -> torch.Tensor:
        """The embedding projected ``dt`` forward in time (the projection
        cell with input [dt / 100]); dt <= 0 returns it unchanged."""
        if dt <= 0:
            return user_emb
        x = torch.tensor([dt / 100.0], dtype=torch.float32,
                         device=user_emb.device)
        return rnn_forward(self.state["proj_rnn"], user_emb, x)

    def evaluate_predictions(self, tail: int = 1000) -> float:
        """The fraction of the last <= tail events (and <= 20% of them)
        where u . i_pos > u . i_random, on the dynamic tables; negatives
        from numpy ``default_rng(0)``."""
        ig = self.ig
        n = min(tail, max(1, ig.n_interactions // 5))
        u = np.asarray(ig.user_ids[-n:])
        i = np.asarray(ig.item_ids[-n:])
        ue = self.user_dyn.cpu().numpy()
        ie = self.item_dyn.cpu().numpy()
        rng = np.random.default_rng(0)
        neg = rng.integers(0, ig.n_items, n)
        s_pos = np.einsum("nd,nd->n", ue[u], ie[i])
        s_neg = np.einsum("nd,nd->n", ue[u], ie[neg])
        return float((s_pos > s_neg).mean())

    def save_weights(self, user_file: str, item_file: str) -> None:
        """The dynamic tables, users and items in their own files."""
        save_embeddings(user_file, self.ig.users, self.user_dyn.cpu().numpy())
        save_embeddings(item_file, self.ig.items, self.item_dyn.cpu().numpy())

    # -- weights -------------------------------------------------------- #
    def load_state_numpy(self, state: Dict[str, object]) -> None:
        """Take the JAX package's ``state`` (``user_static``,
        ``item_static`` and the three cells as dicts of ``Wh``, ``Wx``,
        ``b``) as numpy arrays; the dynamic tables restart at the
        statics."""
        self.state = _to_device(state, self.device)
        self.dim = self.state["user_static"].shape[1]
        self.user_dyn = self.state["user_static"]
        self.item_dyn = self.state["item_static"]

    def state_numpy(self) -> Dict[str, object]:
        return {k: ({n: t.cpu().numpy() for n, t in v.items()}
                    if isinstance(v, dict) else v.cpu().numpy())
                for k, v in self.state.items()}


def _to_device(state, device):
    """A (nested) dict of arrays or tensors as float32 tensors on
    ``device``."""
    if isinstance(state, dict):
        return {k: _to_device(v, device) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(state, dtype=np.float32)).to(device)
