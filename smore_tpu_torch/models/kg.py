"""Knowledge-graph embedding models: TransE, RotatE, ComplEx.

Port of ``smore_tpu/models/kg.py``. All three are margin-ranking models
over corrupted triples:

  TransE  score = ||h + r - t||_{1 or 2}
  RotatE  score = ||h o r - t||_2, r unit-modulus complex (stored as
          phases), plus the self-adversarial negative weight
          exp(-negScore / T); the applied step follows the sum of the
          per-coordinate complex moduli (the reference's normalised step)
  ComplEx score = Re<h, r, conj(t)> (higher = better), the margin on
          (margin + neg - pos)

One step takes a batch of triple ids, corrupts each triple's head or tail
(probability 1/2) by a uniform draw from the relation's entity pool, and
applies ``lr * grad`` of the summed margin loss to every table (a SUM, not
a mean: every triple's update at the full rate). The gradient is
``torch.autograd`` on the gathered rows, so duplicate rows in a batch sum
their gradients (RotatE's in a fixed order on the card too:
``_add_rows``), and every delta is computed before the first in-place
write. Between epochs TransE and ComplEx project the entities back onto
the unit sphere (RotatE's relations are unit-modulus by construction).

Complex rows are stored as (..., 2D) real arrays (re | im halves), as in
the JAX package; save format: separate entity / relation files in the
standard "N dim" layout.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from smore_tpu_torch.graph.knowledge import KnowledgeGraph
from smore_tpu_torch.io.embeddings import save_embeddings
from smore_tpu_torch.models.base import (
    ALPHA_MIN_FRAC,
    INIT_STREAM,
    TRAIN_STREAM,
    OwnLoop,
    _AlphaStaging,
    clamp_batch,
    epoch_calls,
    seeded_generator,
)
from smore_tpu_torch.utils.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    save_checkpoint,
)


def _uniform_init(gen, rows, dim, scale, device):
    u = torch.rand(rows, dim, generator=gen, dtype=torch.float32,
                   device=device)
    return u * (2.0 * scale) - scale


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Divide every row of ``x`` by its L2 norm (at least 1e-12), in
    place."""
    n = torch.sqrt((x * x).sum(1, keepdim=True))
    return x.div_(torch.clamp(n, min=1e-12))


def _abs_jax(x: torch.Tensor) -> torch.Tensor:
    """|x| whose gradient at 0 is 1, JAX's convention (torch's abs has 0
    there)."""
    return torch.where(x >= 0, x, -x)


def _add_rows(table: torch.Tensor, idx: torch.Tensor, delta: torch.Tensor,
              ordered: bool) -> None:
    """``table[idx] += delta`` in place. ``index_add_`` sums duplicate rows
    in index order on the CPU, with atomics in an order that changes from
    run to run on the card; ``ordered`` sums them in index order there too
    (a sorted accumulate, ``index_put_``: deterministic, but it costs
    ~43% of TransE's captured steps/s and ~27% of RotatE's at FB15k-237's
    shape)."""
    if ordered and table.device.type == "cuda":
        table.index_put_((idx,), delta, accumulate=True)
    else:
        table.index_add_(0, idx, delta)


class _KGBase(OwnLoop):
    """Shared: epoch loop over shuffled triple batches, autograd step.

    ``device`` holds the tables and every draw: the CUDA card unless the
    caller asks for another; without a card the first allocation raises.
    A call is ``steps_per_call`` steps (``OwnLoop``: captured once on the
    card as a CUDA graph and replayed for every later call of the
    ``train()``); an epoch's first call also draws its permutation, its
    last renormalises."""

    _higher_is_better = False
    _complex_rows = False  # entity rows are re | im halves of 2 * dim
    # duplicate rows summed in a fixed order on the card too (_add_rows)
    _ordered_sums = False
    # the steps of a call (None: an epoch's). A capture costs its call's
    # steps and replays run at the card's pace at any length, so a call is
    # the fewest steps whose replay the card, not the host, bounds: at one
    # step the host issues a replay in ~2/3 of a step's device time (PERF.md)
    steps_per_call: Optional[int] = 4

    def __init__(self, kg: KnowledgeGraph, seed: int = 0, margin: float = 1.0,
                 device: torch.device | str = "cuda"):
        self.kg = kg
        self.seed = seed
        self.margin = margin
        self.device = torch.device(device)
        self.state: Dict[str, torch.Tensor] = {}
        self.dim = 0
        self._triples = None

    @classmethod
    def load_triples(cls, path: str, **kw):
        return cls(KnowledgeGraph.load_triples(path), **kw)

    # -- per-model hooks ------------------------------------------------ #
    def _score_rows(self, eh, rr, et):
        """Batched score of gathered rows; LOWER = better fit unless
        _higher_is_better."""
        raise NotImplementedError

    # the score whose gradient is the APPLIED update direction; the margin
    # test always uses _score_rows
    _update_score_rows = None

    def _init_state(self, gen) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _renorm(self, state) -> None:
        """Between-epoch normalisation (entity unit sphere), in place."""
        _unit_rows(state["entity"])

    def _adversarial_weight(self, neg_score) -> Optional[torch.Tensor]:
        return None  # RotatE overrides

    def _score(self, state, h, r, t):
        e = state["entity"]
        return self._score_rows(e[h], state["relation"][r], e[t])

    # -- training ------------------------------------------------------- #
    def init(self, dim: int) -> None:
        self.dim = dim
        self.state = self._init_state(
            seeded_generator(self.seed, INIT_STREAM, self.device))

    def _device_triples(self):
        """(heads, relations, tails, rel_indptr, rel_entities) on the
        device, built at first use."""
        if self._triples is None:
            kg = self.kg

            def dev(a):
                return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(
                    self.device)

            self._triples = (dev(kg.heads), dev(kg.relations), dev(kg.tails),
                             dev(kg.rel_indptr), dev(kg.rel_entities))
        return self._triples

    def _corrupt(self, h, r, t, u):
        """Corrupt head or tail (u[1] < 0.5: the head) by a uniform draw
        u[0] from the relation's entity pool."""
        _, _, _, rel_indptr, rel_entities = self._device_triples()
        lo = rel_indptr[r]
        size = torch.clamp(rel_indptr[r + 1] - lo, min=1)
        cand = rel_entities[lo + torch.minimum((u[0] * size).to(torch.int32),
                                               size - 1)]
        head = u[1] < 0.5
        return torch.where(head, cand, h), torch.where(head, t, cand)

    def _make_step(self):
        """step(state, idx (B,), u (2, B), lr) -> loss: one update of the
        tables (in place) on the triples ``idx``, corrupted by the uniforms
        ``u``; lr a float32 (1,) tensor (a captured call's rates live on
        the card) or a Python float. The rows move by the f32 product
        ``grad * -lr``, as the JAX step's ``v - lr * grad``."""
        margin = self.margin
        sign = -1.0 if self._higher_is_better else 1.0
        upd = self._update_score_rows
        ordered = self._ordered_sums

        def step(state, idx, u, lr):
            heads, rels, tails, _, _ = self._device_triples()
            h, r, t = heads[idx], rels[idx], tails[idx]
            nh, nt = self._corrupt(h, r, t, u)
            ents = torch.cat([h, t, nh, nt])
            E, R = state["entity"], state["relation"]
            with torch.enable_grad():
                e_rows = E[ents].requires_grad_()
                r_rows = R[r].requires_grad_()
                eh, et, enh, ent = e_rows.chunk(4)
                pos = sign * self._score_rows(eh, r_rows, et)
                neg = sign * self._score_rows(enh, r_rows, ent)
                w = self._adversarial_weight(neg.detach())
                gate = (margin + pos - neg).detach() > 0
                if upd is not None:
                    pos = sign * upd(eh, r_rows, et)
                    neg = sign * upd(enh, r_rows, ent)
                term = pos - (neg * w if w is not None else neg)
                loss = torch.where(gate, term, 0.0).sum()
                g_e, g_r = torch.autograd.grad(loss, [e_rows, r_rows])
            neg_lr = -lr
            _add_rows(E, ents, g_e * neg_lr, ordered)
            _add_rows(R, r, g_r * neg_lr, ordered)
            return loss.detach()

        return step

    def evaluate_link_prediction(self, test_triples: int = 1000,
                                 num_negatives: int = 10,
                                 seed: int = 0):
        """Rank each of the last ``test_triples`` true triples against
        ``num_negatives`` corrupted-head negatives (numpy
        ``default_rng(seed)``); returns (MRR, hits@3), MRR = 1 /
        mean(rank), as the reference protocol computes it."""
        kg = self.kg
        t = min(test_triples, kg.n_triples)

        def dev(a):
            return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(
                self.device)

        h, r, tl = dev(kg.heads[-t:]), dev(kg.relations[-t:]), dev(
            kg.tails[-t:])
        # higher-is-better: TransE/RotatE _score is a distance
        sign = 1.0 if self._higher_is_better else -1.0
        rng = np.random.default_rng(seed)
        neg_h = dev(rng.integers(0, kg.n_entities, (num_negatives, t)))
        with torch.no_grad():
            correct = sign * self._score(self.state, h, r, tl)
            neg = torch.stack([sign * self._score(self.state, neg_h[i], r, tl)
                               for i in range(num_negatives)])
            better = (correct[None, :] > neg).sum(0).cpu().numpy()
        rank = np.asarray(num_negatives - better + 1, dtype=np.float64)
        return float(1.0 / rank.mean()), float((rank <= 3).mean())

    def train(
        self,
        epochs: int = 100,
        batch: int = 1024,
        alpha: float = 0.01,
        verbose: bool = True,
        checkpoint: str = None,
        checkpoint_every: int = 1,
        resume: bool = True,
    ) -> None:
        """checkpoint: a directory; the tables, the generator's state and
        the epoch counter are saved there every ``checkpoint_every`` epochs
        and after the last. With ``resume`` a same-``epochs`` restart
        continues the uninterrupted run's steps (the lr is a function of
        the restored epoch counter and the run's total epochs); resuming
        with a DIFFERENT ``epochs`` re-stretches the linear lr decay over
        the new total, and a warning says so."""
        kg = self.kg
        n = kg.n_triples
        batch = clamp_batch(min(n, kg.n_entities), batch)
        n_batches = max(1, n // batch)
        step = self._make_step()
        gen = seeded_generator(self.seed, TRAIN_STREAM, self.device)
        state = self.state
        total = epochs * n_batches
        start_ep = 0
        if checkpoint and resume and checkpoint_exists(checkpoint):
            loaded, done_ep, extra = load_checkpoint(checkpoint)
            for k, v in state.items():
                v.copy_(loaded[k])
            gen.set_state(extra["gen"])
            start_ep = min(int(done_ep), epochs)
            if int(extra.get("epochs", epochs)) != epochs:
                print(f"\twarning: resuming with -epochs {epochs} but "
                      f"checkpoint was written by an -epochs "
                      f"{int(extra['epochs'])} run; the linear lr decay "
                      f"re-stretches over the new total", flush=True)
        # the static buffers of the calls: the epoch's permutation, the
        # position of the next step in it, its rates and the last loss
        dev = self.device
        perm = torch.empty(n, dtype=torch.int64, device=dev)
        batches = perm[: n_batches * batch].view(n_batches, batch)
        pos = torch.zeros(1, dtype=torch.int64, device=dev)
        rates = torch.empty(n_batches, dtype=torch.float32, device=dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        staging = _AlphaStaging((n_batches,), dev)
        sizes = epoch_calls(n_batches, self.steps_per_call)

        def call(first: bool, last: bool, size: int) -> None:
            """``size`` steps of the epoch from ``pos`` (its start, and a
            new permutation, when ``first``; the renorm when ``last``)."""
            if first:
                torch.randperm(n, generator=gen, out=perm)
                pos.zero_()
            for _ in range(size):
                u = torch.rand((2, batch), generator=gen, device=dev)
                step_loss = step(state, batches.index_select(0, pos)[0], u,
                                 rates.index_select(0, pos))
                pos.add_(1)
            if last:
                self._renorm(state)
            loss.copy_(step_loss)

        calls = self._new_calls(gen)
        try:
            for ep in range(start_ep, epochs):
                staging.put(kg_rates(ep * n_batches, n_batches, alpha,
                                     total), rates)
                for i, size in enumerate(sizes):
                    kind = (i == 0, i == len(sizes) - 1, size)
                    calls(functools.partial(call, *kind), kind)
                if verbose:
                    print(f"\tepoch {ep + 1}/{epochs} loss={float(loss):.5f}",
                          end="\r", flush=True)
                if checkpoint and ((ep + 1) % max(1, checkpoint_every) == 0
                                   or ep + 1 == epochs):
                    save_checkpoint(checkpoint, state, step=ep + 1,
                                    extra={"gen": gen.get_state(),
                                           "epochs": epochs})
        finally:
            calls.close()
        if verbose:
            print()

    # -- weights -------------------------------------------------------- #
    def load_state_numpy(self, tables: Dict[str, np.ndarray]) -> None:
        """Take ``{"entity", "relation"}`` numpy tables (the JAX package's
        state) as this model's float32 tables on its device."""
        self.state = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(
            self.device) for k, v in tables.items()}
        self.dim = self.state["entity"].shape[1] // (
            2 if self._complex_rows else 1)

    def state_numpy(self) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() for k, v in self.state.items()}

    def save_embeddings(self, entity_file: str, relation_file: str) -> None:
        save_embeddings(entity_file, self.kg.entities,
                        self.state["entity"].cpu().numpy())
        save_embeddings(relation_file, self.kg.relations_names,
                        self._relation_out().cpu().numpy())

    def _relation_out(self) -> torch.Tensor:
        return self.state["relation"]


def kg_rates(done: int, steps: int, alpha: float, total: int) -> np.ndarray:
    """The float32 learning rates of ``steps`` steps from step ``done`` of
    ``total``: ``max(alpha * (1 - done / total), alpha * 1e-4)`` in double,
    as the JAX loop computes it on the host, then cast to float32 as it
    passes it to its step."""
    d = done + np.arange(steps, dtype=np.float64)
    return np.maximum(alpha * (1.0 - d / total),
                      alpha * ALPHA_MIN_FRAC).astype(np.float32)


class TransE(_KGBase):
    def __init__(self, kg, seed: int = 0, margin: float = 1.0, norm: int = 2,
                 device: torch.device | str = "cuda"):
        super().__init__(kg, seed, margin, device)
        self.norm = norm

    def _init_state(self, gen):
        dim = self.dim
        s = 6.0 / np.sqrt(dim)
        ent = _uniform_init(gen, self.kg.n_entities, dim, s, self.device)
        rel = _uniform_init(gen, self.kg.n_relations, dim, s, self.device)
        # the reference normalises entities at init
        return {"entity": _unit_rows(ent), "relation": rel}

    def _score_rows(self, eh, rr, et):
        d = eh + rr - et
        if self.norm == 1:
            return _abs_jax(d).sum(-1)
        return torch.sqrt((d * d).sum(-1) + 1e-12)


class RotatE(_KGBase):
    """Entities: (N, 2D) re|im; relations: (R, D) PHASES."""

    _complex_rows = True
    # the per-coordinate step d / |d| is a sign where d is near 0, so the
    # card's changing atomic order would become steps of the full rate: two
    # runs of one seed part by ~6e-2 in 1,590 steps at FB15k-237's shape
    # (PERF.md); TransE's and ComplEx's steps keep it at round-off
    _ordered_sums = True

    def __init__(self, kg, seed: int = 0, margin: float = 6.0,
                 adversarial_temp: float = 1.0,
                 device: torch.device | str = "cuda"):
        super().__init__(kg, seed, margin, device)
        self.adversarial_temp = adversarial_temp

    def _init_state(self, gen):
        dim = self.dim
        ent = _uniform_init(gen, self.kg.n_entities, 2 * dim,
                            6.0 / np.sqrt(dim), self.device)
        phase = torch.rand(self.kg.n_relations, dim, generator=gen,
                           device=self.device) * (2 * np.pi)
        # unit-sphere init keeps distances O(1) relative to the margin
        return {"entity": _unit_rows(ent), "relation": phase}

    def _diff(self, eh, p, et):
        dim = self.dim
        hr, hi = eh[:, :dim], eh[:, dim:]
        tr, ti = et[:, :dim], et[:, dim:]
        cr, ci = torch.cos(p), torch.sin(p)
        return hr * cr - hi * ci - tr, hr * ci + hi * cr - ti

    def _score_rows(self, eh, p, et):
        dr, di = self._diff(eh, p, et)
        return torch.sqrt((dr * dr + di * di).sum(-1) + 1e-12)

    def _update_score_rows(self, eh, p, et):
        """Sum of PER-COORDINATE complex moduli: its gradient is
        diff_d / |diff_d| per coordinate, the reference's normalised step;
        the margin test still uses the L2 score."""
        dr, di = self._diff(eh, p, et)
        return torch.sqrt(dr * dr + di * di + 1e-12).sum(-1)

    def _adversarial_weight(self, neg_score):
        if self.adversarial_temp <= 0:
            return None
        return torch.exp(-neg_score / self.adversarial_temp)

    def _renorm(self, state) -> None:
        # relations are phases -- unit modulus by construction; entities
        # are NOT normalised in the reference RotatE
        return None

    def _relation_out(self) -> torch.Tensor:
        """Export as cos | sin, like a complex row."""
        p = self.state["relation"]
        return torch.cat([torch.cos(p), torch.sin(p)], dim=1)


class ComplEx(_KGBase):
    """Entities / relations: (., 2D) re|im; score Re<h, r, conj(t)>."""

    _higher_is_better = True
    _complex_rows = True

    def _init_state(self, gen):
        dim = self.dim
        s = 6.0 / np.sqrt(dim)
        ent = _uniform_init(gen, self.kg.n_entities, 2 * dim, s, self.device)
        rel = _uniform_init(gen, self.kg.n_relations, 2 * dim, s,
                            self.device)
        return {"entity": _unit_rows(ent), "relation": rel}

    def _score_rows(self, eh, rr, et):
        dim = self.dim
        hr, hi = eh[:, :dim], eh[:, dim:]
        tr, ti = et[:, :dim], et[:, dim:]
        r_re, r_im = rr[:, :dim], rr[:, dim:]
        # Re<h, r, conj(t)> = sum hr*rr*tr + hi*rr*ti + hr*ri*ti - hi*ri*tr
        return (hr * r_re * tr + hi * r_re * ti + hr * r_im * ti
                - hi * r_im * tr).sum(-1)
