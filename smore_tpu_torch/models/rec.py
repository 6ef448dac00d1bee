"""Recommendation models on one shared embedding table: MF, BPR, WARP,
Skew-OPT.

Port of ``smore_tpu/models/rec.py``. All four run the reference loop
``SourceSample -> TargetSample -> Update*Pair`` on ONE table (the vertex
table passed as both tables), with negatives uniform over the vertices that
have in-edges (``negative_method = "no_degrees"``). By default a step draws
one pool of 256 negatives shared by the batch (the shared-pool updates of
``ops.update``, k_equiv / Ks scaling), and the draws of 8 inner batches run
as one mega-draw (``hoisted_scan_step``); ``shared_negatives=0`` selects
the reference's per-sample negatives. The updates are plain torch ops: the
family reaches no kernel, as it reached no Pallas kernel in the JAX
package.
"""

from __future__ import annotations

import torch

from smore_tpu_torch.models.base import (
    INIT_STREAM,
    PairModelBase,
    clamp_batch,
    hoisted_scan_step,
    init_embedding,
)
from smore_tpu_torch.ops.update import (
    bpr_shared_negs_step,
    bpr_step,
    mf_shared_negs_step,
    mf_step,
    skewbpr_shared_negs_step,
    skewbpr_step,
    warp_shared_pool_step,
    warp_step,
)


class _SharedTableRec(PairModelBase):
    """One table, (src, pos, negatives) draws, one update."""

    negative_method = "no_degrees"
    default_shared_negatives = 256

    def init(self, dim: int) -> None:
        self.dim = dim
        self.state = {"vertex": init_embedding(
            self._generator(INIT_STREAM), self.graph.n_vertices, dim,
            device=self.device)}
        self.build_sampler()

    def _kernel(self, w, src, pos, negs, alpha, collision):
        """The per-sample update on negatives (B, R); returns (w, loss)."""
        raise NotImplementedError

    def _shared_kernel(self, w, src, pos, pool, extra, alpha, collision):
        """The shared-pool update on the pool (Ks,); ``extra`` carries
        WARP's uniforms. Returns (w, loss)."""
        raise NotImplementedError

    def _n_negs(self) -> int:
        raise NotImplementedError

    def _needs_trials(self) -> bool:
        return False  # WARP overrides

    def _make_draw(self, batch: int, shared_negatives: int = 0):
        """draw(tables, gen, m): the draws of ``m`` consecutive inner
        batches in one shot, (src, pos, negs, extra) with a leading (m,)
        axis: negs (m, Ks) pools or (m, batch, R) per-sample negatives,
        extra WARP's (m, batch, Ks + 1) uniforms or (m, 1) zeros."""
        R, Ks = self._n_negs(), shared_negatives

        def draw(tables, gen, m):
            n = m * batch
            if tables.has_edge_table:
                # one gather for the (user, item) pair, the same law
                src, pos = tables.edge_sample(gen, (n,))
            else:
                src = tables.source_sample(gen, (n,))
                pos = tables.target_sample(gen, src)
            src, pos = src.reshape(m, batch), pos.reshape(m, batch)
            extra = torch.zeros((m, 1), dtype=torch.int32,
                                device=tables.device)
            if Ks:
                negs = tables.negative_sample(gen, (m, Ks))
                if self._needs_trials():
                    extra = tables._uniform(gen, (m, batch, Ks + 1))
            else:
                negs = tables.negative_sample(gen, (m, batch, R))
            return src, pos, negs, extra

        return draw

    def _make_update(self, collision: str, shared_negatives: int = 0):
        """update(state, (src, pos, negs, extra), alpha) of one inner
        batch -> (state, loss)."""

        def update(st, x, alpha):
            src, pos, negs, extra = x
            if shared_negatives:
                w, loss = self._shared_kernel(st["vertex"], src, pos, negs,
                                              extra, alpha, collision)
            else:
                w, loss = self._kernel(st["vertex"], src, pos, negs, alpha,
                                       collision)
            return {"vertex": w}, loss

        return update

    def _make_step(self, batch: int, collision: str, hoist: int = 1,
                   shared_negatives: int = 0):
        draw = self._make_draw(batch, shared_negatives)
        update = self._make_update(collision, shared_negatives)
        if hoist > 1:
            # the draws of ``hoist`` batches as one mega-draw, then the
            # inner updates (the draws do not read the tables: same law)
            return hoisted_scan_step(
                lambda tables, gen: draw(tables, gen, hoist), update, hoist)

        def step(state, tables, gen, alpha):
            x = draw(tables, gen, 1)
            return update(state, tuple(a[0] for a in x), alpha)

        return step

    def train(
        self,
        sample_times: float = 10,
        alpha: float = 0.025,
        batch: int = 8192,
        steps_per_call: int = 128,
        collision: str = "sum",
        hoist: int = 0,  # inner batches per mega-draw; 0 = 8 on the
        # shared-pool path, else 1
        shared_negatives: int = -1,  # the pool per step; 0 = per-sample
        # negatives; -1 = the class default (256)
        mesh=None,
        verbose: bool = True,
        **kw,
    ) -> None:
        """The JAX package's ``train`` arguments and defaults; other keyword
        arguments set the model's attributes of that name (``trials``,
        ``rounds``, ...), and an unknown one raises TypeError. ``mesh``
        trains "dp" on every rank of the process group, one batch a step."""
        for k, v in kw.items():
            if not hasattr(self, k):
                raise TypeError(f"unknown train arg {k!r}")
            setattr(self, k, v)
        batch = clamp_batch(self.graph.n_vertices, batch)
        if shared_negatives < 0:
            shared_negatives = self.default_shared_negatives
        if shared_negatives:
            shared_negatives = min(shared_negatives, batch)
        if mesh is not None:
            hoist = 1  # "dp": the ranks' deltas merge every step
        elif hoist == 0:
            hoist = 8 if shared_negatives else 1
        self.state = self._drive(
            self._make_step(batch, collision, hoist, shared_negatives),
            self.build_sampler(), batch * hoist, alpha,
            int(sample_times * 1_000_000), steps_per_call, verbose,
            micro_steps=hoist, mesh=mesh)


class MF(_SharedTableRec):
    """Matrix factorisation (reference UpdateFactorizedPair)."""

    def __init__(self, graph, seed: int = 0, reg: float = 0.01,
                 negative_samples: int = 5,
                 device: torch.device | str = "cuda"):
        super().__init__(graph, seed, device)
        self.reg = reg
        self.negative_samples = negative_samples

    def _n_negs(self):
        return self.negative_samples

    def _kernel(self, w, src, pos, negs, alpha, collision):
        w, _, loss = mf_step(w, w, src, pos, negs, alpha, reg=self.reg,
                             shared_table=True, collision=collision)
        return w, loss

    def _shared_kernel(self, w, src, pos, pool, extra, alpha, collision):
        w, _, loss = mf_shared_negs_step(
            w, w, src, pos, pool, alpha, k_equiv=self.negative_samples,
            reg=self.reg, shared_table=True, collision=collision)
        return w, loss


class BPR(_SharedTableRec):
    """Bayesian personalised ranking (reference UpdateBPRPair, 5 rounds of
    fresh negatives per drawn pair)."""

    def __init__(self, graph, seed: int = 0, rounds: int = 5,
                 device: torch.device | str = "cuda"):
        super().__init__(graph, seed, device)
        self.rounds = rounds

    def _n_negs(self):
        return self.rounds

    def _kernel(self, w, src, pos, negs, alpha, collision):
        w, _, loss = bpr_step(w, w, src, pos, negs, alpha, shared_table=True,
                              collision=collision)
        return w, loss

    def _shared_kernel(self, w, src, pos, pool, extra, alpha, collision):
        w, _, loss = bpr_shared_negs_step(
            w, w, src, pos, pool, alpha, k_equiv=self.rounds,
            shared_table=True, collision=collision)
        return w, loss


class WARP(_SharedTableRec):
    """WSABIE ranking (reference UpdateWARPPair: the first margin violator
    among up to 32 trials gets the update)."""

    def __init__(self, graph, seed: int = 0, trials: int = 32,
                 device: torch.device | str = "cuda"):
        super().__init__(graph, seed, device)
        self.trials = trials

    def _n_negs(self):
        return self.trials

    def _needs_trials(self):
        return True

    def _kernel(self, w, src, pos, negs, alpha, collision):
        w, _, loss = warp_step(w, w, src, pos, negs, alpha,
                               shared_table=True, collision=collision)
        return w, loss

    def _shared_kernel(self, w, src, pos, pool, extra, alpha, collision):
        w, _, loss = warp_shared_pool_step(
            w, w, src, pos, pool, extra, alpha, trials=self.trials,
            shared_table=True, collision=collision)
        return w, loss


class SkewOPT(_SharedTableRec):
    """Skew-OPT (reference UpdateSBPRPair: 16 negatives, the (xi, omega,
    eta) skewed logistic)."""

    def __init__(self, graph, seed: int = 0, xi: float = 10.0,
                 omega: float = 3.0, eta: int = 3, rounds: int = 16,
                 device: torch.device | str = "cuda"):
        super().__init__(graph, seed, device)
        self.xi = xi
        self.omega = omega
        self.eta = eta
        self.rounds = rounds

    def _n_negs(self):
        return self.rounds

    def _kernel(self, w, src, pos, negs, alpha, collision):
        w, _, loss = skewbpr_step(
            w, w, src, pos, negs, alpha, xi=self.xi, omega=self.omega,
            eta=self.eta, shared_table=True, collision=collision)
        return w, loss

    def _shared_kernel(self, w, src, pos, pool, extra, alpha, collision):
        w, _, loss = skewbpr_shared_negs_step(
            w, w, src, pos, pool, alpha, k_equiv=self.rounds, xi=self.xi,
            omega=self.omega, eta=self.eta, shared_table=True,
            collision=collision)
        return w, loss
