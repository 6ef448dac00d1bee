"""LINE (Large-scale Information Network Embedding), orders 1 and 2.

Port of ``smore_tpu/models/line.py``. Order 1 keeps one uniform-init table
and updates both endpoints of a sampled edge in it; order 2 keeps a
uniform-init vertex table and a zero-init context table. Both train by
SGNS on edge samples (source by out-degree^0.75, context by edge
weight^0.75, negatives by degree^0.75), with the learning rate decayed
linearly to alpha * 1e-4 over ``sample_times`` million samples.

``train`` keeps the JAX package's routing decisions as they are, with "on
the TPU" read as "on a CUDA device" (the model's device, the card unless
the caller asks for the CPU). The routes:

- the unbanded path (every graph under 262,144 vertices by default, orders
  1 and 2): ``_make_step`` with shared negatives (hoisted, grouped or plain
  draws from ``SamplerTables``, update ``ops.update.sgns_shared_negs_step``,
  kernel ``ops/sgns.sgns_shared_grads`` when ``use_pallas=True``) or strict
  per-sample negatives (``sgns_step`` / ``sgns_step_shared``);
- the banded multiblock path, which the JAX package takes above 262,144
  vertices on its accelerator: order 2, group 1, dim % 64 == 0, batch 2048
  per stratum visit at band 16400, 16 micro-steps per superstep,
  pre-sampled edge streams, kernel ``ops/sgns_banded.sgns_banded_multiblock``;
  with ``neg_band=True`` (and Ks % 8 == 0) each micro-step draws its
  negatives from one nb2-row window of the context table instead
  (``BandedTables.build_neg_bands``, window 3280 where it divides the
  band), kernel ``ops/sgns_banded.sgns_banded_multiblock_nb``;
- the other banded routes (``_make_banded_step``: order 1 on 1D band
  tables, order 2 on 2D ones, grouped or not, hoisted or per-step draws,
  update ``ops.update.sgns_shared_negs_step_banded``): fused through kernel
  ``ops/sgns_banded.sgns_banded_fused`` (order 2, group 1, ``use_pallas``
  True, or "auto" on the card with dim % 4 == 0), scatter-only through
  kernel ``ops/scatter.band_scatter_add`` (``use_pallas`` True otherwise, or
  "auto" / "scatter" on the card when the batches tile), else plain;
  with ``band_hold=True`` (order 2, hoist > 1) one stratum is held for the
  whole hoisted block (``_make_banded_block_step``, update
  ``ops.update.sgns_banded_block``), fused, scatter-only or plain alike.
"""

from __future__ import annotations

import torch

from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.models.base import (
    PairModelBase,
    TrainDriver,
    clamp_batch,
    hoisted_scan_step,
    init_embedding,
    zeros_embedding,
)
from smore_tpu_torch.ops.sgns_banded import (
    sgns_banded_multiblock,
    sgns_banded_multiblock_nb,
)
from smore_tpu_torch.ops.update import (
    sgns_banded_block,
    sgns_shared_negs_step,
    sgns_shared_negs_step_banded,
    sgns_step,
    sgns_step_shared,
)
from smore_tpu_torch.sampling.banded import (
    DEFAULT_BAND_SIZE,
    FUSED_BAND_SIZE,
    MULTI_BAND_SIZE,
    BandedTables,
)

# graph size from which LINE takes the banded path by default (the JAX
# package's threshold, set by TPU scatter costs; kept so both packages
# route the same graphs the same way)
BANDED_AUTO_THRESHOLD = 262_144


_INIT, _TRAIN = 0, 1  # generator streams of a model seed


def multiblock_draw(bt: BandedTables, gen: torch.Generator, batch: int,
                    n_negs: int, steps: int):
    """The draws of one multiblock superstep: (sb, db, src_l, pos_l, negs),
    sb/db the band START rows (steps,), src_l/pos_l BAND-LOCAL (steps,
    batch), negs GLOBAL (steps, n_negs). From the edge stream when one is
    built (n_negs 0: no negative draw, negs None), else by per-sample alias
    draws."""
    if bt.stream is not None:
        return bt.draw_banded_stream(gen, batch, n_negs, steps,
                                     with_negs=n_negs > 0)
    sb, db, src, pos, negs = bt.draw_banded_batches_hoisted(
        gen, batch, 1, n_negs, steps)
    return sb, db, src - sb[:, None], pos - db[:, None], negs


def multiblock_apply(state, band_size: int, sb, db, src_l, pos_l, negs,
                     alphas, k_equiv: int) -> torch.Tensor:
    """Apply one superstep to the padded tables ``state["vertex"]`` and
    ``state["context"]`` IN PLACE: snapshot the negatives' context rows,
    run the kernel, then add the deferred negative deltas. Returns the mean
    loss per sample."""
    wv, wc = state["vertex"], state["context"]
    S, B = src_l.shape
    D = wv.shape[1]
    Ks = negs.shape[1]
    flat = negs.reshape(-1).long()
    cn = wc[flat].reshape(S, Ks, D)  # the superstep's snapshot
    wv, wc, d_neg, loss_sum = sgns_banded_multiblock(
        wv, wc, sb // band_size, db // band_size, src_l, pos_l, cn, alphas,
        band_size=band_size, k_equiv=k_equiv,
    )
    wc.index_add_(0, flat, d_neg.reshape(-1, D))
    return loss_sum / (S * B)


class LINE(PairModelBase):
    def __init__(self, graph: Graph, seed: int = 0,
                 device: torch.device | str = "cuda"):
        super().__init__(graph, seed, device)
        self.order = 2
        self.banded_tables: BandedTables | None = None
        self.last_driver: TrainDriver | None = None

    def init(self, dim: int, order: int = 2) -> None:
        self.dim = dim
        self.order = order
        n = self.graph.n_vertices
        vertex = init_embedding(self._generator(_INIT), n, dim,
                                device=self.device)
        if order == 1:
            self.state = {"vertex": vertex}
        else:
            self.state = {"vertex": vertex,
                          "context": zeros_embedding(n, dim, self.device)}

    def _make_step(self, batch: int, negatives: int, collision: str = "sum",
                   shared_negatives: int = 128, group: int = 1,
                   use_pallas: bool = False, hoist: int = 1):
        """The unbanded StepFn.

        shared_negatives > 0: one pool of that many negatives per step,
        shared by the batch (``sgns_shared_negs_step``); 0: strict
        per-sample negatives like the reference. group > 1: each drawn
        source gives ``group`` consecutive context samples. use_pallas: the
        gradients go through kernel K1. hoist > 1 (shared negatives, group
        > 1, the edge table): the draws of ``hoist`` inner batches run as
        one mega-draw, and alpha arrives as a (hoist,) vector."""
        order = self.order

        def update(state, src, pos, negs, alpha, src_group):
            kw = dict(k_equiv=negatives, collision=collision,
                      src_group=src_group, use_pallas=use_pallas)
            if order == 1:
                w, _, loss = sgns_shared_negs_step(
                    state["vertex"], state["vertex"], src, pos, negs, alpha,
                    shared_table=True, **kw)
                return {"vertex": w}, loss
            wv, wc, loss = sgns_shared_negs_step(
                state["vertex"], state["context"], src, pos, negs, alpha,
                **kw)
            return {"vertex": wv, "context": wc}, loss

        if shared_negatives and hoist > 1:
            Ks = shared_negatives
            return hoisted_scan_step(
                lambda tables, gen: tables.draw_edge_batches_hoisted(
                    gen, batch, group, Ks, hoist),
                lambda st, x, a: update(st, *x, a, group), hoist)

        if shared_negatives:
            Ks = shared_negatives

            def step(state, tables, gen, alpha):
                grouped = group > 1 and tables.has_edge_table
                if grouped:
                    x = tables.draw_edge_batch_grouped(gen, batch, group, Ks)
                else:
                    x = tables.draw_edge_batch(gen, batch, Ks)
                return update(state, *x, alpha, group if grouped else 1)

            return step

        def step(state, tables, gen, alpha):
            src = tables.source_sample(gen, (batch,))
            pos = tables.target_sample(gen, src)
            negs = tables.negative_sample(gen, (batch, negatives))
            if order == 1:
                w, loss = sgns_step_shared(state["vertex"], src, pos, negs,
                                           alpha, collision=collision)
                return {"vertex": w}, loss
            wv, wc, loss = sgns_step(state["vertex"], state["context"], src,
                                     pos, negs, alpha, collision=collision)
            return {"vertex": wv, "context": wc}, loss

        return step

    def _make_banded_step(self, batch, negatives, shared_negatives, group,
                          hoist=1, pallas_scatter=False, fused=False):
        """The banded StepFn off the multiblock route: one stratum per
        micro-step, update ``sgns_shared_negs_step_banded`` (order 1 on one
        table with 1D strata, order 2 with the source band too on 2D
        tables). hoist > 1: the draws of ``hoist`` micro-steps run as one
        mega-draw, and alpha arrives as a (hoist,) vector."""
        order = self.order
        Ks = shared_negatives
        band_size = self.banded_tables.band_size
        two_d = self.banded_tables.two_d

        def inner(state, x, alpha):
            sb, db, src, pos, negs = x
            kw = dict(k_equiv=negatives, src_group=group,
                      pallas_scatter=pallas_scatter,
                      fused=fused and order == 2)
            if order == 1:
                w, _, loss = sgns_shared_negs_step_banded(
                    state["vertex"], state["vertex"], db, band_size, src,
                    pos, negs, alpha, shared_table=True, **kw)
                return {"vertex": w}, loss
            wv, wc, loss = sgns_shared_negs_step_banded(
                state["vertex"], state["context"], db, band_size, src, pos,
                negs, alpha, src_band_start=sb if two_d else None, **kw)
            return {"vertex": wv, "context": wc}, loss

        if hoist > 1:
            return hoisted_scan_step(
                lambda bt, gen: bt.draw_banded_batches_hoisted(
                    gen, batch, group, Ks, hoist),
                inner, hoist)

        def step(state, bt, gen, alpha):
            return inner(state, bt.draw_banded_batch(gen, batch, group, Ks),
                         alpha)

        return step

    def _make_banded_multiblock_step(self, batch, negatives,
                                     shared_negatives, hoist):
        """One multiblock superstep: ``hoist`` micro-steps, each on its own
        band pair, through the kernel."""
        band_size = self.banded_tables.band_size

        def step(state, bt, gen, alphas):
            x = multiblock_draw(bt, gen, batch, shared_negatives, hoist)
            loss = multiblock_apply(state, band_size, *x, alphas,
                                    k_equiv=negatives)
            return state, loss

        return step

    def _make_banded_multiblock_nb_step(self, batch, negatives,
                                        shared_negatives, hoist):
        """One multiblock superstep with banded negatives: ``hoist``
        micro-steps, each on its own band pair and with its Ks negatives
        drawn from one window of the context table (``draw_neg_banded``),
        through kernel K5, which updates those rows itself."""
        band_size = self.banded_tables.band_size

        def step(state, bt, gen, alphas):
            sb, db, src_l, pos_l, _ = multiblock_draw(bt, gen, batch, 0,
                                                      hoist)
            nb, negs_l = bt.draw_neg_banded(gen, shared_negatives, hoist)
            _, _, loss_sum = sgns_banded_multiblock_nb(
                state["vertex"], state["context"], sb // band_size,
                db // band_size, nb, src_l, pos_l, negs_l, alphas,
                band_size=band_size, nb2=bt.nb2, k_equiv=negatives)
            return state, loss_sum / (hoist * batch)

        return step

    def _make_banded_block_step(self, batch, negatives, shared_negatives,
                                group, hold, pallas_scatter=False,
                                fused=False):
        """The band-persistent superstep (order 2): one stratum held for
        ``hold`` micro-batches (``draw_banded_block``, the per-sample law
        unchanged), update ``sgns_banded_block``, fused through K3 or
        scatter-only through K2 as on the per-step route."""
        band_size = self.banded_tables.band_size

        def step(state, bt, gen, alphas):
            sb, db, src, pos, negs = bt.draw_banded_block(
                gen, batch, group, shared_negatives, hold)
            wv, wc, loss = sgns_banded_block(
                state["vertex"], state["context"], sb, db, band_size, src,
                pos, negs, alphas, k_equiv=negatives, src_group=group,
                pallas_scatter=pallas_scatter, fused=fused)
            return {"vertex": wv, "context": wc}, loss

        return step

    def train(
        self,
        sample_times: float = 10,
        negative_samples: int = 5,
        alpha: float = 0.025,
        batch: int = 0,
        steps_per_call: int = 128,
        collision: str = "sum",
        shared_negatives: int = 128,
        group: int = 0,
        use_pallas: object = "auto",
        hoist: int = 0,
        banded: object = "auto",
        band_hold: object = "auto",
        band_size: int = 0,
        multiband: object = "auto",
        neg_band: object = "auto",
        edge_stream: object = "auto",
        mesh=None,
        verbose: bool = True,
    ) -> None:
        """The JAX package's ``LINE.train`` arguments and defaults, less
        ``sharding`` (multi-device is not ported; ``mesh`` raises). On the
        unbanded path ``use_pallas=True`` selects kernel K1 ("auto" is off
        there, as in the JAX package); on the banded path off the multiblock
        route it selects the fused kernel K3 where it applies and the
        scatter kernel K2 otherwise ("auto": K3 or K2 on the card when the
        batches tile; "scatter": K2 only)."""
        if mesh is not None:
            raise NotImplementedError(
                "multi-device training (mesh=) is not ported yet "
                "(ROADMAP Queue 1 item 12)")
        total = int(sample_times * 1_000_000)
        n = self.graph.n_vertices
        auto_batch = batch == 0
        if auto_batch:
            batch = 32768
        use_banded = bool(
            shared_negatives
            and collision == "sum"
            and 0 < self.graph.n_edges < (1 << 24)
            and n < (1 << 24)
            and (banded is True
                 or (banded == "auto" and n >= BANDED_AUTO_THRESHOLD))
        )
        if group == 0:
            group = 1 if (use_banded and self.order == 2) else 8
        if group > 1 and batch % group:
            raise ValueError(f"batch {batch} not divisible by group {group}")
        batch = clamp_batch(n, batch, group=group)
        if shared_negatives:
            shared_negatives = min(shared_negatives, batch)
        if (hoist != 1 and not use_banded
                and not self.build_sampler().has_edge_table):
            # the hoisted step needs the joint edge table; without it the
            # per-step path draws in two stages
            hoist = 1
        auto_hoist = hoist == 0
        if auto_hoist:
            if use_banded and shared_negatives:
                hoist = 8
            elif (shared_negatives and group > 1
                  and self.build_sampler().has_edge_table):
                hoist = 32
            else:
                hoist = 1

        if use_banded:
            self._train_banded(total, negative_samples, alpha, batch,
                               auto_batch, steps_per_call, shared_negatives,
                               group, use_pallas, hoist, auto_hoist,
                               band_hold, band_size, multiband, neg_band,
                               edge_stream, verbose)
            return

        self.last_driver = driver = TrainDriver(
            self._make_step(batch, negative_samples, collision,
                            shared_negatives, group, use_pallas is True,
                            hoist),
            ctx=self.build_sampler(),
            samples_per_step=batch * hoist,
            alpha=alpha,
            total_samples=total,
            steps_per_call=max(1, steps_per_call // hoist),
            micro_steps=hoist,
            device=self.device,
        )
        # the tables are updated in place
        self.state = driver.train(self.state, self._generator(_TRAIN),
                                  verbose=verbose)

    def _train_banded(self, total, negative_samples, alpha, batch,
                      auto_batch, steps_per_call, shared_negatives, group,
                      use_pallas, hoist, auto_hoist, band_hold, band_size,
                      multiband, neg_band, edge_stream, verbose) -> None:
        """The banded routes of ``train`` (the JAX package's
        ``line.py:479-677``)."""
        n = self.graph.n_vertices

        # the TPU kernels' tile constraint, kept so both packages route the
        # same shapes the same way: a multiple of 2048, or under 2048 and a
        # multiple of 8 (pos: batch rows, src: batch / group rows)
        def _tiles(b):
            return b % 2048 == 0 or (b < 2048 and b % 8 == 0)

        on_card = self.device.type == "cuda"
        use_multi = (
            self.order == 2
            and group == 1
            and self.dim % 64 == 0
            and (multiband is True or (multiband == "auto" and on_card))
        )
        if use_multi and auto_batch:
            # batch is the per-stratum visit: 2048 at band 16400 is the
            # concentration the quality gate was measured at
            batch = clamp_batch(n, 2048, group=group)
        if use_multi:
            # the TPU kernel's tiling guard
            tb = min(1024, batch)
            if batch % 128 or batch % tb or (tb // 128) not in (1, 8):
                use_multi = False
        fused = (
            not use_multi
            and self.order == 2
            and group == 1
            and _tiles(batch)
            and (use_pallas is True
                 or (use_pallas == "auto" and on_card and self.dim % 4 == 0))
        )
        pallas_scat = not fused and (
            use_pallas is True
            or (use_pallas in ("auto", "scatter") and on_card
                and _tiles(batch) and _tiles(batch // group))
        )
        auto_band = band_size == 0
        band_size = band_size or (MULTI_BAND_SIZE if use_multi
                                  else FUSED_BAND_SIZE if fused
                                  else DEFAULT_BAND_SIZE)
        if use_multi and band_size % 16:
            use_multi = False
        if (fused and auto_batch and auto_band
                and band_size < DEFAULT_BAND_SIZE):
            # the 40M-gate AUC tracks the per-stratum visit size, and 4096
            # is the largest fused batch that held the gate in the JAX
            # package; re-clamped so a small graph is not overshot
            batch = clamp_batch(n, 4096, group=group)

        two_d = self.order == 2
        bt = self.banded_tables
        if bt is None or bt.band_size != band_size or bt.two_d != two_d:
            bt = BandedTables.build(
                self.graph, band_size=band_size, two_d=two_d,
                vertex_method=self.vertex_method, device=self.device,
            )
            self.banded_tables = bt
        if use_multi:
            if auto_hoist or hoist < 2:
                hoist = 16  # micro-steps per superstep
            want_stream = (
                edge_stream is True
                or (isinstance(edge_stream, int) and edge_stream > 1)
                or (edge_stream == "auto" and bt.band_size < (1 << 15))
            )
            if want_stream and bt.stream is None:
                # mult=32 keeps entry reuse ~1x over a 400M-sample run
                mult = (edge_stream if isinstance(edge_stream, int)
                        and edge_stream > 1 else 32)
                bt.build_stream(mult=mult, seed=self.seed)
            if neg_band is True and shared_negatives % 8 == 0:
                if bt.neg_band_pa is None:
                    # 3280-row windows where they divide the band (16400
                    # does: the JAX package's best quality/speed point),
                    # else whole-band windows (small test graphs)
                    bt.build_neg_bands(
                        self.graph, negative_method=self.negative_method,
                        nb2=3280 if band_size % 3280 == 0 else band_size)
                step_fn = self._make_banded_multiblock_nb_step(
                    batch, negative_samples, shared_negatives, hoist)
            else:
                step_fn = self._make_banded_multiblock_step(
                    batch, negative_samples, shared_negatives, hoist)
        elif band_hold is True and self.order == 2 and hoist > 1:
            step_fn = self._make_banded_block_step(
                batch, negative_samples, shared_negatives, group, hoist,
                pallas_scatter=pallas_scat, fused=fused)
        else:
            step_fn = self._make_banded_step(
                batch, negative_samples, shared_negatives, group, hoist,
                pallas_scatter=pallas_scat, fused=fused)

        n_pad = bt.n_rows_padded
        state = {}
        for k, v in self.state.items():
            padded = torch.zeros(n_pad, v.shape[1], dtype=torch.float32,
                                 device=self.device)
            padded[:n] = v
            state[k] = padded
        self.last_driver = driver = TrainDriver(
            step_fn,
            ctx=bt,
            samples_per_step=batch * hoist,
            alpha=alpha,
            total_samples=total,
            steps_per_call=max(1, steps_per_call // hoist),
            micro_steps=hoist,
            device=self.device,
        )
        out = driver.train(state, self._generator(_TRAIN), verbose=verbose)
        self.state = {k: v[:n] for k, v in out.items()}

    def save_weights(self, path: str, table: str = "vertex") -> None:
        super().save_weights(path, table="vertex")
