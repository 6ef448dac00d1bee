"""LINE (Large-scale Information Network Embedding), order 2.

Port of ``smore_tpu/models/line.py``. Order 2 keeps a uniform-init vertex
table and a zero-init context table and trains them by SGNS on edge
samples (source by out-degree^0.75, context by edge weight^0.75,
negatives by degree^0.75), with the learning rate decayed linearly to
alpha * 1e-4 over ``sample_times`` million samples.

``train`` keeps the JAX package's routing decisions as they are, with "on
the TPU" read as "on a CUDA device". The route ported so far is the banded
multiblock path, which the JAX package takes above 262,144 vertices on its
accelerator: order 2, group 1, dim % 64 == 0, batch 2048 per stratum visit
at band 16400, 16 micro-steps per superstep, pre-sampled edge streams,
kernel ``ops/sgns_banded.sgns_banded_multiblock``. Every other route
raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import torch

from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.models.base import (
    PairModelBase,
    TrainDriver,
    clamp_batch,
    init_embedding,
    zeros_embedding,
)
from smore_tpu_torch.ops.sgns_banded import sgns_banded_multiblock
from smore_tpu_torch.sampling.banded import (
    DEFAULT_BAND_SIZE,
    MULTI_BAND_SIZE,
    BandedTables,
)

# graph size from which LINE takes the banded path by default (the JAX
# package's threshold, set by TPU scatter costs; kept so both packages
# route the same graphs the same way)
BANDED_AUTO_THRESHOLD = 262_144


_INIT, _TRAIN = 0, 1  # generator streams of a model seed


def _unported(route: str, item: str):
    return NotImplementedError(
        f"LINE route not ported to PyTorch yet: {route} (ROADMAP {item})")


def multiblock_draw(bt: BandedTables, gen: torch.Generator, batch: int,
                    n_negs: int, steps: int):
    """The draws of one multiblock superstep: (sb, db, src_l, pos_l, negs),
    sb/db the band START rows (steps,), src_l/pos_l BAND-LOCAL (steps,
    batch), negs GLOBAL (steps, n_negs). From the edge stream when one is
    built, else by per-sample alias draws."""
    if bt.stream is not None:
        return bt.draw_banded_stream(gen, batch, n_negs, steps)
    sb, db, src, pos, negs = bt.draw_banded_batches_hoisted(
        gen, batch, n_negs, steps)
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
                 device: torch.device | str = "cpu"):
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
        ``sharding`` (multi-device is not ported; ``mesh`` raises).
        ``use_pallas`` selects the fused / scatter-only banded kernels
        there, routes still to be ported."""
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
        if not use_banded:
            raise _unported("the unbanded shared-negative step (kernel K1)",
                            "Queue 1 items 4 and 6")
        if self.order != 2:
            raise _unported("order 1", "Queue 1 item 8")
        if group == 0:
            group = 1
        if group > 1 and batch % group:
            raise ValueError(f"batch {batch} not divisible by group {group}")
        batch = clamp_batch(n, batch, group=group)
        shared_negatives = min(shared_negatives, batch)
        auto_hoist = hoist == 0

        on_card = self.device.type == "cuda"
        use_multi = (
            group == 1
            and self.dim % 64 == 0
            and (multiband is True or (multiband == "auto" and on_card))
        )
        if use_multi and auto_batch:
            # batch is the per-stratum visit: 2048 at band 16400 is the
            # concentration the quality gate was measured at
            batch = clamp_batch(n, 2048, group=group)
        if use_multi:
            # the TPU kernel's tiling guard, kept so both packages route
            # the same shapes the same way
            tb = min(1024, batch)
            if batch % 128 or batch % tb or (tb // 128) not in (1, 8):
                use_multi = False
        band_size = band_size or (MULTI_BAND_SIZE if use_multi
                                  else DEFAULT_BAND_SIZE)
        if use_multi and band_size % 16:
            use_multi = False
        if not use_multi:
            if use_pallas is True or (use_pallas in ("auto", "scatter")
                                      and on_card):
                raise _unported(
                    "the fused or scatter-only banded step (kernels K3, K2)",
                    "Queue 1 item 8, Queue 2")
            if band_hold is True:
                raise _unported("band_hold", "Queue 1 item 14")
            raise _unported("the banded step without multiband",
                            "Queue 1 item 8")
        if neg_band is True and shared_negatives % 8 == 0:
            raise _unported("neg_band (kernel K5)", "Queue 1 item 14")

        bt = self.banded_tables
        if bt is None or bt.band_size != band_size or not bt.two_d:
            bt = BandedTables.build(
                self.graph, band_size=band_size, two_d=True,
                vertex_method=self.vertex_method, device=self.device,
            )
            self.banded_tables = bt
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

        n_pad = bt.n_rows_padded
        state = {}
        for k, v in self.state.items():
            padded = torch.zeros(n_pad, v.shape[1], dtype=torch.float32,
                                 device=self.device)
            padded[:n] = v
            state[k] = padded
        self.last_driver = driver = TrainDriver(
            self._make_banded_multiblock_step(
                batch, negative_samples, shared_negatives, hoist),
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
