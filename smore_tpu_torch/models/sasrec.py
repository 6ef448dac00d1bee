"""SASRec family: self-attentive sequential recommendation.

Port of ``smore_tpu/models/sasrec.py`` (flax and optax there, ``nn.Module``
and ``torch.optim.Adam`` here). Shared architecture: item embedding plus
SINUSOIDAL positions, ``blocks`` pre-LayerNorm causal multi-head attention
blocks with a 4x FFN, residuals and dropout; the sequences are each user's
out-neighbour list in edge order. Variants:

  - gSASRec: gBCE loss, the positive term weighted by beta and the
    negative term by (1 - beta);
  - Rec-Denoiser: per-block trainable (max_len, max_len) attention-mask
    logits, Gumbel-sigmoid sampled in training and multiplied into the
    attention weights after the softmax, with an L1 sparsity penalty.

The whole model trains by autodiff (the JAX package's upgrade over the
reference, which trains only the item table; ``forward_only=True`` keeps
that reference semantics). What is kept exactly from flax: LayerNorm's
eps 1e-6; the two additive -1e9 masks (causal and pad; a left-padded query
row is fully masked and gets near-uniform weights over its causal prefix,
where -inf would give NaN); the attention as explicit einsum and softmax
(Rec-Denoiser's mask and the dropout act on the weights); dropout on the
input, the attention weights, after ``o`` and after the FFN; the init
laws (item rows normal with std 0.5 / dim, lecun-normal kernels, zero
biases, unit LayerNorm scales, mask logits 2.0). Every draw (init,
dropout, Gumbel uniforms, negatives, the epoch permutation) comes from a
generator seeded from ``seed``.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.io.embeddings import save_embeddings
from smore_tpu_torch.models.base import (
    INIT_STREAM,
    TRAIN_STREAM,
    OwnLoop,
    epoch_calls,
    seeded_generator,
)
from smore_tpu_torch.utils.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    save_checkpoint,
)

LN_EPS = 1e-6  # flax's LayerNorm default
MASK_INIT = 2.0  # Rec-Denoiser's mask logits start ~open (sigmoid ~0.88)
# the Gumbel uniforms' range, as the JAX package draws them
U_LO, U_HI = 1e-6, 1.0 - 1e-6
# lecun-normal: a normal truncated at 2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def sinusoidal_positions(max_len: int, dim: int) -> np.ndarray:
    """The reference's table: even dims sin, odd dims cos."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    d = np.arange(dim)[None, :]
    div = np.power(10000.0, (d - (d % 2)) / dim)
    ang = pos / div
    out = np.where(d % 2 == 0, np.sin(ang), np.cos(ang))
    return out.astype(np.float32)


def _dropout(x: torch.Tensor, rate: float, train: bool,
             gen: Optional[torch.Generator]) -> torch.Tensor:
    """flax's Dropout: keep with probability 1 - rate, scaled by 1 / (1 -
    rate); the keep draws from ``gen``."""
    if not train or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _linear(d_in: int, d_out: int, device) -> nn.Linear:
    # no draw from torch's global generator; init_params fills it
    return nn.utils.skip_init(nn.Linear, d_in, d_out, device=device)


class _Block(nn.Module):
    """Pre-LN causal multi-head attention and a 4x FFN, each with a
    residual."""

    def __init__(self, dim: int, heads: int, dropout: float, max_len: int,
                 denoise: bool = False, mask_temp: float = 1.0,
                 device=None):
        super().__init__()
        self.heads = heads
        self.dropout = dropout
        self.denoise = denoise
        self.mask_temp = mask_temp
        self.ln0 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.q, self.k, self.v, self.o = (
            _linear(dim, dim, device) for _ in range(4))
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.ff0 = _linear(dim, 4 * dim, device)
        self.ff1 = _linear(4 * dim, dim, device)
        if denoise:
            self.mask_logits = nn.Parameter(torch.full(
                (max_len, max_len), MASK_INIT, device=device))

    def forward(self, x, pad_mask, train: bool, gen=None, gumbel_u=None):
        B, L, D = x.shape
        H = self.heads
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        h = self.ln0(x)
        q, k, v = (f(h).view(B, L, H, D // H) for f in (self.q, self.k,
                                                         self.v))
        logits = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(D // H)
        logits = logits + torch.where(causal, 0.0, -1e9)
        logits = logits + torch.where(pad_mask[:, None, None, :], 0.0, -1e9)
        w = torch.softmax(logits, dim=-1)
        if self.denoise:
            ml = self.mask_logits[:L, :L]
            if train:
                u = gumbel_u
                if u is None:
                    u = torch.rand((2, L, L), generator=gen,
                                   device=x.device) * (U_HI - U_LO) + U_LO
                g = -torch.log(-torch.log(u))
                mask = torch.sigmoid((ml + g[0] - g[1]) / self.mask_temp)
            else:
                mask = torch.sigmoid(ml / self.mask_temp)
            w = w * mask
        w = _dropout(w, self.dropout, train, gen)
        attn = torch.einsum("bhlm,bmhd->blhd", w, v).reshape(B, L, D)
        x = x + _dropout(self.o(attn), self.dropout, train, gen)
        f = self.ff1(F.relu(self.ff0(self.ln1(x))))
        return x + _dropout(f, self.dropout, train, gen)


class SASRecNet(nn.Module):
    """seq (B, L) int with pad id ``num_items`` -> hidden states (B, L, D)
    after the final LayerNorm, zero at pad positions."""

    def __init__(self, num_items: int, dim: int, max_len: int,
                 blocks: int = 2, heads: int = 1, dropout: float = 0.2,
                 denoise: bool = False, mask_temp: float = 1.0,
                 device=None):
        super().__init__()
        self.num_items = num_items
        self.dropout = dropout
        self.item = nn.utils.skip_init(nn.Embedding, num_items + 1, dim,
                                       device=device)
        self.blocks = nn.ModuleList(
            _Block(dim, heads, dropout, max_len, denoise, mask_temp, device)
            for _ in range(blocks))
        self.final_ln = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.register_buffer("positions", torch.from_numpy(
            sinusoidal_positions(max_len, dim)).to(device), persistent=False)

    def init_params(self, gen: torch.Generator) -> None:
        """flax's init laws: item rows normal with std 0.5 / dim, every
        kernel lecun-normal (fan_in its input width), biases zero."""
        dim = self.item.embedding_dim
        with torch.no_grad():
            self.item.weight.normal_(0.0, 0.5 / dim, generator=gen)
            for blk in self.blocks:
                for lin in (blk.q, blk.k, blk.v, blk.o, blk.ff0, blk.ff1):
                    s = math.sqrt(1.0 / lin.in_features) / _TRUNC_STD
                    nn.init.trunc_normal_(lin.weight, 0.0, s, -2.0 * s,
                                          2.0 * s, generator=gen)
                    lin.bias.zero_()

    def forward(self, seq: torch.Tensor, train: bool,
                gen: Optional[torch.Generator] = None,
                gumbel_u: Optional[List[torch.Tensor]] = None):
        """``gumbel_u``: Rec-Denoiser's (2, L, L) uniforms for each block
        in training, drawn from ``gen`` when not given."""
        pad_mask = seq != self.num_items
        x = self.item(seq) * pad_mask[..., None]
        x = x + self.positions[None, : seq.shape[1]]
        x = _dropout(x, self.dropout, train, gen)
        for b, blk in enumerate(self.blocks):
            x = blk(x, pad_mask, train, gen,
                    None if gumbel_u is None else gumbel_u[b])
        return self.final_ln(x) * pad_mask[..., None]


class SASRec(OwnLoop):
    """loss 'bce' (SASRec) | 'gbce' (gSASRec); denoise (Rec-Denoiser).

    ``device`` holds the network, the sequences and every draw: the CUDA
    card unless the caller asks for another. A call is ``steps_per_call``
    steps (the forward, the backward and the Adam update each; ``OwnLoop``:
    captured once on the card as a CUDA graph and replayed for every later
    call of the ``train()``)."""

    loss = "bce"
    denoise = False
    # the steps of a call (None: an epoch's): one, since a capture costs
    # its call's steps and a step's replay already runs at the card's pace
    # (PERF.md)
    steps_per_call: Optional[int] = 1

    def __init__(self, graph: Graph, seed: int = 0, beta: float = 0.5,
                 lambda_sparsity: float = 0.01, negative_samples: int = 1,
                 sparsity: float = 0.3, device: torch.device | str = "cuda"):
        self.graph = graph
        self.seed = seed
        self.beta = beta
        self.lambda_sparsity = lambda_sparsity
        # per-position negatives, SUMMED like the reference's per-negative
        # update loop
        self.neg_k = max(1, int(negative_samples))
        # the reference stores a target sparsity rate on the denoiser but
        # never consumes it past its banner; kept for surface parity
        self.sparsity = sparsity
        self.device = torch.device(device)
        self.net: Optional[SASRecNet] = None
        self.dim = 0
        self.max_len = 50

    @classmethod
    def load_edge_list(cls, path: str, **kw):
        # user-item interactions; direction matters (user -> item order)
        return cls(Graph.load_edge_list(path, undirected=False), **kw)

    def build_sequences(self) -> np.ndarray:
        """Each vertex's out-neighbour list in edge (file) order is its
        sequence: the last max_len + 1 items, left-padded with the pad id
        n_vertices; vertices with fewer than 2 neighbours are skipped."""
        g = self.graph
        L = self.max_len + 1
        pad = g.n_vertices
        seqs = []
        for u in range(g.n_vertices):
            nb = g.neighbors(u)
            if len(nb) < 2:
                continue
            s = nb[-L:]
            seqs.append(
                np.concatenate(
                    [np.full(L - len(s), pad, dtype=np.int64), s]
                )
            )
        if not seqs:
            raise ValueError("no user has >= 2 interactions")
        return np.stack(seqs).astype(np.int32)

    def init(self, dim: int, max_seq_len: int = 50, num_blocks: int = 2,
             num_heads: int = 1, dropout: float = 0.2) -> None:
        self.dim = dim
        self.max_len = max_seq_len
        self.net = SASRecNet(self.graph.n_vertices, dim, max_seq_len,
                             num_blocks, num_heads, dropout,
                             denoise=self.denoise, device=self.device)
        self.net.init_params(seeded_generator(self.seed, INIT_STREAM,
                                              self.device))

    def loss_fn(self, batch: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                negs: Optional[torch.Tensor] = None,
                gumbel_u: Optional[List[torch.Tensor]] = None):
        """The training loss of a (B, max_len + 1) batch: positions
        predict their next item against K negatives from [0, n) (user
        vertices included), summed; BCE or gBCE; the masked mean over
        max(valid, 1); Rec-Denoiser adds lambda * sum over blocks of
        mean(sigmoid(mask_logits)) over the FULL parameter. ``negs`` (B, L,
        K) and ``gumbel_u`` are drawn from ``gen`` when not given."""
        n = self.graph.n_vertices
        seq, pos = batch[:, :-1], batch[:, 1:]
        h = self.net(seq, train=True, gen=gen, gumbel_u=gumbel_u)
        table = self.net.item.weight  # (n + 1, D)
        valid = (pos != n) & (seq != n)
        if negs is None:
            negs = torch.randint(0, n, pos.shape + (self.neg_k,),
                                 generator=gen, device=batch.device)
        s_pos = (h * table[pos]).sum(-1)
        s_neg = torch.einsum("bld,blkd->blk", h, table[negs])
        neg_ce = -F.logsigmoid(-s_neg).sum(-1)
        if self.loss == "gbce":
            b = self.beta
            ce = -b * F.logsigmoid(s_pos) + (1.0 - b) * neg_ce
        else:
            ce = -F.logsigmoid(s_pos) + neg_ce
        loss = (ce * valid).sum() / torch.clamp(valid.sum(), min=1)
        if self.denoise:
            loss = loss + self.lambda_sparsity * sum(
                torch.sigmoid(blk.mask_logits).abs().mean()
                for blk in self.net.blocks)
        return loss

    def make_optimizer(self, alpha: float,
                       forward_only: bool = False) -> torch.optim.Adam:
        """``optax.adam(alpha)``'s formula; with ``forward_only`` only the
        item table trains (every other parameter is frozen, which leaves
        it exactly as zero gradients through Adam do). On the card the
        update is ``capturable`` (its step counts and bias corrections on
        the card), captured or not, so that a captured run and an eager one
        take the same update."""
        for name, p in self.net.named_parameters():
            p.requires_grad_(not forward_only or name == "item.weight")
        return torch.optim.Adam(
            [p for p in self.net.parameters() if p.requires_grad], lr=alpha,
            betas=(0.9, 0.999), eps=1e-8,
            capturable=self.device.type == "cuda")

    def train(self, epochs: int = 10, batch_size: int = 128,
              alpha: float = 0.001, verbose: bool = True,
              holdout: bool = False, forward_only: bool = False,
              checkpoint: Optional[str] = None, checkpoint_every: int = 1,
              resume: bool = True) -> None:
        """holdout=True withholds each sequence's LAST item from training
        (leave-one-out next-item protocol; ``evaluate_ranking`` after).
        forward_only=True trains only the item table, the reference's
        semantics; the default trains the whole network.

        checkpoint: a directory; the network's and the optimiser's state
        dicts, the generator's state and the epoch counter are saved there
        every ``checkpoint_every`` epochs and after the last; with
        ``resume`` a restart continues the uninterrupted run's steps."""
        seqs = self.build_sequences()
        if holdout:
            self._holdout_seqs = seqs
            pad_col = np.full((len(seqs), 1), self.graph.n_vertices,
                              np.int32)
            seqs = np.concatenate([pad_col, seqs[:, :-1]], axis=1)
        n_seq = len(seqs)
        opt = self.make_optimizer(alpha, forward_only)
        gen = seeded_generator(self.seed, TRAIN_STREAM, self.device)
        start_ep = 0
        if checkpoint and resume and checkpoint_exists(checkpoint):
            loaded, done_ep, extra = load_checkpoint(checkpoint)
            self.net.load_state_dict(loaded["net"])
            opt.load_state_dict(loaded["opt"])
            gen.set_state(extra["gen"])
            start_ep = min(done_ep, epochs)
        bs = min(batch_size, n_seq)
        n_batches = max(1, n_seq // bs)
        dev = self.device
        seqs_d = torch.from_numpy(seqs).long().to(dev)
        # the static buffers of the calls: the epoch's permutation, the
        # position of the next batch in it and the last loss
        perm = torch.empty(n_seq, dtype=torch.int64, device=dev)
        batches = perm[: n_batches * bs].view(n_batches, bs)
        pos = torch.zeros(1, dtype=torch.int64, device=dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)

        def call(first: bool, size: int) -> None:
            """``size`` steps of the epoch from ``pos`` (its start, and a
            new permutation, when ``first``)."""
            if first:
                torch.randperm(n_seq, generator=gen, out=perm)
                pos.zero_()
            for _ in range(size):
                step_loss = self.loss_fn(
                    seqs_d[batches.index_select(0, pos)[0]], gen)
                opt.zero_grad(set_to_none=True)
                step_loss.backward()
                opt.step()
                pos.add_(1)
            loss.copy_(step_loss.detach())

        calls = self._new_calls(gen)
        sizes = epoch_calls(n_batches, self.steps_per_call)
        try:
            for ep in range(start_ep, epochs):
                for i, size in enumerate(sizes):
                    calls(functools.partial(call, i == 0, size),
                          (i == 0, size))
                if verbose:
                    print(f"\tepoch {ep + 1}/{epochs} loss={float(loss):.5f}",
                          end="\r", flush=True)
                if checkpoint and ((ep + 1) % max(1, checkpoint_every) == 0
                                   or ep + 1 == epochs):
                    save_checkpoint(checkpoint,
                                    {"net": self.net.state_dict(),
                                     "opt": opt.state_dict()},
                                    step=ep + 1,
                                    extra={"gen": gen.get_state()})
        finally:
            calls.close()
        if verbose:
            print()

    # -- inference ------------------------------------------------------ #
    def hidden_states(self, seqs: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            return self.net(torch.as_tensor(seqs, dtype=torch.long,
                                            device=self.device), train=False)

    def score_next(self, seqs: np.ndarray) -> torch.Tensor:
        """Scores over all items for each sequence's next step."""
        h = self.hidden_states(seqs)[:, -1]  # (B, D)
        with torch.no_grad():
            return h @ self.net.item.weight[:-1].T  # pad row dropped

    def evaluate_ranking(self, ks=(10,), batch_size: int = 256) -> dict:
        """Leave-one-out next-item ranking (train(holdout=True) first): each
        held-out target is ranked against ALL items, those already in the
        user's input excluded. Returns {"recall@k", "ndcg@k"}."""
        seqs = getattr(self, "_holdout_seqs", None)
        if seqs is None:
            raise ValueError("call train(holdout=True) before "
                             "evaluate_ranking()")
        pad = self.graph.n_vertices
        # seqs is (B, max_len+1) left-padded; dropping the last column
        # yields the (B, max_len) input ending just before the target.
        prefixes = seqs[:, :-1]
        targets = seqs[:, -1]
        hits = {k: 0.0 for k in ks}
        ndcg = {k: 0.0 for k in ks}
        n = 0
        for i in range(0, len(seqs), batch_size):
            pf = prefixes[i:i + batch_size]
            tg = targets[i:i + batch_size]
            scores = self.score_next(pf).cpu().numpy()  # (b, n_items)
            rows = np.repeat(np.arange(len(pf)), pf.shape[1])
            cols = pf.reshape(-1)
            keep = cols < pad
            scores[rows[keep], cols[keep]] = -np.inf
            t_scores = scores[np.arange(len(pf)), tg]
            rank = (scores > t_scores[:, None]).sum(axis=1)  # 0-based
            for k in ks:
                hit = rank < k
                hits[k] += hit.sum()
                ndcg[k] += (hit / np.log2(rank + 2)).sum()
            n += len(pf)
        out = {}
        for k in ks:
            out[f"recall@{k}"] = hits[k] / n
            out[f"ndcg@{k}"] = ndcg[k] / n
        return out

    def save_weights(self, path: str) -> None:
        """The item rows (the pad row dropped) under the graph's names."""
        table = self.net.item.weight.detach()[:-1].cpu().numpy()
        save_embeddings(path, self.graph.names, table)

    # -- weights -------------------------------------------------------- #
    def load_flax_params(self, params: dict) -> None:
        """Fill the network from the JAX package's flax tree (nested dicts
        of numpy arrays, with or without the outer ``params``)."""
        tree = params.get("params", params)

        def put(p, a, transpose=False):
            t = torch.from_numpy(np.array(a, dtype=np.float32))
            with torch.no_grad():
                p.copy_(t.T if transpose else t)

        D = self.dim
        put(self.net.item.weight, tree["item"]["embedding"])
        for b, blk in enumerate(self.net.blocks):
            bt = tree[f"block{b}"]
            for name in ("q", "k", "v"):
                lin = getattr(blk, name)
                put(lin.weight, np.reshape(bt[name]["kernel"], (D, D)), True)
                put(lin.bias, np.reshape(bt[name]["bias"], (D,)))
            put(blk.o.weight, np.reshape(bt["o"]["kernel"], (D, D)), True)
            put(blk.o.bias, bt["o"]["bias"])
            for lin, key in ((blk.ff0, "Dense_0"), (blk.ff1, "Dense_1")):
                put(lin.weight, bt[key]["kernel"], True)
                put(lin.bias, bt[key]["bias"])
            for ln, key in ((blk.ln0, "LayerNorm_0"), (blk.ln1,
                                                        "LayerNorm_1")):
                put(ln.weight, bt[key]["scale"])
                put(ln.bias, bt[key]["bias"])
            if blk.denoise:
                put(blk.mask_logits, bt["mask_logits"])
        put(self.net.final_ln.weight, tree["final_ln"]["scale"])
        put(self.net.final_ln.bias, tree["final_ln"]["bias"])


class GSASRec(SASRec):
    loss = "gbce"


class RecDenoiser(SASRec):
    denoise = True
