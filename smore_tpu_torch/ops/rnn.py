"""Standalone tanh RNN cell, the reference's pkg/rnn.

Port of ``smore_tpu/ops/rnn.py``: (a) forward h' = tanh(Wh h + Wx x + b);
(b) a one-step pseudo-BPTT update toward a target hidden state, the error
(target - h') * (1 - h'^2) outer-producted into Wh, Wx and b (plain SGD
ascent, a batch's outer products summed); (c) a time-delta projection,
forward with input [dt, 0, ...]. Parameters are a dict of tensors
(``Wh`` (H, H), ``Wx`` (H, in), ``b`` (H,)), as in the JAX package; every
function is batched over leading axes and returns new tensors. JODIE
(``models/jodie.py``) is its consumer.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


def init_rnn_cell(gen: torch.Generator, in_dim: int, hidden_dim: int,
                  scale: Optional[float] = None,
                  device: torch.device | str = "cuda") -> Params:
    """Uniform(-scale, scale) weights, zero bias; the default scale is
    1/sqrt(hidden_dim), the reference's."""
    if scale is None:
        scale = 1.0 / math.sqrt(float(hidden_dim))

    def uniform(*shape):
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        return u * (2.0 * scale) - scale

    return {"Wh": uniform(hidden_dim, hidden_dim),
            "Wx": uniform(hidden_dim, in_dim),
            "b": torch.zeros(hidden_dim, dtype=torch.float32, device=device)}


def rnn_forward(params: Params, h: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """h' = tanh(Wh h + Wx x + b); batched over any leading axes."""
    return torch.tanh(h @ params["Wh"].T + x @ params["Wx"].T + params["b"])


def rnn_update(params: Params, h: torch.Tensor, x: torch.Tensor,
               target: torch.Tensor, lr: float) -> Params:
    """One-step pseudo-BPTT toward ``target``: the gradient (target - h')
    * (1 - h'^2), outer-producted into the weights. A batch sums its
    samples' gradients."""
    h, x, target = (torch.atleast_2d(a) for a in (h, x, target))
    pred = rnn_forward(params, h, x)
    g = (target - pred) * (1.0 - pred * pred)  # (B, H)
    return {
        "Wh": params["Wh"] + lr * g.T @ h,
        "Wx": params["Wx"] + lr * g.T @ x,
        "b": params["b"] + lr * g.sum(0),
    }


def rnn_project(params: Params, emb: torch.Tensor, dt) -> torch.Tensor:
    """Project an embedding forward in time: the forward pass with input
    [dt, 0, ...]."""
    in_dim = params["Wx"].shape[1]
    x = torch.zeros(emb.shape[:-1] + (in_dim,), dtype=emb.dtype,
                    device=emb.device)
    if in_dim > 0:
        x[..., 0] = dt
    return rnn_forward(params, emb, x)
