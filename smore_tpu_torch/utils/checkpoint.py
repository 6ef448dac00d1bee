"""Checkpoint / resume of the full training state.

Port of ``smore_tpu/utils/checkpoint.py`` (orbax there, ``torch.save`` here).
The reference's only persistence is the final text dump and the warm start
(``io/embeddings.py``); a checkpoint adds what a run needs to continue
after it is killed: the tables, the sample generator's state and the step
counter.

A checkpoint is a directory holding one file, so that a model with several
training phases can give each phase a subdirectory. The file is written
under a temporary name in that directory and renamed over the old one, so
a kill during a write leaves the previous checkpoint whole. Tensors are
stored from the CPU and loaded with ``weights_only=True`` (tensors,
numbers, strings and containers of them; nothing is unpickled).
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

import torch

_FILE = "checkpoint.pt"


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        # a copy of its own: a view would store its whole base tensor
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def save_checkpoint(path: str, state: Dict[str, torch.Tensor], step: int = 0,
                    extra: Optional[dict] = None) -> None:
    """Write ``state`` (name -> tensor), ``step`` and ``extra`` (a dict of
    tensors and plain values) to the checkpoint directory ``path``."""
    payload = {"state": _to_cpu(state), "step": int(step)}
    if extra:
        payload["extra"] = _to_cpu(extra)
    os.makedirs(path, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{_FILE}.", dir=path)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, _FILE))
    except BaseException:
        os.remove(tmp)
        raise


def load_checkpoint(path: str):
    """Returns (state, step, extra), every tensor on the CPU; extra is None
    when none was saved."""
    payload = torch.load(os.path.join(path, _FILE), map_location="cpu",
                         weights_only=True)
    return payload["state"], int(payload.get("step", 0)), payload.get("extra")


def checkpoint_exists(path: str) -> bool:
    """True when the directory ``path`` holds a checkpoint."""
    return os.path.isfile(os.path.join(path, _FILE))
