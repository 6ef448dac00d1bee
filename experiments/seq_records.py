"""The JAX package's quality records for the JODIE and SASRec-family gates
of ``chip_smoke.py``.

Trains the JAX package's JODIE (``go_oracle_parity.run_jodie``'s set and
settings, both arms: ``bce_lr`` at its default and at 0.2, scored by
``_jodie_eval`` on the static tables) and SASRec, gSASRec and Rec-Denoiser
(``sasrec_eval``'s Markov set and full-autodiff arm, scored by recall@10 of
the leave-one-out ranking) on the CPU, at dim 64 (``--dim`` another) and
at the smoke's budget (``smore_tpu_torch/utils/seq_data.py`` ``JODIE_RUN``,
``SEQ_INIT``, ``SEQ_TRAIN``), for model seeds 0, 1 and 2, and prints one
JSON line per model: the score of each seed and the record, the lowest of
them.

Run:  JAX_PLATFORMS=cpu python experiments/seq_records.py [--dim 128] \\
          [jodie jodie_bce sasrec gsasrec recdenoiser]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from smore_tpu_torch.utils import seq_data as sd  # noqa: E402

SEEDS = (0, 1, 2)
MODELS = tuple(sd.JODIE_ARMS) + tuple(sd.SEQ_MODELS)


def score(model: str, seed: int, d: str, dim: int = sd.DIM) -> dict:
    """The gate's score of the JAX package's ``model`` at ``seed`` and
    ``dim``, its set written under ``d``: {"score": ..., other
    metrics}."""
    if model in sd.JODIE_ARMS:
        from smore_tpu.graph.bipartite import InteractionGraph
        from smore_tpu.models.jodie import JODIE

        ig = InteractionGraph.load_interactions(
            sd.make_interactions(f"{d}/interactions.txt"))
        m = JODIE(ig, seed=seed)
        m.init(dim=dim)
        m.train(bce_lr=sd.JODIE_ARMS[model], verbose=False, **sd.JODIE_RUN)
        acc = sd.jodie_eval(np.asarray(m.state["user_static"]),
                            np.asarray(m.state["item_static"]),
                            ig.user_ids, ig.item_ids, ig.n_items)
        return {"score": acc}
    import smore_tpu.models as M

    path = f"{d}/seq.txt"
    sd.make_data(path)
    m = getattr(M, sd.SEQ_MODELS[model]).load_edge_list(
        path, seed=seed, negative_samples=sd.SEQ_NEG)
    m.init(dim=dim, **sd.SEQ_INIT)
    m.train(verbose=False, **sd.SEQ_TRAIN)
    r = m.evaluate_ranking(ks=(10,))
    return {"score": float(r["recall@10"]), "ndcg@10": float(r["ndcg@10"])}


def main(argv):
    dim = sd.DIM
    if argv[:1] == ["--dim"]:
        dim, argv = int(argv[1]), argv[2:]
    want = argv or list(MODELS)
    with tempfile.TemporaryDirectory() as d:
        for model in want:
            t0 = time.time()
            runs = [score(model, seed, d, dim) for seed in SEEDS]
            s = [r["score"] for r in runs]
            print(json.dumps({"model": model, "dim": dim,
                              "seeds": list(SEEDS), "scores": s,
                              "record": float(min(s)), "runs": runs,
                              "seconds": round(time.time() - t0, 1)}),
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
