"""Embedding models: LINE and the walk family (DeepWalk, Walklets,
node2vec, APP). Every model follows the reference protocol
``load_edge_list -> init(dim) -> train(...) -> save_weights(path)``."""

from smore_tpu_torch.models.app import APP
from smore_tpu_torch.models.deepwalk import DeepWalk
from smore_tpu_torch.models.line import LINE
from smore_tpu_torch.models.node2vec import Node2Vec
from smore_tpu_torch.models.walklets import Walklets

__all__ = ["APP", "DeepWalk", "LINE", "Node2Vec", "Walklets"]
