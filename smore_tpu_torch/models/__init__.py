"""Embedding models: LINE, the walk family (DeepWalk, Walklets, node2vec,
APP), the rec family (MF, BPR, WARP, Skew-OPT, HPE, PE, HOP-REC, NEMF,
NERANK) and the community family (GCN, TEXTGCN, TEXTGCNdev, ECO, FINE,
MSFINE). Every model follows the reference protocol ``load_edge_list ->
init(dim) -> train(...) -> save_weights(path)``."""

from smore_tpu_torch.models.app import APP
from smore_tpu_torch.models.cse import NEMF, NERANK
from smore_tpu_torch.models.deepwalk import DeepWalk
from smore_tpu_torch.models.eco import ECO
from smore_tpu_torch.models.fine import FINE, MSFINE
from smore_tpu_torch.models.gcn import GCN, TEXTGCN, TEXTGCNdev
from smore_tpu_torch.models.hoprec import HOPREC
from smore_tpu_torch.models.hpe import HPE, PE
from smore_tpu_torch.models.line import LINE
from smore_tpu_torch.models.node2vec import Node2Vec
from smore_tpu_torch.models.rec import BPR, MF, WARP, SkewOPT
from smore_tpu_torch.models.walklets import Walklets

__all__ = ["APP", "BPR", "DeepWalk", "ECO", "FINE", "GCN", "HOPREC", "HPE",
           "LINE", "MF", "MSFINE", "NEMF", "NERANK", "Node2Vec", "PE",
           "SkewOPT", "TEXTGCN", "TEXTGCNdev", "WARP", "Walklets"]
