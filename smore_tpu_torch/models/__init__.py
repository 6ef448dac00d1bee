"""Embedding models: LINE, the walk family (DeepWalk, Walklets, node2vec,
APP), the rec family (MF, BPR, WARP, Skew-OPT, HPE, PE, HOP-REC, NEMF,
NERANK), the community family (GCN, TEXTGCN, TEXTGCNdev, ECO, FINE,
MSFINE), the knowledge-graph family (TransE, RotatE, ComplEx), the
typed-graph family (SNE, FastRP, CPR, TPR, Metapath2Vec, HAN, CTDNE), JODIE
and the SASRec family (SASRec, GSASRec, RecDenoiser).
The pair models follow the reference protocol ``load_edge_list ->
init(dim) -> train(...) -> save_weights(path)``; the KG models load
triples and save entity and relation files, FastRP ``generate``s, JODIE
loads timestamped interactions and saves user and item files."""

from smore_tpu_torch.models.app import APP
from smore_tpu_torch.models.cpr import CPR, TPR
from smore_tpu_torch.models.cse import NEMF, NERANK
from smore_tpu_torch.models.ctdne import CTDNE
from smore_tpu_torch.models.deepwalk import DeepWalk
from smore_tpu_torch.models.eco import ECO
from smore_tpu_torch.models.fastrp import FastRP
from smore_tpu_torch.models.fine import FINE, MSFINE
from smore_tpu_torch.models.gcn import GCN, TEXTGCN, TEXTGCNdev
from smore_tpu_torch.models.han import HAN
from smore_tpu_torch.models.hoprec import HOPREC
from smore_tpu_torch.models.hpe import HPE, PE
from smore_tpu_torch.models.jodie import JODIE
from smore_tpu_torch.models.kg import ComplEx, RotatE, TransE
from smore_tpu_torch.models.line import LINE
from smore_tpu_torch.models.metapath2vec import Metapath2Vec
from smore_tpu_torch.models.node2vec import Node2Vec
from smore_tpu_torch.models.rec import BPR, MF, WARP, SkewOPT
from smore_tpu_torch.models.sasrec import GSASRec, RecDenoiser, SASRec
from smore_tpu_torch.models.sne import SNE
from smore_tpu_torch.models.walklets import Walklets

__all__ = ["APP", "BPR", "CPR", "CTDNE", "ComplEx", "DeepWalk", "ECO",
           "FINE", "FastRP", "GCN", "GSASRec", "HAN", "HOPREC", "HPE",
           "JODIE", "LINE", "MF", "MSFINE", "Metapath2Vec", "NEMF", "NERANK",
           "Node2Vec", "PE", "RecDenoiser", "RotatE", "SASRec", "SNE",
           "SkewOPT", "TEXTGCN", "TEXTGCNdev", "TPR", "TransE", "WARP",
           "Walklets"]
