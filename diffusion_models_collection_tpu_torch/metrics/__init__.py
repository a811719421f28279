"""Evaluation metrics of the PyTorch port: FID, Inception Score, KID,
improved precision/recall, LPIPS and multi-scale SWD (counterpart of
`diffusion_models_collection_tpu/metrics/`, same names and `__all__`)."""

from .fid import FIDScore
from .inception import InceptionFeatures, InceptionV3
from .inception_score import InceptionScore
from .kid import KIDScore
from .lpips_score import LPIPSScore, calculate_all_metrics
from .precision_recall import PrecisionRecall
from .swd import SWDScore, compute_swd

__all__ = [
    "FIDScore",
    "InceptionScore",
    "KIDScore",
    "LPIPSScore",
    "PrecisionRecall",
    "SWDScore",
    "compute_swd",
    "calculate_all_metrics",
    "InceptionFeatures",
    "InceptionV3",
]
