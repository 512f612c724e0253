from trackmpnn_tpu_torch.eval.detection import compute_map
from trackmpnn_tpu_torch.eval.mot import MOTAccumulator, summarize

__all__ = ["MOTAccumulator", "summarize", "compute_map"]
