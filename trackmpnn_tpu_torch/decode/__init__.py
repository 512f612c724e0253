from trackmpnn_tpu_torch.decode.batch_tracker import BatchedTracker
from trackmpnn_tpu_torch.decode.tracker import Tracker, TrackerConfig

__all__ = ["BatchedTracker", "Tracker", "TrackerConfig"]
