from polyp_tpu_torch.track.tracker import (  # noqa: F401
    JsonlTracker,
    MlflowTracker,
    NullTracker,
    Tracker,
    get_tracker,
)
