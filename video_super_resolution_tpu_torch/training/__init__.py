from video_super_resolution_tpu_torch.training.state import (  # noqa: F401
    TrainState,
    create_train_state,
)
from video_super_resolution_tpu_torch.training.step import (  # noqa: F401
    make_eval_step,
    make_train_step,
)
