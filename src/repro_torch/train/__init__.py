from repro_torch.train.loop import (  # noqa: F401
    TrainReport,
    TrainState,
    init_state,
    make_train_step,
    train,
)
from repro_torch.train.microbatch import (  # noqa: F401
    accumulate_gradients,
    split_microbatches,
)
