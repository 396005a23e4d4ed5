from repro_torch.train.step import (
    TrainHParams,
    accumulate_grads,
    make_train_step,
)

__all__ = ["TrainHParams", "accumulate_grads", "make_train_step"]
