from repro_torch.train.step import (
    TrainHParams,
    accumulate_grads,
    make_train_step,
    serve_input_specs,
    shard_batch,
    train_input_specs,
)

__all__ = ["TrainHParams", "accumulate_grads", "make_train_step",
           "serve_input_specs", "shard_batch", "train_input_specs"]
