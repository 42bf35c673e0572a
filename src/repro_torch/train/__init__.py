from .step import (TrainConfig, chunked_softmax_xent, loss_fn, make_train_state,
                   make_train_step)

__all__ = ["TrainConfig", "chunked_softmax_xent", "loss_fn", "make_train_state",
           "make_train_step"]
